"""The dispatch gate's wrapper and plain version.

``dispatch_gate_wait(flags, ticket)`` enqueues, on PyTorch's current stream,
a one-thread kernel (``csrc/dispatch_gate.cu``) that holds the stream until
the host has written ``ticket`` into ``flags[0]`` (modulo 2^32) or until
``timeout_s`` has passed, when it sets ``flags[1]`` to 1 and lets the
stream go. ``flags`` is a pinned host tensor of two int32, read by the card
through its unified address. The engine's device timer
(``engine_torch/device_timer.py``) gates each segment of a sampled dispatch
with it. It replaces no TPU kernel: the JAX engine waits on
``block_until_ready``, which an eager forward cannot use (the timer's note).

On a CPU tensor :func:`dispatch_gate_wait_plain` runs: the host is the
executor there, so nothing runs ahead of it and the gate is a check that
says whether the ticket was released. On a CUDA device the wrapper launches
the kernel or raises. The kernel is built at first use with ``nvcc`` for
``sm_90a`` (``ops/build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.dispatch_gate_wait_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("dispatch_gate", _bind)


def dispatch_gate_wait_plain(flags: torch.Tensor, ticket: int) -> bool:
    """The gate on the host: nothing runs ahead of the host, so there is
    nothing to hold; returns whether the ticket was released (``flags[0]``
    at or past it, modulo 2^32), the kernel's condition for letting the
    stream go."""
    return ((int(flags[0]) - ticket) & 0xFFFFFFFF) < 0x80000000


def _check(flags: torch.Tensor) -> None:
    if flags.dtype != torch.int32 or flags.numel() != 2 or not flags.is_contiguous():
        raise ValueError("dispatch gate flags must be 2 contiguous int32")
    if flags.device.type != "cpu" or not flags.is_pinned():
        raise ValueError("dispatch gate flags must be pinned host memory")


def dispatch_gate_wait(flags: torch.Tensor, ticket: int, device: torch.device,
                       timeout_s: float = 5.0):
    """Hold ``device``'s current stream until ``ticket`` is released (the
    module note). On the CPU: :func:`dispatch_gate_wait_plain`."""
    if device.type != "cuda":
        return dispatch_gate_wait_plain(flags, ticket)
    _check(flags)
    lib = LIBRARY.load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = lib.dispatch_gate_wait_launch(flags.data_ptr(), ticket & 0xFFFFFFFF,
                                        int(timeout_s * 1e9), stream)
    if err != 0:
        raise RuntimeError(f"dispatch_gate_wait launch failed: cudaError {err}")
    dispatch_gate_wait.launches += 1
    return None


dispatch_gate_wait.launches = 0


def reset_launch_counts() -> None:
    dispatch_gate_wait.launches = 0
