"""Int8-weight x bf16-activation matmul (W8A16): the CUDA kernel's wrapper and plain version.

:func:`int8_weight_matmul` computes the weight-only int8 product of the JAX
package's ``models/llama.py`` (``matw`` and the int8 branch of ``lm_head``):

    y   = round_to_x_dtype(x @ q.T)        fp32 accumulation
    out = round_to_out_dtype(float(y) * s)

with ``x`` [..., K], ``q`` [N, K] int8 (K contiguous: the port's layout,
the transpose of the JAX ``[in, out]``), ``s`` [N] fp32 and ``out``
[..., N] in x's dtype or fp32. On TPU XLA fuses the int8 convert into the
dot; on the card it is the hand-written kernel in ``csrc/int8_matmul.cu``
(built at first use, ``ops/build.py``). On a CUDA tensor the wrapper
launches it or raises: a shape it does not tile raises, it never runs the
plain version. On a CPU tensor it runs :func:`int8_weight_matmul_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import KernelLibrary

N_TILE = 16  # weight rows per block (csrc: kRows)
K_TILE = 64  # K per chunk (csrc: kChunk)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    fn = lib.int8_weight_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("int8_matmul", _bind)


def _check(x, q, s, out_dtype) -> None:
    if q.dim() != 2 or s.shape != (q.shape[0],):
        raise ValueError(f"q must be [N, K] and s [N]: q {tuple(q.shape)}, s {tuple(s.shape)}")
    n, k = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not contract with q {tuple(q.shape)}")
    if n % N_TILE or k % K_TILE:
        raise ValueError(f"int8_weight_matmul tiles N by {N_TILE} and K by {K_TILE}: "
                         f"N={n}, K={k}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"q must be int8 and s float32: {q.dtype}, {s.dtype}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"x {x.dtype} / out {out_dtype}: the kernel takes float32 or bfloat16")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``round(round(x @ q.T) * s)`` (see the module note), [..., N] in
    ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, q, s, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: unsupported device {x.device}")
    _check(x, q, s, out_dtype)
    lib = LIBRARY.load()
    n, k = q.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    err = lib.int8_weight_matmul_launch(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPES[x.dtype], _DTYPES[out_dtype], torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(f"int8_weight_matmul launch failed: cudaError {err} "
                           f"(M={m}, N={n}, K={k})")
    int8_weight_matmul.launches += 1
    return out


int8_weight_matmul.launches = 0


def reset_launch_counts() -> None:
    int8_weight_matmul.launches = 0


def int8_weight_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequantize to fp32, an fp32
    product, then the kernel's two roundings."""
    out_dtype = out_dtype or x.dtype
    y = (x.float() @ q.float().T).to(x.dtype)
    return (y.float() * s).to(out_dtype)
