"""Paged flash-decode attention: the CUDA kernel's wrapper, build and plain version.

``paged_decode_attention`` keeps the signature and layout of the JAX package's
Pallas kernels (``dynamo_tpu/ops/pallas/paged_attention.py``:
``paged_attention_decode_v4``, ``_v2`` and v1 ``paged_attention_decode``, one
function under three TPU schedules). On a CUDA tensor it launches the
hand-written kernel in ``csrc/paged_attention.cu`` or raises; on a CPU tensor
it runs :func:`paged_decode_attention_plain`, which the tests hold against the
JAX kernels in interpret mode.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` under the repository root (a name keyed by the
source's hash, so an edited source never loads a stale library) and bound
with ``ctypes``; it launches on PyTorch's current stream and never
synchronises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the paged decode kernel cannot be built")


def build(verbose: bool = False) -> dict:
    """Compile the kernel library (if not built yet) and load it.

    Returns ``{"path", "seconds", "log"}``: the library, the compile time
    (0 when an up-to-date library was found) and ``-Xptxas -v``'s report
    of registers and spills."""
    global _lib
    with _lib_lock:
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src).hexdigest()[:12]
        out = BUILD_DIR / f"libpaged_attention_{tag}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", str(tmp), str(_SRC),
            ]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
            os.replace(tmp, out)
            if verbose:
                print(log)
        seconds = time.perf_counter() - t0
        if _lib is None:
            lib = ctypes.CDLL(str(out))
            fn = lib.paged_decode_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return {"path": str(out), "seconds": seconds, "log": log}


def _check(q, k_cache, v_cache, block_tables, lengths) -> None:
    s, h, d = q.shape
    n, bs, kvh, d2 = k_cache.shape
    if d != d2 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"num_heads {h} is not a multiple of num_kv_heads {kvh}")
    if k_cache.dtype not in _DTYPES or q.dtype != k_cache.dtype or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}: "
                         "the kernel takes one of float32/bfloat16 for all three")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if block_tables.shape[0] != s or lengths.shape != (s,):
        raise ValueError("block_tables/lengths do not match the lane count")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(
    q: torch.Tensor,  # [S, H, D] one query token per lane
    k_cache: torch.Tensor,  # [N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, MB] int32
    lengths: torch.Tensor,  # [S] int32 context length; 0 = padding lane
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
):
    """Flash decode over paged KV. Returns [S, H, D] in q's dtype; with
    ``return_stats`` also the softmax row max ``m`` (clamped to >= -1e30)
    and denominator ``l``, [S, H] float32 each, for merging with context
    outside the pool (the engine's decode window)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, lengths, scale=scale,
            return_stats=return_stats,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, block_tables, lengths)
    if _lib is None:
        build()
    s, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    m = torch.empty((s, h), dtype=torch.float32, device=q.device)
    l = torch.empty((s, h), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib.paged_decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), s, h, kvh, d, bs, block_tables.shape[1],
        float(scale), _DTYPES[k_cache.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    if return_stats:
        return o, m, l
    return o


paged_decode_attention.launches = 0


def paged_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
):
    """The kernel's function in plain PyTorch: gather, mask, softmax, with
    the kernel's casts (q and p through the cache dtype, fp32 sums)."""
    s, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    mb = block_tables.shape[1]
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    cdt = k_cache.dtype
    lengths = lengths.to(torch.int64)
    # table entries past a lane's live pages may be garbage: never index them
    n_pages = (lengths + bs - 1) // bs
    live_block = torch.arange(mb, device=q.device)[None, :] < n_pages[:, None]
    tables = torch.where(live_block, block_tables.to(torch.int64), 0)
    k = k_cache[tables].reshape(s, mb * bs, kvh, d).float()
    v = v_cache[tables].reshape(s, mb * bs, kvh, d)
    live = torch.arange(mb * bs, device=q.device)[None, :] < lengths[:, None]  # [S, T]
    # dead slots hold other data: zero them so no 0 * NaN reaches the sum
    v = torch.where(live[:, :, None, None], v, torch.zeros((), dtype=cdt, device=q.device))
    qg = q.to(cdt).float().reshape(s, kvh, g, d)
    scores = torch.einsum("sngd,stnd->sngt", qg, k) * scale
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1).clamp(min=-1e30)
    # p = 2^(s·log2 e − st) with the integer stabilizer st = ceil(m·log2 e):
    # the kernel rounds p against the same st (its rescales are powers of 2)
    st = torch.ceil(m * LOG2E)
    p = torch.exp2(scores * LOG2E - st[..., None])
    l_st = p.sum(dim=-1)
    pv = torch.einsum("sngt,stnd->sngd", p.to(cdt).float(), v.float())
    o = pv / torch.where(l_st > 0, l_st, torch.ones_like(l_st))[..., None]
    l = torch.where(l_st > 0, l_st * torch.exp2(st - m * LOG2E), torch.zeros_like(l_st))
    o = o.reshape(s, h, d).to(q.dtype)
    if return_stats:
        return o, m.reshape(s, h), l.reshape(s, h)
    return o
