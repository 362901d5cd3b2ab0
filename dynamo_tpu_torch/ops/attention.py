"""Paged-KV attention and KV page scatter.

The KV cache is a pool of fixed-size pages: ``[num_blocks, block_size,
num_kv_heads, head_dim]`` per layer. A request owns a *block table*, the list
of physical page ids backing its logical context. Counterpart of the JAX
package's ``ops/attention.py``; the pool is updated in place here (a JAX
array is immutable, a torch tensor is not, and an in-place scatter saves a
pool-sized copy per layer). An int8 pool's per-token quantization
(:func:`quantize_kv`, :func:`dequantize_kv`) is the JAX ``models/llama.py``
pair, kept here so that the model and the int8 decode kernel's plain version
share it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_kv(k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 quantization of fresh K/V ([..., KVH, D] → int8
    values and fp32 scales over the last two axes): the JAX ``quantize_kv``.
    ``scale = max(absmax, 1e-12) / 127``, ``q = clip(round(x / scale), -127,
    127)`` with rounding half to even; the floor keeps all-zero rows
    (padding lanes) exact, 0 / 1e-12 quantizing to 0."""
    kf, vf = k.float(), v.float()
    ks = kf.abs().amax(dim=(-2, -1)).clamp(min=1e-12) / 127.0
    vs = vf.abs().amax(dim=(-2, -1)).clamp(min=1e-12) / 127.0
    kq = torch.round(kf / ks[..., None, None]).clamp(-127, 127).to(torch.int8)
    vq = torch.round(vf / vs[..., None, None]).clamp(-127, 127).to(torch.int8)
    return kq, vq, ks, vs


def dequantize_kv(kq: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values and per-token scales → compute-dtype values (the JAX
    ``dequantize_kv``): the scale multiply runs in fp32, then the product is
    rounded to ``dtype``."""
    return (kq.float() * scale[..., None, None]).to(dtype)


def write_kv_to_pages(
    k_cache: torch.Tensor,  # [num_blocks, block_size, ...]
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, ...]
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B, T] absolute position in sequence; < 0 = padding
    block_tables: torch.Tensor,  # [B, max_blocks] physical page ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into their pages, in place; padding and
    out-of-table positions are dropped (the JAX scatter's ``mode="drop"``).
    Trailing-dim agnostic. Returns the (same) cache tensors.

    Nothing here waits for the card (a boolean index would, to count the
    rows it keeps): a dropped row is redirected to the first kept row with
    that row's own value, or, when no row is kept, to row 0 with the value
    row 0 holds, so the duplicated writes all carry the same bits. Row 0
    may belong to a live sequence (the allocator hands out block 0 first):
    rewriting it is harmless only because the engine writes its pool on one
    stream, in order, so that no other write can land between this read of
    row 0 and its write-back."""
    num_blocks, block_size = k_cache.shape[0], k_cache.shape[1]
    max_blocks = block_tables.shape[1]
    positions = positions.to(torch.int64)
    logical = torch.div(positions, block_size, rounding_mode="floor")
    slot = torch.remainder(positions, block_size)
    phys = torch.gather(
        block_tables.to(torch.int64), 1, logical.clamp(0, max_blocks - 1)
    )
    # index_put_ has no drop mode, and a clamped index would write into a
    # wrong page: redirect the dropped rows instead
    valid = ((positions >= 0) & (logical < max_blocks)).reshape(-1)
    rows = (phys * block_size + slot).reshape(-1)
    # [1], never a 0-dim index (indexing with one reads it on the host)
    first = torch.argmax(valid.to(torch.int32), dim=0, keepdim=True)  # 0: none kept
    kept = valid[first]
    rows = torch.where(valid, rows, torch.where(kept, rows[first], 0))
    flat_k = k_cache.view(num_blocks * block_size, *k_cache.shape[2:])
    flat_v = v_cache.view(num_blocks * block_size, *v_cache.shape[2:])
    for flat, new in ((flat_k, k_new), (flat_v, v_new)):
        new = new.reshape(-1, *new.shape[2:]).to(flat.dtype)
        ones = (1,) * (new.dim() - 1)
        fill = torch.where(kept.reshape((1,) + ones), new[first], flat[:1])
        flat[rows] = torch.where(valid.reshape((-1,) + ones), new, fill)
    return k_cache, v_cache


def gather_pages(
    cache: torch.Tensor,  # [num_blocks, block_size, KVH, D]
    block_tables: torch.Tensor,  # [B, max_blocks]
) -> torch.Tensor:
    """Gather a request's pages into contiguous [B, max_blocks*block_size, KVH, D]."""
    pages = cache[block_tables.to(torch.int64)]  # [B, MB, bs, KVH, D]
    b, mb, bs = pages.shape[0], pages.shape[1], pages.shape[2]
    return pages.reshape(b, mb * bs, *pages.shape[3:])


def paged_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [num_blocks, block_size, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    q_positions: torch.Tensor,  # [B, T] absolute positions of queries; < 0 = padding
    *,
    scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of ``q`` against the paged context (eager reference).

    Query at absolute position p attends to context positions <= p; the new
    K/V must already be in the cache."""
    b, t, h, d = q.shape
    kvh = k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    k = gather_pages(k_cache, block_tables)  # [B, S, KVH, D]
    v = gather_pages(v_cache, block_tables)
    s = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, t, kvh, g, d)
    scores = torch.einsum("btngd,bsnd->bngts", qg.float(), k.float()) * scale
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    kv_pos = torch.arange(s, device=q.device)[None, None, :]
    causal = kv_pos <= q_positions[:, :, None]  # [B, T, S]
    valid_q = (q_positions >= 0)[:, :, None]
    mask = (causal & valid_q)[:, None, None, :, :]  # [B, 1, 1, T, S]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid keys (padding queries) produce NaN: zero them
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bngts,bsnd->btngd", probs.to(v.dtype), v)
    return out.reshape(b, t, h, d).to(q.dtype)
