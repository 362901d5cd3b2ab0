"""Paged flash-decode attention: the CUDA kernels' wrapper and plain versions.

``paged_decode_attention`` keeps the signature and layout of the JAX package's
Pallas kernels (``dynamo_tpu/ops/pallas/paged_attention.py``:
``paged_attention_decode_v4``, ``_v2`` and v1 ``paged_attention_decode``, one
function under three TPU schedules). On a CUDA tensor it launches the
hand-written kernels in ``csrc/paged_attention.cu`` (a split-KV pass, then a
merge) or raises; on a CPU tensor it runs
:func:`paged_decode_attention_plain`, which the tests hold against the JAX
kernels in interpret mode. :func:`paged_decode_split_plain` is the two
kernels' arithmetic in PyTorch, for the tests of the split algebra.

The split count is planned on the host from shapes alone
(:func:`plan_splits`): the wrapper never reads ``lengths``, so it never
waits for the card and a CUDA graph can capture it.

``paged_decode_attention_int8`` is the same attention over an int8 pool
(pages int8, one fp32 scale per token slot, the layout of the JAX
``make_kv_cache(..., quantized=True)``) with the scales folded in: a key's
score is (q · k8) · k_scale · scale, and p · v_scale is what is rounded to
q's dtype for P·V. On a CUDA tensor the int8 split kernel feeds the int8
rows straight into its tensor-core fragments and shares the split kernel's
merge; on a CPU tensor :func:`paged_decode_attention_int8_plain` runs the
same arithmetic. The JAX package has no Pallas kernel for it (its int8
pools decode through XLA's ``dequantize_kv`` dense tier).

``paged_decode_attention_sharded`` is the counterpart of the JAX
``paged_attention_decode_sharded`` (a ``shard_map`` over tp running v2 or
v1 on each rank's head shard): on a tp mesh each rank attends its own
contiguous head shard of q against its own pool, whose kv heads are the
rank's slice of the global ones (``parallel/mesh.py kv_cache_sharding``),
over the same block tables and lengths, with no collective. Per rank it is
the CUDA kernel above, planned for the rank's kv heads;
:func:`paged_decode_attention_sharded_plain` runs the plain version per
rank.

The kernels are built at first use with ``nvcc`` for ``sm_90a``
(``ops/build.py``) and bound with ``ctypes``; they launch on PyTorch's
current stream and never synchronise.
"""

from __future__ import annotations

import collections
import ctypes
from functools import lru_cache
from typing import List, Optional, Sequence, Union

import torch

from .build import KernelLibrary, launch_device

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634
# keys per shared-memory tile of the split kernel (csrc: Geo<T, D>::TK)
TILE_KEYS = {torch.float32: 32, torch.bfloat16: 64}
BLOCKS_PER_SM = 4  # the planner's target of split-kernel blocks per SM
MIN_SPLIT_TILES = 2  # tiles of the longest context per split, at the least
INT8_TILE_KEYS = 64  # keys per tile of the int8 split kernel (csrc: Geo8::TK)

_Launched = ctypes.c_int * 3  # the C entry's report: split, merge launches; splits

# Kernels launched on the card by each wrapper, by __global__ name, as the C
# entry reports them, and the split counts the split kernel ran with
# (splits -> launches). ``paged_decode_attention.launches`` and
# ``paged_decode_attention_int8.launches`` count calls. The int8 wrapper's
# merge launches are counted in its own dict: the merge kernel is shared.
device_launches = {"paged_decode_split_kernel": 0, "paged_decode_merge_kernel": 0}
int8_device_launches = {"paged_decode_int8_split_kernel": 0, "paged_decode_merge_kernel": 0}
splits_launched: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    """Zero the wrappers' call counts and the device launch counts."""
    paged_decode_attention.launches = 0
    paged_decode_attention_int8.launches = 0
    paged_decode_attention_sharded.launches = 0
    for counts in (device_launches, int8_device_launches):
        for name in counts:
            counts[name] = 0
    splits_launched.clear()


def _bind(lib) -> None:
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn = lib.paged_decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + tail
    fn.restype = ctypes.c_int
    fn = lib.paged_decode_attention_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + tail
    fn.restype = ctypes.c_int
    fn = lib.paged_decode_int8_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("paged_attention", _bind)


def _check(q, k_cache, v_cache, block_tables, lengths, k_scale=None, v_scale=None) -> None:
    """Raise on what the kernels do not take; with scales, the int8 layout
    (int8 pages, [N, bs] fp32 scales, q in the compute dtype)."""
    s, h, d = q.shape
    n, bs, kvh, d2 = k_cache.shape
    if d != d2 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"num_heads {h} is not a multiple of num_kv_heads {kvh}")
    scales = ()
    if k_scale is None:
        if (k_cache.dtype not in _DTYPES or q.dtype != k_cache.dtype
                or v_cache.dtype != k_cache.dtype):
            raise ValueError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}: "
                             "the kernel takes one of float32/bfloat16 for all three")
    else:
        if q.dtype not in _DTYPES or k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}: "
                             "the int8 kernel takes int8 pages and a float32/bfloat16 q")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (n, bs):
                raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}: the scales are "
                                 f"float32 [{n}, {bs}], one per token slot")
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if block_tables.shape[0] != s or lengths.shape != (s,):
        raise ValueError("block_tables/lengths do not match the lane count")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), *scales,
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def plan_splits(num_lanes: int, num_heads: int, num_kv_heads: int, max_blocks: int,
                block_size: int, dtype: torch.dtype, num_sms: int) -> int:
    """Splits of each lane's context for the split kernel, from shapes alone.

    The grid has ``num_lanes · num_kv_heads · ceil(G / 16)`` blocks per
    split; the plan aims at ``BLOCKS_PER_SM · num_sms`` blocks in all, and
    never at more splits than the table has pages or than leave each split
    ``MIN_SPLIT_TILES`` tiles of the longest context the table holds.
    Lengths are not an argument: on the card they are split evenly among
    the planned splits, and a split past a lane's length exits at once."""
    groups = -(-(num_heads // num_kv_heads) // 16)
    blocks = max(1, num_lanes * num_kv_heads * groups)
    want = -(-BLOCKS_PER_SM * num_sms // blocks)
    max_tiles = -(-max_blocks * block_size // TILE_KEYS[dtype])
    return max(1, min(want, max_tiles // MIN_SPLIT_TILES, max_blocks))


def plan_splits_int8(num_lanes: int, num_heads: int, num_kv_heads: int, max_blocks: int,
                     block_size: int, resident: int, num_sms: int) -> int:
    """Splits of each lane's context for the int8 split kernel, from shapes
    alone: as many as keep the whole grid within one wave, ``resident``
    blocks on each of ``num_sms`` SMs (the blocks per SM that the kernel's
    registers and shared memory allow, as the runtime reports them), and
    never more than the table has pages or than leave each split
    ``MIN_SPLIT_TILES`` tiles of the longest context the table holds."""
    groups = -(-(num_heads // num_kv_heads) // 16)
    blocks = max(1, num_lanes * num_kv_heads * groups)
    max_tiles = -(-max_blocks * block_size // INT8_TILE_KEYS)
    return max(1, min(resident * num_sms // blocks, max_tiles // MIN_SPLIT_TILES, max_blocks))


@lru_cache(maxsize=None)
def _planned_splits(s: int, h: int, kvh: int, mb: int, bs: int, dtype: torch.dtype,
                    index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan_splits(s, h, kvh, mb, bs, dtype, sms)


@lru_cache(maxsize=None)
def int8_blocks_per_sm(d: int, dtype: torch.dtype, index: int) -> int:
    """The int8 split kernel's resident blocks per SM on device ``index``
    for head_dim ``d`` and compute dtype ``dtype``."""
    lib = LIBRARY.load()
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.paged_decode_int8_blocks_per_sm(d, _DTYPES[dtype], ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"paged_decode_int8_blocks_per_sm(D={d}, {dtype}): cudaError {err}, "
                           f"{out.value} blocks")
    return out.value


@lru_cache(maxsize=None)
def _planned_int8_splits(s: int, h: int, kvh: int, mb: int, bs: int, d: int,
                         dtype: torch.dtype, index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan_splits_int8(s, h, kvh, mb, bs, int8_blocks_per_sm(d, dtype, index), sms)


def paged_decode_attention(
    q: torch.Tensor,  # [S, H, D] one query token per lane
    k_cache: torch.Tensor,  # [N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, MB] int32
    lengths: torch.Tensor,  # [S] int32 context length; 0 = padding lane
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
    num_splits: Optional[int] = None,
):
    """Flash decode over paged KV. Returns [S, H, D] in q's dtype; with
    ``return_stats`` also the softmax row max ``m`` (clamped to >= -1e30)
    and denominator ``l``, [S, H] float32 each, for merging with context
    outside the pool (the engine's decode window). ``num_splits`` forces the
    kernel's split count (``None`` lets :func:`plan_splits` choose it); it
    changes only the order of the sums, and the CPU path ignores it."""
    _check_splits(num_splits)
    dev = q.device
    if dev.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, block_tables, lengths, scale=scale,
            return_stats=return_stats,
        )
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    _check(q, k_cache, v_cache, block_tables, lengths)
    lib = LIBRARY.load()
    return _launch(lib.paged_decode_attention_launch, paged_decode_attention,
                   device_launches, "paged_decode_split_kernel", q,
                   (k_cache.data_ptr(), v_cache.data_ptr()), k_cache.shape, block_tables,
                   lengths, scale, return_stats, num_splits)


def _check_splits(num_splits) -> None:
    if num_splits is not None and (not isinstance(num_splits, int) or num_splits < 1):
        raise ValueError(f"num_splits must be a positive int, got {num_splits!r}")


def _launch(entry, wrapper, counts: dict, split_name: str, q, pages: tuple, page_shape,
            block_tables, lengths, scale, return_stats: bool, num_splits):
    """Allocate the outputs and scratch, launch the split and merge kernels
    through the C ``entry`` (``pages``: the pointers it takes between q and
    the tables) on PyTorch's current stream, and count the launches in
    ``counts`` and on ``wrapper``."""
    dev = q.device
    s, h, d = q.shape
    _, bs, kvh, _ = page_shape
    mb = block_tables.shape[1]
    if scale is None:
        scale = d ** -0.5
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if num_splits is None:
        num_splits = _planned_splits(s, h, kvh, mb, bs, q.dtype, index)
    o = torch.empty_like(q)
    # m, l, then the per-split numerators [S, H, NS, D] and stabilizer, max
    # and l [S, H, NS]: one allocation
    stats = torch.empty((2 + num_splits * (d + 3), s, h), dtype=torch.float32, device=dev)
    m_ptr = stats.data_ptr()
    l_ptr = m_ptr + s * h * 4
    # the raw handle of PyTorch's current stream on q's device (what
    # torch.cuda.current_stream(dev).cuda_stream returns, without building
    # a Stream object once per layer per decode step)
    stream = torch._C._cuda_getCurrentRawStream(index)
    launched = _Launched()
    # the C entry launches on the current device: q's (a tp rank's)
    with launch_device(index):
        err = entry(
            q.data_ptr(), *pages, block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            m_ptr, l_ptr, l_ptr + s * h * 4,
            s, h, kvh, d, bs, mb, num_splits, float(scale), _DTYPES[q.dtype], stream, launched,
        )
    counts[split_name] += launched[0]
    counts["paged_decode_merge_kernel"] += launched[1]
    if launched[0]:
        splits_launched[launched[2]] += 1
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {err} "
                           f"({num_splits} splits)")
    wrapper.launches += 1
    if return_stats:
        return o, stats[0], stats[1]
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


def paged_decode_attention_int8(
    q: torch.Tensor,  # [S, H, D] compute dtype
    k_cache: torch.Tensor,  # [N, bs, KVH, D] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [N, bs] float32, one per token slot
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [S, MB] int32
    lengths: torch.Tensor,  # [S] int32
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
    num_splits: Optional[int] = None,
):
    """:func:`paged_decode_attention` over an int8 pool with the scales
    folded in (the arithmetic of :func:`paged_decode_attention_int8_plain`).
    On a CUDA tensor it launches the int8 split kernel and the merge, with
    the split count of :func:`plan_splits_int8` unless ``num_splits``
    forces one, or raises; on a CPU tensor it runs the plain version."""
    _check_splits(num_splits)
    dev = q.device
    if dev.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_cache, v_cache, k_scale, v_scale, block_tables, lengths, scale=scale,
            return_stats=return_stats,
        )
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8: unsupported device {dev}")
    _check(q, k_cache, v_cache, block_tables, lengths, k_scale, v_scale)
    lib = LIBRARY.load()
    if num_splits is None:
        s, h, d = q.shape
        _, bs, kvh, _ = k_cache.shape
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        num_splits = _planned_int8_splits(s, h, kvh, block_tables.shape[1], bs, d, q.dtype,
                                          index)
    return _launch(lib.paged_decode_attention_int8_launch, paged_decode_attention_int8,
                   int8_device_launches, "paged_decode_int8_split_kernel", q,
                   (k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                    v_scale.data_ptr()), k_cache.shape, block_tables, lengths, scale,
                   return_stats, num_splits)


paged_decode_attention_int8.launches = 0


def paged_decode_attention_int8_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
):
    """The int8 kernel's function in plain PyTorch, with its roundings. The
    int8 values are exact in q's dtype; a key's score is the fp32 sum
    q · k8 times (k_scale · scale); m and the integer stabilizer are taken
    over those scores and l sums the unscaled p; each p times its v_scale
    is rounded to q's dtype and summed against the int8 V values in fp32.
    Slots past a lane's length are never read (their table entries, values
    and scales are masked). With a float64 q every step runs in float64
    and nothing is rounded: the exact function of the int8 pages and
    scales, which the card's checks hold both kernels against. In float32
    it equals ``dequantize_kv`` followed by
    :func:`paged_decode_attention_plain` up to float32 rounding."""
    s, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    mb = block_tables.shape[1]
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    cdt = q.dtype
    wdt = torch.float64 if cdt == torch.float64 else torch.float32
    lengths = lengths.to(torch.int64)
    # table entries past a lane's live pages may be garbage: never index them
    n_pages = (lengths + bs - 1) // bs
    live_block = torch.arange(mb, device=q.device)[None, :] < n_pages[:, None]
    tables = torch.where(live_block, block_tables.to(torch.int64), 0)
    live = torch.arange(mb * bs, device=q.device)[None, :] < lengths[:, None]  # [S, T]
    k = k_cache[tables].reshape(s, mb * bs, kvh, d).to(wdt)
    v = v_cache[tables].reshape(s, mb * bs, kvh, d).to(wdt)
    # dead slots' scales are stale (NaN in the tests): zero them, so no
    # 0 * NaN reaches a sum
    zero = torch.zeros((), dtype=wdt, device=q.device)
    ks = torch.where(live, k_scale[tables].reshape(s, mb * bs).to(wdt), zero)
    vs = torch.where(live, v_scale[tables].reshape(s, mb * bs).to(wdt), zero)
    qg = q.to(wdt).reshape(s, kvh, g, d)
    scores = torch.einsum("sngd,stnd->sngt", qg, k) * (ks * scale)[:, None, None, :]
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1).clamp(min=-1e30)
    st = torch.ceil(m * LOG2E)
    p = torch.exp2(scores * LOG2E - st[..., None])
    l_st = p.sum(dim=-1)
    pw = (p * vs[:, None, None, :]).to(cdt).to(wdt)
    num = torch.einsum("sngt,stnd->sngd", pw, v)
    o = num / torch.where(l_st > 0, l_st, torch.ones_like(l_st))[..., None]
    l = torch.where(l_st > 0, l_st * torch.exp2(st - m * LOG2E), torch.zeros_like(l_st))
    o = o.reshape(s, h, d).to(cdt)
    if return_stats:
        return o, m.reshape(s, h), l.reshape(s, h)
    return o


def paged_decode_split_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    num_splits: int,
    *,
    scale: Optional[float] = None,
    return_stats: bool = False,
    tile_keys: Optional[int] = None,
):
    """The two kernels' arithmetic in plain PyTorch: each lane's live tokens
    cut into ``num_splits`` equal runs of whole tiles (``tile_keys`` keys,
    by default the kernel's tile for the dtype); per run an integer
    stabilizer st_i, max, l and the numerator with p rounded to the cache
    dtype against st_i; then the merge, rescaling run i by 2^(st_i − st_max).
    For the tests: it equals :func:`paged_decode_attention_plain` up to fp32
    round-off, which is the split algebra the kernels rely on."""
    s, h, d = q.shape
    _, bs, kvh, _ = k_cache.shape
    mb = block_tables.shape[1]
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    cdt = k_cache.dtype
    tk = tile_keys or TILE_KEYS.get(cdt, 64)
    lengths = lengths.to(torch.int64).clamp(0, mb * bs)
    n_pages = (lengths + bs - 1) // bs
    live_block = torch.arange(mb, device=q.device)[None, :] < n_pages[:, None]
    tables = torch.where(live_block, block_tables.to(torch.int64), 0)
    k = k_cache[tables].reshape(s, mb * bs, kvh, d).float()
    v = v_cache[tables].reshape(s, mb * bs, kvh, d)
    pos = torch.arange(mb * bs, device=q.device)[None, :]
    live = pos < lengths[:, None]  # [S, T]
    v = torch.where(live[:, :, None, None], v, torch.zeros((), dtype=cdt, device=q.device))
    qg = q.to(cdt).float().reshape(s, kvh, g, d)
    scores = torch.einsum("sngd,stnd->sngt", qg, k) * scale
    # the split of each token: run i covers tiles [i·per, (i+1)·per) of its lane
    per_split = (((lengths + tk - 1) // tk) + num_splits - 1) // num_splits  # [S]
    split_of = pos // (per_split[:, None].clamp(min=1) * tk)  # [S, T]
    sts, mxs, ls, nums = [], [], [], []
    for i in range(num_splits):
        mask = live & (split_of == i)
        sc = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
        mx = sc.amax(dim=-1).clamp(min=-1e30)
        st = torch.ceil(mx * LOG2E)
        p = torch.exp2(sc * LOG2E - st[..., None])
        ls.append(p.sum(dim=-1))
        nums.append(torch.einsum("sngt,stnd->sngd", p.to(cdt).float(), v.float()))
        sts.append(st)
        mxs.append(mx)
    st_all, l_all = torch.stack(sts), torch.stack(ls)
    st_max = st_all.amax(dim=0)
    m = torch.stack(mxs).amax(dim=0)
    a = torch.where(l_all > 0, torch.exp2(st_all - st_max), torch.zeros_like(l_all))
    l_st = (a * l_all).sum(dim=0)
    num = (a[..., None] * torch.stack(nums)).sum(dim=0)
    o = num / torch.where(l_st > 0, l_st, torch.ones_like(l_st))[..., None]
    l = torch.where(l_st > 0, l_st * torch.exp2(st_max - m * LOG2E), torch.zeros_like(l_st))
    o = o.reshape(s, h, d).to(q.dtype)
    if return_stats:
        return o, m.reshape(s, h), l.reshape(s, h)
    return o


# -- tensor parallelism ------------------------------------------------------

def _tp_divisible(mesh, h: int, kvh: int) -> bool:
    """Can the head axes split evenly over the mesh's tp axis? Where they
    cannot, the JAX package falls back to its GSPMD jnp path; the port
    raises (ROADMAP A11)."""
    return h % mesh.tp == 0 and kvh % mesh.tp == 0


def per_rank_attention(fn, q, k_pools: Sequence[torch.Tensor], v_pools: Sequence[torch.Tensor],
             block_tables: torch.Tensor, lengths: torch.Tensor, mesh, return_stats: bool, **kw):
    """The pool attention ``fn`` (a kernel's wrapper, or its plain version)
    on every rank's head shard of ``q`` (a global [S, H, D] tensor, cut
    into contiguous shards of H/tp heads, or a list of them) and that
    rank's pool; tables and lengths replicated. Per-rank outputs (and m,
    l)."""
    tp = mesh.tp
    if len(k_pools) != tp or len(v_pools) != tp:
        raise ValueError(f"{len(k_pools)} k and {len(v_pools)} v pools for {tp} ranks")
    if isinstance(q, torch.Tensor):
        h = q.shape[1]
        kvh = k_pools[0].shape[2] * tp
        if not _tp_divisible(mesh, h, kvh):
            raise ValueError(f"{h} query heads over {kvh} kv heads do not split evenly "
                             f"over tp={tp} (ROADMAP A11)")
        w = h // tp
        qs = [q[:, r * w:(r + 1) * w].contiguous().to(d) for r, d in enumerate(mesh.devices)]
    else:
        qs = list(q)
        if len(qs) != tp:
            raise ValueError(f"{len(qs)} query shards for {tp} ranks")
    if len({x.shape[1] for x in qs}) != 1 or len({k.shape[2] for k in k_pools}) != 1:
        raise ValueError("every rank takes the same number of query and kv heads")
    tables, lens = mesh.replicate(block_tables), mesh.replicate(lengths)
    outs = [fn(qs[r], k_pools[r], v_pools[r], tables[r], lens[r], return_stats=return_stats,
               **kw) for r in range(tp)]
    if return_stats:
        return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]
    return outs


def paged_decode_attention_sharded(
    q: Union[torch.Tensor, Sequence[torch.Tensor]],  # [S, H, D], or per rank [S, H/tp, D]
    k_pools: Sequence[torch.Tensor],  # per rank [N, bs, KVH/tp, D]
    v_pools: Sequence[torch.Tensor],
    block_tables: torch.Tensor,  # [S, MB] int32, replicated
    lengths: torch.Tensor,  # [S] int32, replicated
    *,
    mesh,
    scale: Optional[float] = None,
    return_stats: bool = False,
    num_splits: Optional[int] = None,
) -> Union[List[torch.Tensor], tuple]:
    """Flash decode over a tp-sharded pool: :func:`paged_decode_attention`
    per rank on its head shard, the kernel on CUDA ranks (its split count
    planned for the rank's kv heads unless ``num_splits`` forces one).
    Returns the per-rank outputs [S, H/tp, D] and, with ``return_stats``,
    the per-rank m and l [S, H/tp]: sharded like q's head axis, on each
    rank's device. Heads that do not split over tp raise."""
    out = per_rank_attention(paged_decode_attention, q, k_pools, v_pools, block_tables,
                             lengths, mesh, return_stats, scale=scale, num_splits=num_splits)
    if mesh.devices[0].type == "cuda":
        paged_decode_attention_sharded.launches += 1
    return out


paged_decode_attention_sharded.launches = 0


def paged_decode_attention_sharded_plain(
    q, k_pools, v_pools, block_tables, lengths, *, mesh, scale: Optional[float] = None,
    return_stats: bool = False,
):
    """:func:`paged_decode_attention_sharded` with
    :func:`paged_decode_attention_plain` on every rank."""
    return per_rank_attention(paged_decode_attention_plain, q, k_pools, v_pools, block_tables,
                              lengths, mesh, return_stats, scale=scale)
