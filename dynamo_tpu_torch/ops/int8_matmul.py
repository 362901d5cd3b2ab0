"""Int8-weight x bf16-activation matmul (W8A16): the CUDA kernels' wrapper and plain versions.

:func:`int8_weight_matmul` computes the weight-only int8 product of the JAX
package's ``models/llama.py`` (``matw`` and the int8 branch of ``lm_head``):

    y   = round_to_x_dtype(x @ q.T)        fp32 accumulation
    out = round_to_out_dtype(float(y) * s)

with ``x`` [..., K], ``q`` [N, K] int8 (K contiguous: the port's layout,
the transpose of the JAX ``[in, out]``), ``s`` [N] fp32 and ``out``
[..., N] in x's dtype or fp32. On TPU XLA fuses the int8 convert into the
dot; on the card it is one of the hand-written kernels in
``csrc/int8_matmul.cu`` (built at first use, ``ops/build.py``), chosen by
:func:`plan_int8` from the shapes alone: a ``wgmma`` tile kernel for prefill
chunks and a split-K kernel over a ``cp.async`` ring for decode. On a CUDA
tensor the wrapper launches one of them or raises: a shape it does not tile
raises, it never runs the plain version. On a CPU tensor it runs
:func:`int8_weight_matmul_plain`. :func:`int8_weight_matmul_splitk_plain`
is the split-K kernel's order of sums in PyTorch, for the tests.

:func:`int8_expert_matmul` is the same product over an expert stack (the
MoE layer's ``w_gate``, ``w_up`` and ``w_down``, ``ops/moe.py``): ``x``
[X, C, K] against ``q`` [X, N, K] and ``s`` [X, N], one launch with the
expert axis in the grid, planned from (X, C, N, K): the split-K kernel for
decode, and from ``EXPERT_TILE_MIN_C`` rows per expert on the expert tile
kernel, which takes the weight as ``wgmma``'s register-fed A and tiles the
tokens as narrowly as C allows (``plan=`` can still force the dense tile
kernel). Its plain version is :func:`int8_expert_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import Dict, NamedTuple, Optional

import torch

from .build import KernelLibrary, launch_device

N_TILE = 16  # N must be a multiple of this (one mma's weight rows)
K_TILE = 64  # K per chunk (csrc: kChunk)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the plan (mirrors csrc: kBM and the widths of the tile kernel, GeoB of the
# split-K kernel). The split-K kernel's weight rows per block (4 or 1 row
# groups of 16) and the 64-wide chunks of K in each stage of its ring
SPLITK_ROWS = {64: 4, 16: 8}
SPLITK_MAX_LANES = 64  # 8 lane tiles of 8
# The wgmma tile kernel above SPLITK_MAX_LANES rows of x, where its grid
# keeps at least a quarter of the SMs busy. Up to 64 rows every product
# stays on split-K, the kernel that a decode step runs: the tile kernel's
# tensor-core sums round more often as K grows, which put a speculative
# verify dispatch (8 lanes x 5 positions = 40 rows) 2.020e-2 from the same
# positions decoded one step at a time, against 1.798e-2 with every verify
# product on split-K (PERF.md, ROADMAP C2)
TILE_MIN_M, TILE_MIN_SM_SHARE = SPLITK_MAX_LANES + 1, 0.25
TILE_LANES = 128
TILE_ROWS = (256, 224, 128)  # the tile kernel's widths (wgmma's N), widest first
BLOCKS_PER_SM = 1  # the split-K grid's target: blocks per SM (a split sweep on the card)
MIN_SPLIT_CHUNKS = 4  # 64-wide chunks of K per split, at the least
MAX_SPLITS = 16  # the splits of a tile are one thread block cluster (csrc: kMaxSplits)
RING, MAX_SMEM = 4, 227 * 1024  # the split-K ring's stages; a block's shared memory
# expert stacks (experts > 1): the expert tile kernel from EXPERT_TILE_MIN_C
# rows per expert on, else the split-K kernel. Both forced at mixtral's
# shapes (chip_smoke.py phase 5, PERF.md): split-K is no faster from C = 8
# on (8 experts, 4096->14336 / 14336->4096, graph-replayed: C = 8 0.1655 /
# 0.1665 ms against 0.1653 / 0.1600, C = 12 0.187 / 0.193 against 0.168 /
# 0.162); decode at 8 lanes (C = 4) stays on split-K. Blocks of
# EXPERT_TILE_ROWS weight rows by the narrowest of EXPERT_TILE_TOKENS
# (wgmma's N, csrc: the widths of path 3) that covers C in the fewest tiles
# of at most 256 rows of x: 16-64 for C = slots / 2 at 16-128 slots, 256 for
# prefill chunks (C = 512), 136 for C = 130 in one tile
EXPERT_TILE_MIN_C = 8
EXPERT_TILE_ROWS = 128
EXPERT_TILE_TOKENS = (16, 32, 64, 136, 256)
_PATHS = {"tile": 1, "splitk": 2, "expert_tile": 3}
_KERNELS = {1: "w8a16_tile_kernel", 2: "w8a16_splitk_kernel", 3: "w8f32_kernel",
            4: "w8a16_expert_tile_kernel"}
_Launched = ctypes.c_int * 3  # the C entry's report: kernel, blocks, splits

# Kernels launched on the card by both wrappers, by __global__ name, as the
# C entry reports them. ``int8_weight_matmul.launches`` and
# ``int8_expert_matmul.launches`` count calls.
device_launches: Dict[str, int] = {name: 0 for name in _KERNELS.values()}


class Int8Weight(NamedTuple):
    """A weight-only int8 matrix, or a stack of them: ``q`` [..., out, in]
    int8 (K contiguous) and ``s`` [..., out] fp32, the absmax/127 scale of
    each output channel."""

    q: torch.Tensor
    s: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """What one call launches: ``path`` "tile" (the wgmma kernel with the
    weight as B), "splitk" or "expert_tile" (the wgmma kernel over an
    expert stack with the weight as the register-fed A); each block covers
    ``rows`` weight rows and ``lanes`` rows of x; ``splits`` splits of K (1
    but for "splitk"); ``blocks`` in the grid."""

    path: str
    rows: int
    lanes: int
    splits: int
    blocks: int

    @property
    def kernel(self) -> str:
        """The ``__global__`` kernel this plan launches for bf16 x."""
        return f"w8a16_{self.path}_kernel"


def _splitk_lanes(m: int) -> int:
    """Rows of x per split-K block: lane tiles of 8, 1, 2, 4 or 8 of them."""
    for lanes in (8, 16, 32):
        if m <= lanes:
            return lanes
    return SPLITK_MAX_LANES


def _expert_tile_plan(m: int, n: int, experts: int) -> Int8Plan:
    """The expert tile kernel's blocks: 128 weight rows by the narrowest
    token width that covers ``m`` rows of x in the fewest tiles (C = 512 as
    2 x 256, C = 130 as one tile of 136)."""
    tiles = -(-m // EXPERT_TILE_TOKENS[-1])
    width = next(w for w in EXPERT_TILE_TOKENS if w * tiles >= m)
    return Int8Plan("expert_tile", EXPERT_TILE_ROWS, width, 1,
                    experts * -(-m // width) * -(-n // EXPERT_TILE_ROWS))


def plan_int8(m: int, n: int, k: int, sms: int, path: Optional[str] = None,
              experts: int = 1) -> Int8Plan:
    """The launch for an [m, k] x [n, k] product, or for ``experts`` of them
    in one launch (an expert stack), from shapes alone: every count of
    tiles and blocks below is over all the experts' tiles.

    An expert stack (``experts`` > 1) from ``EXPERT_TILE_MIN_C`` rows per
    expert on takes the expert tile kernel (:func:`_expert_tile_plan`).

    The tile kernel (a prefill chunk) from ``TILE_MIN_M`` = 65 rows of x
    on, where its grid keeps ``TILE_MIN_SM_SHARE`` of the ``sms`` SMs busy:
    output tiles of 128 rows of x by 256, 224 or 128 weight rows, the width
    whose last round of tiles leaves the least idle (the cost of a round
    taken as its width plus 32). Else, the split-K kernel: every product
    of up to 64 rows of x, whatever its shape (decode, a speculative verify
    of lanes x (k + 1) <= 64 rows, and prefill chunks' tails of 17-64
    rows), in tiles of 64 or 16 weight rows and of up to 64 rows of x, and
    as many splits of K's 64-wide chunks as bring the grid to about
    ``BLOCKS_PER_SM`` blocks on each SM without passing it (1 when the
    tiles alone fill them), each split at least ``MIN_SPLIT_CHUNKS`` chunks
    long and at most
    ``MAX_SPLITS`` of them. 64-row blocks share each row of x among more
    weight rows; 16-row blocks are taken where they save enough splits (a
    split sweep on the card). ``path`` forces a kernel."""
    if path not in (None, "tile", "splitk", "expert_tile"):
        raise ValueError(f"unknown int8 path {path!r}")
    if path == "expert_tile" or (path is None and experts > 1 and m >= EXPERT_TILE_MIN_C):
        return _expert_tile_plan(m, n, experts)
    tile = min((Int8Plan("tile", rows, TILE_LANES, 1,
                         experts * -(-m // TILE_LANES) * -(-n // rows))
                for rows in TILE_ROWS), key=lambda p: -(-p.blocks // sms) * (p.rows + 32))
    if path is None:
        wide = m >= TILE_MIN_M and tile.blocks >= TILE_MIN_SM_SHARE * sms
        path = "tile" if wide else "splitk"
    if path == "tile":
        return tile
    lanes = _splitk_lanes(m)
    chunks = k // K_TILE
    plans = {}
    for rows, per_stage in SPLITK_ROWS.items():
        stage = rows * (per_stage * K_TILE + 16) + lanes * (per_stage * K_TILE * 2 + 16)
        if RING * stage > MAX_SMEM:
            continue
        tiles = experts * -(-n // rows) * -(-m // lanes)
        splits = max(1, min(MAX_SPLITS, chunks // MIN_SPLIT_CHUNKS,
                            BLOCKS_PER_SM * sms // tiles))
        plans[rows] = Int8Plan("splitk", rows, lanes, splits, tiles * splits)
    # 16-row blocks read x once per 16 weight rows: taken up to 8 lanes of x
    # when they need fewer splits, else only when they need a quarter of them
    wide, narrow = plans[64], plans.get(16)
    if narrow and (narrow.splits * 4 <= wide.splits
                   or m <= 8 and narrow.splits < wide.splits):
        return narrow
    return wide


@lru_cache(maxsize=None)
def _planned(m: int, n: int, k: int, experts: int, index: int) -> Int8Plan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan_int8(m, n, k, sms, experts=experts)


def _bind(lib) -> None:
    fn = lib.int8_weight_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
    ]
    fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("int8_matmul", _bind)


def reset_launch_counts() -> None:
    """Zero both wrappers' call counts and the device launch counts."""
    int8_weight_matmul.launches = 0
    int8_expert_matmul.launches = 0
    for name in device_launches:
        device_launches[name] = 0


def _check(x, q, s, out_dtype, experts: Optional[int] = None) -> None:
    """What the kernels take: q [N, K] and s [N], or with ``experts`` q
    [X, N, K], s [X, N] and x [X, C, K]."""
    lead = () if experts is None else (experts,)
    if q.dim() != 2 + len(lead) or s.shape != q.shape[:-1] or q.shape[:len(lead)] != lead:
        want = "[N, K] and s [N]" if experts is None else "[X, N, K] and s [X, N]"
        raise ValueError(f"q must be {want}: q {tuple(q.shape)}, s {tuple(s.shape)}")
    n, k = q.shape[-2:]
    if x.shape[-1] != k or (experts is not None and (x.dim() != 3 or x.shape[0] != experts)):
        raise ValueError(f"x {tuple(x.shape)} does not contract with q {tuple(q.shape)}")
    if n % N_TILE or k % K_TILE:
        raise ValueError(f"the int8 kernels take N and K in whole tiles of {N_TILE} and "
                         f"{K_TILE}: N={n}, K={k}")
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


def _launch(wrapper, x, q, s, out, m: int, experts: int, plan: Optional[Int8Plan]) -> None:
    """One launch of the C entry for ``experts`` products of [m, K] x
    [N, K]; counts it on ``wrapper`` and in :data:`device_launches`."""
    lib = LIBRARY.load()
    n, k = q.shape[-2:]
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if plan is None:
        plan = _planned(m, n, k, experts, index)
    launched = _Launched()
    # the C entry's block width: weight rows, or for the expert tile kernel rows of x
    width = plan.lanes if plan.path == "expert_tile" else plan.rows
    # the C entry launches on the current device: x's (a tp rank's)
    with launch_device(index):
        err = lib.int8_weight_matmul_launch(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k, experts,
            _DTYPES[x.dtype], _DTYPES[out.dtype], _PATHS.get(plan.path, 0), plan.splits, width,
            torch._C._cuda_getCurrentRawStream(index), launched,
        )
    if launched[0]:
        device_launches[_KERNELS[launched[0]]] += 1
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: cudaError {err} "
                           f"(X={experts}, M={m}, N={n}, K={k}, {plan})")
    wrapper.launches += 1
    wrapper.last_launch = (_KERNELS[launched[0]], launched[1], launched[2])


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                       out_dtype: Optional[torch.dtype] = None,
                       plan: Optional[Int8Plan] = None) -> torch.Tensor:
    """``round(round(x @ q.T) * s)`` (see the module note), [..., N] in
    ``out_dtype`` (default: x's dtype). ``plan`` forces a launch (the tests
    and the card's sweeps); by default :func:`plan_int8` chooses it. With
    fp32 ``x`` the CUDA-core kernel runs whatever the plan."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, q, s, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: unsupported device {x.device}")
    _check(x, q, s, out_dtype)
    n, k = q.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype, device=x.device)
    if m:
        _launch(int8_weight_matmul, x, q, s, out, m, 1, plan)
    return out


int8_weight_matmul.launches = 0
# (kernel, blocks, splits) of the last launch, as the C entry reported it
int8_weight_matmul.last_launch = None


def int8_weight_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequantize to fp32, an fp32
    product, then the kernel's two roundings."""
    out_dtype = out_dtype or x.dtype
    y = (x.float() @ q.float().T).to(x.dtype)
    return (y.float() * s).to(out_dtype)


def int8_weight_matmul_splitk_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                                    splits: int, *,
                                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The split-K kernel's arithmetic in plain PyTorch: K's 64-wide chunks
    cut into ``splits`` runs as the kernel cuts them (run i takes chunks
    [i·C/splits, (i+1)·C/splits)), an fp32 partial product per run, the
    partials summed in split order, then the two roundings. For the tests:
    it equals :func:`int8_weight_matmul_plain` up to fp32 round-off."""
    out_dtype = out_dtype or x.dtype
    k = q.shape[1]
    chunks = k // K_TILE
    if not 1 <= splits <= chunks or k % K_TILE:
        raise ValueError(f"{splits} splits of K={k} in chunks of {K_TILE}")
    xf, qf = x.float(), q.float()
    y = None
    for i in range(splits):
        a, b = i * chunks // splits * K_TILE, (i + 1) * chunks // splits * K_TILE
        part = xf[..., a:b] @ qf[:, a:b].T
        y = part if y is None else y + part
    return (y.to(x.dtype).float() * s).to(out_dtype)


def int8_expert_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                       out_dtype: Optional[torch.dtype] = None,
                       plan: Optional[Int8Plan] = None) -> torch.Tensor:
    """:func:`int8_weight_matmul` over an expert stack: ``x`` [X, C, K],
    ``q`` [X, N, K] int8, ``s`` [X, N] fp32 -> [X, C, N] in ``out_dtype``
    (default: x's dtype), ``out[e] = round(round(x[e] @ q[e].T) * s[e])``.
    One launch for the whole stack, planned by :func:`plan_int8` from
    (X, C, N, K) unless ``plan`` forces one. On a CPU tensor it runs
    :func:`int8_expert_matmul_plain`; on a CUDA tensor it launches or
    raises."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_expert_matmul_plain(x, q, s, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_expert_matmul: unsupported device {x.device}")
    _check(x, q, s, out_dtype, experts=q.shape[0] if q.dim() == 3 else -1)
    experts, c = x.shape[:2]
    out = torch.empty((experts, c, q.shape[1]), dtype=out_dtype, device=x.device)
    if c:
        _launch(int8_expert_matmul, x, q, s, out, c, experts, plan)
    return out


int8_expert_matmul.launches = 0
int8_expert_matmul.last_launch = None


def int8_expert_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The expert kernel's function in plain PyTorch:
    :func:`int8_weight_matmul_plain` for each expert of the stack."""
    out_dtype = out_dtype or x.dtype
    return torch.stack([int8_weight_matmul_plain(x[e], q[e], s[e], out_dtype=out_dtype)
                        for e in range(q.shape[0])])
