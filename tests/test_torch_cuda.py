"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``; every test skips on a machine without a CUDA card. This
file imports no JAX, so it runs where the port runs:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops.paged_attention import (
    HEAD_DIMS,
    device_launches,
    paged_decode_attention,
    paged_decode_attention_plain,
    splits_launched,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(S, H, KVH, D, bs, max_len, dtype, seed, device):
    rng = np.random.default_rng(seed)
    mb = -(-max_len // bs)
    lengths = rng.integers(1, max_len + 1, size=S).astype(np.int32)
    lengths[S // 2] = 0
    n_blocks = S * mb + 5
    tables = rng.permutation(n_blocks)[: S * mb].reshape(S, mb).astype(np.int32)
    k = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    v = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    to = lambda a, dt=dtype: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return to(q), to(k), to(v), to(tables, torch.int32), to(lengths, torch.int32)


def _hard_case(H, KVH, D, bs, lengths, dtype, seed, device):
    """Lanes of the given lengths (0-length and multiples of bs included),
    table entries past each lane's live pages out of range, and NaN in the
    dead slots of each lane's last page."""
    rng = np.random.default_rng(seed)
    S = len(lengths)
    mb = max(1, -(-max(lengths) // bs))
    n_blocks = S * mb + 5
    perm = rng.permutation(n_blocks)[: S * mb].reshape(S, mb)
    tables = perm.astype(np.int32)
    k = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    v = rng.standard_normal((n_blocks, bs, KVH, D), dtype=np.float32)
    for s, n in enumerate(lengths):
        n_pages = -(-n // bs)
        tables[s, n_pages:] = 1 << 30
        if n % bs:
            k[perm[s, n_pages - 1], n % bs:] = np.nan
            v[perm[s, n_pages - 1], n % bs:] = np.nan
    q = rng.standard_normal((S, H, D), dtype=np.float32)
    to = lambda a, dt=dtype: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (to(q), to(k), to(v), to(tables, torch.int32),
            to(np.asarray(lengths, np.int32), torch.int32))


def _assert_matches_plain(args, dtype, num_splits=None):
    before = paged_decode_attention.launches
    kernels_before = dict(device_launches)
    splits_before = sum(splits_launched.values())
    o, m, l = paged_decode_attention(*args, return_stats=True, num_splits=num_splits)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    # every call launches the split kernel and the merge, once each
    assert all(device_launches[k] == n + 1 for k, n in kernels_before.items())
    assert sum(splits_launched.values()) == splits_before + 1
    if num_splits is not None:
        assert splits_launched[num_splits] >= 1
    po, pm, pl = paged_decode_attention_plain(*args, return_stats=True)
    assert torch.isfinite(o.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
        torch.testing.assert_close(m, pm, atol=1e-5, rtol=0)
        torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(m, pm, atol=0, rtol=1e-3)
        torch.testing.assert_close(l, pl, atol=0, rtol=1e-3)
    return o, m, l


@pytest.mark.parametrize("S,H,KVH,D,bs,max_len", [
    (8, 32, 8, 128, 16, 512),  # llama3-8b heads
    (32, 32, 8, 128, 16, 128),  # many lanes
    (4, 32, 8, 64, 16, 300),  # llama3.2-1b heads
    (4, 4, 2, 16, 8, 70),  # tiny preset heads
    (2, 20, 2, 256, 16, 64),  # 10 query heads per kv head (two head groups), D=256
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, S, H, KVH, D, bs, max_len, dtype):
    args = _case(S, H, KVH, D, bs, max_len, dtype, 0, cuda)
    _assert_matches_plain(args, dtype)


# a 0-length lane, lengths that are multiples of bs (16), a one-token lane,
# and lanes that end mid-page
HARD_LENGTHS = [0, 48, 1, 300, 160, 17]
LONG_LENGTHS = [0, 2048, 700, 1500, 333, 1024]  # decode's contexts of hundreds of keys


@pytest.mark.parametrize("num_splits", [1, 2, 7, None])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_splits_and_head_dims(cuda, num_splits, D, dtype):
    args = _hard_case(8, 2, D, 16, HARD_LENGTHS, dtype, D, cuda)
    o, m, l = _assert_matches_plain(args, dtype, num_splits=num_splits)
    assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("num_splits", [1, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gqa_groups(cuda, G, num_splits, dtype):
    KVH = 1 if G == 32 else 2  # G = 32 is MQA at 32 heads
    args = _hard_case(G * KVH, KVH, 128, 16, HARD_LENGTHS, dtype, G, cuda)
    _assert_matches_plain(args, dtype, num_splits=num_splits)


def test_kernel_more_splits_than_pages(cuda):
    # 40 splits over lanes of at most 19 pages: most splits are empty
    args = _hard_case(8, 2, 64, 16, HARD_LENGTHS, torch.bfloat16, 3, cuda)
    _assert_matches_plain(args, torch.bfloat16, num_splits=40)


def test_refused_launch_raises(cuda):
    # 70000 splits exceed the grid's z limit (65535): the launch is refused
    args = _hard_case(2, 1, 16, 16, [5], torch.float32, 4, cuda)
    before = paged_decode_attention.launches
    kernels_before = dict(device_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        paged_decode_attention(*args, num_splits=70000)
    assert paged_decode_attention.launches == before
    assert device_launches == kernels_before


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, t, n = _case(2, 4, 2, 16, 8, 16, torch.float32, 1, cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(q.half(), k.half(), v.half(), t, n)
    with pytest.raises(ValueError):
        paged_decode_attention(q, k, v, t.long(), n)
    with pytest.raises(ValueError):
        paged_decode_attention(q, k, v, t, n, num_splits=0)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :, :8].contiguous(), k[..., :8].contiguous(),
                               v[..., :8].contiguous(), t, n)  # D=8 has no kernel


# -- paged_decode_attention_int8 -----------------------------------------------

from dynamo_tpu_torch.ops.attention import dequantize_kv, quantize_kv  # noqa: E402
from dynamo_tpu_torch.ops.paged_attention import (  # noqa: E402
    int8_device_launches,
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
)


def _int8_pool_case(H, KVH, D, bs, lengths, dtype, seed, device):
    """An int8 pool (the per-token quantization of normal K/V) under
    ``_hard_case``'s tables and lengths, q in ``dtype``. The scales of the
    dead slots of each lane's last page are NaN (stale), so a kernel that
    read one would put NaN into its sums."""
    q, k, v, tables, lens = _hard_case(H, KVH, D, bs, lengths, torch.float32, seed, device)
    kq, vq, ks, vs = quantize_kv(torch.nan_to_num(k), torch.nan_to_num(v))
    t = tables.cpu().numpy()
    for s_, n in enumerate(lengths):
        if n % bs:
            page = t[s_, -(-n // bs) - 1]
            ks[page, n % bs:] = float("nan")
            vs[page, n % bs:] = float("nan")
    return q.to(dtype), kq, vq, ks, vs, tables, lens


@pytest.mark.parametrize("num_splits", [1, 3, None])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_kernel_matches_plain(cuda, D, dtype, num_splits):
    args = _int8_pool_case(8, 2, D, 16, HARD_LENGTHS, dtype, 20 + D, cuda)
    before = paged_decode_attention_int8.launches
    kernels_before = dict(int8_device_launches)
    o, m, l = paged_decode_attention_int8(*args, return_stats=True, num_splits=num_splits)
    torch.cuda.synchronize()
    assert paged_decode_attention_int8.launches == before + 1
    assert all(int8_device_launches[k] == n + 1 for k, n in kernels_before.items())
    po, pm, pl = paged_decode_attention_int8_plain(*args, return_stats=True)
    assert torch.isfinite(o.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
        torch.testing.assert_close(m, pm, atol=1e-5, rtol=0)
        torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(m, pm, atol=0, rtol=1e-3)
        torch.testing.assert_close(l, pl, atol=0, rtol=1e-3)
    assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()  # length 0


@pytest.mark.parametrize("num_splits", [1, 2, 7, None])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_kernel_against_fp64_and_the_bf16_kernel_on_dequantized_pages(cuda, D, dtype,
                                                                                num_splits):
    """The kernel folds the scales into the scores and into p: it rounds
    each p · v_scale once where the bf16 kernel on dequantize_kv(pages)
    rounds every k, v and p. Against
    the fp64 evaluation of the same int8 pages and scales, the fp32 kernel
    is within 1e-5 and the bf16 kernel's root-mean-square error is no
    larger than the bf16 kernel's on the dequantized pages, over contexts
    of hundreds of keys. (A lane of a few keys is not the case: there the
    dequantized path rounds each output about once, bf16(v · s) for a
    single key, where folding rounds p · s and then the output.)"""
    q, kq, vq, ks, vs, tables, lens = _int8_pool_case(8, 2, D, 16, LONG_LENGTHS, dtype, D,
                                                      cuda)
    got = paged_decode_attention_int8(q, kq, vq, ks, vs, tables, lens, num_splits=num_splits)
    exact = paged_decode_attention_int8_plain(q.double(), kq, vq, ks, vs, tables, lens)
    torch.cuda.synchronize()
    err = (got.double() - exact).pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got.double(), exact, atol=1e-5, rtol=0)
        return
    want = paged_decode_attention(q, dequantize_kv(kq, ks, dtype), dequantize_kv(vq, vs, dtype),
                                  tables, lens, num_splits=num_splits)
    err_dequantized = (want.double() - exact).pow(2).mean().sqrt().item()
    assert 0 < err <= err_dequantized, (err, err_dequantized)


@pytest.mark.parametrize("bs", [4, 6, 8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kv_kernel_block_sizes(cuda, bs, dtype):
    """Pages of 4-32 slots: 16-byte scale pieces where bs is a multiple of
    4, one 4-byte copy per scale at bs = 6; a warp's 16 keys over several
    pages."""
    args = _int8_pool_case(8, 2, 128, bs, HARD_LENGTHS, dtype, 40 + bs, cuda)
    o, m, l = paged_decode_attention_int8(*args, return_stats=True)
    po, pm, pl = paged_decode_attention_int8_plain(*args, return_stats=True)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
        torch.testing.assert_close(l, pl, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(o.float(), po.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(l, pl, atol=0, rtol=1e-3)
    torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-3)


def test_int8_kv_plan_fills_one_wave_of_the_kernels_residency(cuda):
    from dynamo_tpu_torch.ops.paged_attention import int8_blocks_per_sm, plan_splits_int8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for D in HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert int8_blocks_per_sm(D, dtype, 0) >= 1
    resident = int8_blocks_per_sm(128, torch.bfloat16, 0)
    splits = plan_splits_int8(8, 32, 8, 128, 16, resident, sms)
    assert 8 * 8 * splits <= resident * sms < 8 * 8 * (splits + 1)


def test_int8_kv_kernel_rejects_what_it_does_not_take(cuda):
    q, kq, vq, ks, vs, t, n = _int8_pool_case(4, 2, 16, 8, [5, 9], torch.bfloat16, 1, cuda)
    with pytest.raises(ValueError):  # bf16 pages
        paged_decode_attention_int8(q, kq.bfloat16(), vq.bfloat16(), ks, vs, t, n)
    with pytest.raises(ValueError):  # scales of the wrong shape
        paged_decode_attention_int8(q, kq, vq, ks[:, :4].contiguous(), vs, t, n)
    with pytest.raises(ValueError):  # scales on the CPU
        paged_decode_attention_int8(q, kq, vq, ks.cpu(), vs, t, n)
    with pytest.raises(ValueError):  # fp16 q
        paged_decode_attention_int8(q.half(), kq, vq, ks, vs, t, n)


def test_host_tier_round_trip_is_bit_equal_on_the_card(cuda):
    """Spill two blocks of an int8 pool (gather on the stream, pinned copy,
    event), harvest them into the host pool and inject them into two other
    pages: k, v and both scale tables arrive bit for bit."""
    from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
    from dynamo_tpu_torch.models.llama import init_params

    cfg = LLAMA_PRESETS["tiny"]
    eng = TorchServingEngine(cfg, init_params(cfg, seed=0, device=cuda), EngineConfig(
        max_slots=2, kv_block_size=16, max_model_len=64, num_kv_blocks=8, kv_dtype="int8",
        host_cache_blocks=4), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for name, x in eng.cache.items():
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-127, 128, x.shape, generator=gen, device=cuda))
        else:
            x.copy_(torch.rand(x.shape, generator=gen, device=cuda))
    before = {n: x.clone() for n, x in eng.cache.items()}
    eng._offload_blocks([(101, 2, None), (102, 5, None)])
    for x in eng.cache.values():  # the pages are reused at once
        x[:, [2, 5]] = 0
    eng._harvest_spills(force=True)
    assert len(eng.host_pool) == 2 and not eng._pending_spills
    hits = [eng.host_pool.get(h) for h in (101, 102)]
    names = ("k", "v", "k_scale", "v_scale")
    eng.inject_blocks([6, 1], *(torch.stack([hit[i] for hit in hits], dim=1)
                                for i in range(4)))
    for i, n in enumerate(names):
        assert hits[0][i].device.type == "cpu"
        assert torch.equal(eng.cache[n][:, [6, 1]], before[n][:, [2, 5]]), n


# -- int8_weight_matmul ----------------------------------------------------------

from dynamo_tpu_torch.models.llama import LLAMA_PRESETS, Int8Weight, LlamaParams, lm_head  # noqa: E402
from dynamo_tpu_torch.ops import int8_matmul  # noqa: E402
from dynamo_tpu_torch.ops.build import KernelLibrary  # noqa: E402
from dynamo_tpu_torch.ops.int8_matmul import (  # noqa: E402
    int8_weight_matmul,
    int8_weight_matmul_plain,
    plan_int8,
)


def _int8_shapes():
    """(K, N) of every projection of the llama-family presets, tiny
    included, and their LM heads (E -> V; the tied head is the same [V, E]
    weight)."""
    shapes = set()
    for c in LLAMA_PRESETS.values():
        E, F = c.hidden_size, c.intermediate_size
        shapes |= {(E, c.q_dim), (E, c.kv_dim), (c.q_dim, E), (E, F), (F, E),
                   (E, c.vocab_size)}
    return sorted(shapes)


# one lane to a prefill chunk: the lane tiles' edges (8, 16, 32, 64) and the
# tile kernel's (128 rows of x; M = 1000 ends mid-tile), on either side of
# the planner's choice between the kernels (TILE_MIN_M and the grid's size)
INT8_M = [1, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 128, 256, 1000, 1024]
# (x dtype, out dtype) and the tolerance on max|Δ| / max|ref|: bf16 outputs
# may differ by one bf16 ulp where the two sum in other orders
INT8_DTYPES = [
    (torch.bfloat16, torch.bfloat16, 1e-2),
    (torch.bfloat16, torch.float32, 1e-2),
    (torch.float32, torch.float32, 1e-5),
    (torch.float32, torch.bfloat16, 1e-2),
]
_weights = {}


def _int8_weight(k, n):
    if (k, n) not in _weights:
        gen = torch.Generator(device="cuda").manual_seed(k * 7 + n)
        q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        s = torch.rand(n, generator=gen, device="cuda") * 1e-2 + 1e-4
        _weights.clear()  # keep one weight on the card at a time
        _weights[(k, n)] = (q, s)
    return _weights[(k, n)]


def _check_int8(x, q, s, out_dtype, tol, plan=None):
    """One call against the plain version; the wrapper counts it once, under
    the kernel the C entry reports, which is the plan's (the CUDA-core
    kernel for fp32 x), with the plan's blocks and splits."""
    before = int8_weight_matmul.launches
    kernels_before = dict(int8_matmul.device_launches)
    got = int8_weight_matmul(x, q, s, out_dtype=out_dtype, plan=plan)
    torch.cuda.synchronize()
    assert int8_weight_matmul.launches == before + 1
    n, k = q.shape
    m = x.numel() // k
    if plan is None:
        plan = plan_int8(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    kernel, blocks, splits = int8_weight_matmul.last_launch
    if x.dtype == torch.float32:
        assert kernel == "w8f32_kernel"
    else:
        assert kernel == f"w8a16_{plan.path}_kernel"
        assert (blocks, splits) == (plan.blocks, plan.splits)
    assert {k_: v - kernels_before[k_] for k_, v in int8_matmul.device_launches.items()} == {
        k_: int(k_ == kernel) for k_ in kernels_before}
    assert got.dtype == out_dtype and got.shape == x.shape[:-1] + (q.shape[0],)
    ref = int8_weight_matmul_plain(x, q, s, out_dtype=out_dtype).float()
    assert torch.isfinite(got.float()).all()
    rel = (got.float() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    assert rel <= tol, rel
    return got


@pytest.mark.parametrize("x_dtype,out_dtype,tol", INT8_DTYPES,
                         ids=["bf16-bf16", "bf16-fp32", "fp32-fp32", "fp32-bf16"])
@pytest.mark.parametrize("M", INT8_M)
@pytest.mark.parametrize("K,N", _int8_shapes())
def test_int8_kernel_matches_plain(cuda, K, N, M, x_dtype, out_dtype, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, s = _int8_weight(K, N)
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
    _check_int8(x, q, s, out_dtype, tol)


@pytest.mark.parametrize("path", ["tile", "splitk"])
@pytest.mark.parametrize("M", [1, 8, 63, 64, 65, 128, 1000])
@pytest.mark.parametrize("K,N", [(4096, 14336), (4096, 1024), (14336, 4096), (64, 32)])
def test_int8_both_kernels_at_every_m(cuda, K, N, M, path):
    """Each kernel forced on either side of the planner's choice, bf16 in
    and out."""
    q, s = _int8_weight(K, N)
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    plan = plan_int8(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count,
                     path=path)
    _check_int8(x, q, s, torch.bfloat16, 1e-2, plan=plan)


@pytest.mark.parametrize("rows", [128, 224, 256])
@pytest.mark.parametrize("M,K,N", [(1000, 4096, 1024), (128, 14336, 4096), (200, 64, 32)])
def test_int8_tile_widths(cuda, M, K, N, rows):
    """The tile kernel at each of its widths, the weight's last tile ragged
    (1024 = 4·224 + 128; N = 32 is under every width) and M mid-tile."""
    q, s = _int8_weight(K, N)
    x = torch.randn((M, K), device="cuda").bfloat16()
    plan = plan_int8(M, N, K, 132, path="tile")
    plan = dataclasses.replace(plan, rows=rows, blocks=-(-M // plan.lanes) * -(-N // rows))
    _check_int8(x, q, s, torch.bfloat16, 1e-2, plan=plan)


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("rows", [64, 16])
@pytest.mark.parametrize("splits", [1, 2, 5, 8, 9, 16])
def test_int8_splitk_split_counts_and_block_widths(cuda, splits, rows, M):
    # 5 splits of 64 chunks: uneven runs of 12 and 13 chunks; a tile's splits
    # are one thread block cluster, of a non-portable size above 8, 16 at
    # most; both block widths, with 1 lane tile of 8 and 1 of 32 (M = 17)
    q, s = _int8_weight(4096, 1024)
    x = torch.randn((M, 4096), device="cuda").bfloat16()
    plan = plan_int8(M, 1024, 4096, 132, path="splitk")
    plan = dataclasses.replace(plan, rows=rows, splits=splits,
                               blocks=1024 // rows * -(-M // plan.lanes) * splits)
    _check_int8(x, q, s, torch.bfloat16, 1e-2, plan=plan)


@pytest.mark.parametrize("M", [8, 256, 1024])
@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 4096)])
def test_int8_two_calls_are_bit_equal_and_a_graph_replays_them(cuda, K, N, M):
    """No float atomics: the same inputs give the same bits twice (split-K
    included: 8 and 2 splits at M = 8, 4 lane tiles at M = 256 for N =
    1024), and a call captured in a CUDA graph and replayed gives the eager
    call's bits."""
    q, s = _int8_weight(K, N)
    gen = torch.Generator(device="cuda").manual_seed(K + M)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    a = _check_int8(x, q, s, torch.bfloat16, 1e-2)
    b = int8_weight_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm the allocator on the capture stream
        int8_weight_matmul(x, q, s)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = int8_weight_matmul(x, q, s)
    for _ in range(3):
        c.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, c)


def test_int8_kernel_leading_dims_and_layer_views(cuda):
    # [B, T, K] activations and a layer's view of a stacked [L, N, K] weight
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randint(-127, 128, (3, 1024, 4096), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(3, 1024, generator=gen, device="cuda")
    x = torch.randn((2, 5, 4096), generator=gen, device="cuda").bfloat16()
    _check_int8(x, q[2], s[2], torch.bfloat16, 1e-2)


def test_int8_tied_head(cuda):
    """lm_head of a tied int8 model: the per-row embedding [V, E] through the
    kernel with an fp32 epilogue (llama3.2-1b widths)."""
    c = LLAMA_PRESETS["llama3.2-1b"]
    params = LlamaParams(c, torch.device("cuda"), int8=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        params.embed_q.copy_(torch.randint(-127, 128, params.embed_q.shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
        params.embed_s.copy_(torch.rand(c.vocab_size, generator=gen, device="cuda") * 1e-2)
    h = torch.randn((8, c.hidden_size), generator=gen, device="cuda").bfloat16()
    before = int8_weight_matmul.launches
    got = lm_head(params, c, h)
    torch.cuda.synchronize()
    assert int8_weight_matmul.launches == before + 1 and got.dtype == torch.float32
    w = params.weight("embed")
    assert isinstance(w, Int8Weight)
    ref = int8_weight_matmul_plain(h, w.q, w.s, out_dtype=torch.float32)
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= 1e-2, rel


def test_int8_kernel_refuses_what_it_does_not_take(cuda):
    before = int8_weight_matmul.launches
    x = torch.randn((8, 128), device="cuda").bfloat16()
    s = torch.ones(24, device="cuda")
    with pytest.raises(ValueError, match="tiles"):  # N = 24 is not a multiple of 16
        int8_weight_matmul(x, torch.zeros((24, 128), dtype=torch.int8, device="cuda"), s)
    with pytest.raises(ValueError, match="tiles"):  # K = 96 is not a multiple of 64
        int8_weight_matmul(x[:, :96].contiguous(),
                           torch.zeros((32, 96), dtype=torch.int8, device="cuda"), s[:16].repeat(2))
    with pytest.raises(ValueError, match="contiguous"):
        int8_weight_matmul(x, torch.zeros((128, 32), dtype=torch.int8, device="cuda").T,
                           torch.ones(32, device="cuda"))
    with pytest.raises(ValueError):
        int8_weight_matmul(x.half(), torch.zeros((32, 128), dtype=torch.int8, device="cuda"),
                           torch.ones(32, device="cuda"))
    assert int8_weight_matmul.launches == before


def test_int8_launch_that_does_not_fit_raises(cuda):
    # 16-row blocks with 8 lane tiles need 4 x 75 KB of ring: more shared
    # memory than a block may have, so the C entry refuses the launch
    q, s = _int8_weight(4096, 1024)
    x = torch.randn((64, 4096), device="cuda").bfloat16()
    plan = dataclasses.replace(plan_int8(64, 1024, 4096, 132, path="splitk"), rows=16,
                               splits=1, blocks=64)
    before = int8_weight_matmul.launches
    kernels_before = dict(int8_matmul.device_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        int8_weight_matmul(x, q, s, plan=plan)
    assert int8_weight_matmul.launches == before
    assert int8_matmul.device_launches == kernels_before


def test_int8_build_failure_raises_and_runs_no_plain_version(cuda, tmp_path, monkeypatch):
    broken = tmp_path / "broken.cu"
    broken.write_text('extern "C" int int8_weight_matmul_launch( { not C++ }\n')
    monkeypatch.setattr(int8_matmul, "LIBRARY",
                        KernelLibrary("int8_matmul_broken", int8_matmul._bind, source=broken))
    before = int8_weight_matmul.launches
    x = torch.randn((8, 128), device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        int8_weight_matmul(x, torch.zeros((32, 128), dtype=torch.int8, device="cuda"),
                           torch.ones(32, device="cuda"))
    assert int8_weight_matmul.launches == before


# -- the expert-batched int8 kernel ---------------------------------------------

from dynamo_tpu_torch.ops.int8_matmul import (  # noqa: E402
    int8_expert_matmul,
    int8_expert_matmul_plain,
)

EXPERTS = 8
# rows per expert: decode (C = 4 at 8 lanes), odd counts that end mid lane
# tile and mid tile (5, 17, 130), a 1024-row prefill chunk's 512
EXPERT_C = [1, 2, 4, 5, 17, 130, 512]
# (K, N): mixtral-8x7b's w_gate/w_up and w_down, and the tiny-moe widths
EXPERT_SHAPES = [(4096, 14336), (14336, 4096), (64, 128), (128, 64)]


def _expert_stack(k, n, seed):
    """Experts of different contents: expert e's weights are drawn apart and
    scaled by e + 1, so that an expert offset gone wrong shows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randint(-127, 128, (EXPERTS, n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = (torch.rand((EXPERTS, n), generator=gen, device="cuda") * 1e-2 + 1e-4) \
        * torch.arange(1, EXPERTS + 1, device="cuda")[:, None]
    return q, s


def _check_experts(x, q, s, out_dtype, tol, plan=None):
    """One expert call against the plain version, counted once under the
    kernel of its plan (planned from X, C, N, K)."""
    before, dense_before = int8_expert_matmul.launches, int8_weight_matmul.launches
    kernels_before = dict(int8_matmul.device_launches)
    got = int8_expert_matmul(x, q, s, out_dtype=out_dtype, plan=plan)
    torch.cuda.synchronize()
    assert int8_expert_matmul.launches == before + 1
    assert int8_weight_matmul.launches == dense_before
    X, C, K = x.shape
    N = q.shape[1]
    if plan is None:
        plan = plan_int8(C, N, K, torch.cuda.get_device_properties(0).multi_processor_count,
                         experts=X)
    kernel, blocks, splits = int8_expert_matmul.last_launch
    if x.dtype == torch.float32:
        assert kernel == "w8f32_kernel"
    else:
        assert kernel == f"w8a16_{plan.path}_kernel"
        assert (blocks, splits) == (plan.blocks, plan.splits)
    assert {k_: v - kernels_before[k_] for k_, v in int8_matmul.device_launches.items()} == {
        k_: int(k_ == kernel) for k_ in kernels_before}
    assert got.dtype == out_dtype and got.shape == (X, C, N)
    ref = int8_expert_matmul_plain(x, q, s, out_dtype=out_dtype).float()
    assert torch.isfinite(got.float()).all()
    for e in range(X):  # each expert against its own plain product
        rel = (got[e].float() - ref[e]).abs().max().item() / max(ref[e].abs().max().item(), 1e-30)
        assert rel <= tol, (e, rel)
    return got


# each expert's max|Δ| / max|ref| (a stricter measure than over the whole
# stack): bf16 outputs round twice, the product and the scaled output, and
# each rounding may leave one bf16 ulp of an element, up to 2^-7 of the
# expert's max; fp32 activations differ only in the order of fp32 sums
EXPERT_BF16_TOL = 2.0 ** -6


@pytest.mark.parametrize("x_dtype,out_dtype,tol", [
    (torch.bfloat16, torch.bfloat16, EXPERT_BF16_TOL), (torch.float32, torch.float32, 1e-5),
], ids=["bf16-bf16", "fp32-fp32"])
@pytest.mark.parametrize("C", EXPERT_C)
@pytest.mark.parametrize("K,N", EXPERT_SHAPES)
def test_int8_expert_kernel_matches_plain(cuda, K, N, C, x_dtype, out_dtype, tol):
    q, s = _expert_stack(K, N, K + N)
    gen = torch.Generator(device="cuda").manual_seed(C)
    x = torch.randn((EXPERTS, C, K), generator=gen, device="cuda").to(x_dtype)
    _check_experts(x, q, s, out_dtype, tol)


@pytest.mark.parametrize("path", ["tile", "splitk", "expert_tile"])
@pytest.mark.parametrize("C", [2, 5, 130, 512])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (64, 128)])
def test_int8_expert_both_kernels(cuda, K, N, C, path):
    """Each kernel forced at every C, whichever the planner takes."""
    q, s = _expert_stack(K, N, 3 * K + N)
    x = torch.randn((EXPERTS, C, K), device="cuda").bfloat16()
    plan = plan_int8(C, N, K, torch.cuda.get_device_properties(0).multi_processor_count,
                     path=path, experts=EXPERTS)
    _check_experts(x, q, s, torch.bfloat16, EXPERT_BF16_TOL, plan=plan)


@pytest.mark.parametrize("path", ["tile", "splitk", "expert_tile", None])
@pytest.mark.parametrize("C", [1, 5, 130])
def test_int8_expert_kernel_writes_nothing_past_its_rows(cuda, C, path):
    """The launch into a view of a larger buffer of NaN: the X·C·N outputs
    are written and agree with the plain version, and the tail stays NaN
    (a store past C of the last expert would land there; one past C of
    another expert lands in the next expert's rows, which the plain check
    catches)."""
    K, N = 128, 64
    q, s = _expert_stack(K, N, 5)
    x = torch.randn((EXPERTS, C, K), device="cuda").bfloat16()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan_int8(C, N, K, sms, path=path, experts=EXPERTS)
    tail = 4096
    big = torch.full((EXPERTS * C * N + tail,), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    out = big[: EXPERTS * C * N].view(EXPERTS, C, N)
    int8_matmul._launch(int8_expert_matmul, x, q, s, out, C, EXPERTS, plan)
    torch.cuda.synchronize()
    assert torch.isnan(big[EXPERTS * C * N:]).all()
    ref = int8_expert_matmul_plain(x, q, s).float()
    assert torch.isfinite(out.float()).all()
    rel = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= EXPERT_BF16_TOL, rel


@pytest.mark.parametrize("C", [4, 130, 512])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_int8_expert_two_calls_are_bit_equal_and_a_graph_replays_them(cuda, K, N, C):
    q, s = _expert_stack(K, N, 7)
    gen = torch.Generator(device="cuda").manual_seed(K + C)
    x = torch.randn((EXPERTS, C, K), generator=gen, device="cuda").bfloat16()
    a = _check_experts(x, q, s, torch.bfloat16, EXPERT_BF16_TOL)
    b = int8_expert_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        int8_expert_matmul(x, q, s)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = int8_expert_matmul(x, q, s)
    for _ in range(3):
        c.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, c)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("C", [1, 5, 17, 130, 512])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_int8_expert_tile_kernel(cuda, K, N, C, out_dtype):
    """The expert tile kernel forced at every C of mixtral's two shapes,
    into a view of a NaN-filled buffer larger than the stack: each expert
    agrees with its plain product, nothing lands past the stack (a store
    past C or N inside it lands on another output, which the plain check
    catches), and a second call and a CUDA-graph replay give the same bits."""
    q, s = _expert_stack(K, N, 11 * K + N + C)
    gen = torch.Generator(device="cuda").manual_seed(C + 3)
    x = torch.randn((EXPERTS, C, K), generator=gen, device="cuda").bfloat16()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan_int8(C, N, K, sms, path="expert_tile", experts=EXPERTS)
    assert plan.lanes >= min(C, 256) and plan.lanes in int8_matmul.EXPERT_TILE_TOKENS
    size, tail = EXPERTS * C * N, 8192
    big = torch.full((size + tail,), float("nan"), device="cuda", dtype=out_dtype)
    out = big[:size].view(EXPERTS, C, N)
    int8_matmul._launch(int8_expert_matmul, x, q, s, out, C, EXPERTS, plan)
    torch.cuda.synchronize()
    assert int8_expert_matmul.last_launch == ("w8a16_expert_tile_kernel", plan.blocks, 1)
    assert torch.isnan(big[size:]).all()
    assert torch.isfinite(out.float()).all()
    ref = int8_expert_matmul_plain(x, q, s, out_dtype=out_dtype).float()
    for e in range(EXPERTS):
        rel = (out[e].float() - ref[e]).abs().max().item() / ref[e].abs().max().item()
        assert rel <= EXPERT_BF16_TOL, (e, rel)
    again = int8_expert_matmul(x, q, s, out_dtype=out_dtype, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(again, out)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        int8_expert_matmul(x, q, s, out_dtype=out_dtype, plan=plan)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = int8_expert_matmul(x, q, s, out_dtype=out_dtype, plan=plan)
    replayed.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, out)


def test_int8_expert_kernel_layer_views_and_refusals(cuda):
    """A layer's view of a stacked [L, X, N, K] weight; shapes the kernel
    does not take raise before any launch."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randint(-127, 128, (2, EXPERTS, 128, 64), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((2, EXPERTS, 128), generator=gen, device="cuda")
    x = torch.randn((EXPERTS, 3, 64), generator=gen, device="cuda").bfloat16()
    _check_experts(x, q[1], s[1], torch.bfloat16, EXPERT_BF16_TOL)
    before = int8_expert_matmul.launches
    with pytest.raises(ValueError, match="contract"):  # 4 experts of x, 8 of q
        int8_expert_matmul(x[:4].contiguous(), q[1], s[1])
    with pytest.raises(ValueError, match=r"\[X, N, K\]"):
        int8_expert_matmul(x, q[1, 0], s[1, 0])
    with pytest.raises(ValueError, match="tiles"):
        int8_expert_matmul(x[..., :32].contiguous(), q[1, :, :, :32].contiguous(), s[1])
    assert int8_expert_matmul.launches == before


# -- the integrity plane and speculative verify on the card ------------------------


def _tiny_engine(cuda, **kw):
    from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
    from dynamo_tpu_torch.models.llama import init_params

    cfg = LLAMA_PRESETS["tiny"]
    ecfg = dict(max_slots=2, kv_block_size=16, max_model_len=128, prefill_chunk=32,
                decode_steps=2)
    ecfg.update(kw)
    return TorchServingEngine(cfg, init_params(cfg, seed=0, device=cuda), EngineConfig(**ecfg),
                              device=cuda)


def _greedy(eng, prompt, max_tokens):
    import asyncio

    from dynamo_tpu_torch.runtime.engine import Context

    async def go():
        toks, marker, finish = [], None, None
        async for item in eng.generate(Context({
                "token_ids": prompt, "sampling_options": {"temperature": 0.0},
                "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}})):
            d = item.data or {}
            if "migrating" in d:
                marker = d["migrating"]
            toks.extend(d.get("token_ids", []))
            finish = d.get("finish_reason") or finish
        return toks, marker, finish

    return asyncio.run(go())


# a dispatch is two fault decisions (poison, then slow): after_ops = 2 x its
# index. The 40-token prompt prefills in two chunks of 32; the second emits
# the first token
@pytest.mark.parametrize("after_ops,tokens_before", [(2, 0), (6, 3)])
def test_watchdog_on_the_card(cuda, after_ops, tokens_before):
    """A poisoned chunk (the one that samples the first token) or decode
    dispatch (the second):
    NaN logits on the card, the sentinel substituted there, the stream ends
    with the resume directive and no token of the dispatch escapes; the
    clean run's seal checksums equal a host crc32 of the pool's pages."""
    from dynamo_tpu_torch.runtime import faults, integrity

    prompt = list(range(3, 43))
    eng = _tiny_engine(cuda)
    try:
        clean, marker, finish = _greedy(eng, prompt, 24)
        assert marker is None and finish == "length" and len(clean) == 24
        bids = sorted(eng.allocator._crc_of)
        assert len(bids) >= 3
        pages = [eng.cache[n][:, bids].cpu() for n in ("k", "v")]
        assert [eng.allocator.crc_of_block(b) for b in bids] == integrity.page_checksums(*pages)
    finally:
        eng.close()
    eng = _tiny_engine(cuda)
    rule = faults.FaultRule(plane="engine", point="dispatch", action="poison",
                            after_ops=after_ops, max_fires=1)
    try:
        with faults.active(faults.FaultInjector([rule])):
            toks, marker, finish = _greedy(eng, prompt, 24)
        assert marker == {"resume": True,
                          "error": "output watchdog: non-finite or exploding logits"}
        assert finish is None and eng.watchdog_trips == 1
        # the chunk's token and one decode dispatch of 2 before the poisoned one
        assert toks == clean[:tokens_before]
    finally:
        eng.close()
        integrity.reset_for_tests()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_verify_dispatch_matches_sequential_decode_on_the_card(cuda, quantize):
    """The verify forward (``forward_chunk`` over [last token, 4 drafts] and
    the LM head on every position) against the same 5 positions decoded one
    step at a time through the paged kernel, on a pool of two lanes
    prefilled to 37 and 70 tokens; with ``quantize="int8"`` its products are
    launched on the W8A16 kernels at M = 10 rows."""
    from dynamo_tpu_torch.models.llama import (
        forward_chunk,
        forward_window,
        init_params,
        make_kv_cache,
        quantize_params_int8,
    )

    cfg = LLAMA_PRESETS["tiny"]
    params = init_params(cfg, seed=1, device=cuda)
    dparams = quantize_params_int8(params, cfg) if quantize else params
    S, bs, mb, K1 = 2, 16, 8, 5
    lens = torch.tensor([37, 70], dtype=torch.int32, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (S, 128), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda, dtype=torch.int32)
    cache = make_kv_cache(cfg, S * mb, bs, device=cuda)
    tables = torch.arange(S * mb, dtype=torch.int32, device=cuda).flip(0).reshape(S, mb)
    pos = torch.arange(128, device=cuda)[None, :].repeat(S, 1)
    with torch.no_grad():
        forward_chunk(params, cfg, toks[:, :128], torch.where(pos < lens[:, None], pos, -1).int(),
                      cache, tables, hidden_only=True, with_history=False)
        rows = lens[:, None].long() + torch.arange(K1, device=cuda)[None, :]
        fed = torch.gather(toks, 1, rows).int()
        shape = (cfg.num_layers, S, K1, cfg.num_kv_heads, cfg.head_dim)
        wk = torch.zeros(shape, dtype=cfg.dtype, device=cuda)
        wv = torch.zeros(shape, dtype=cfg.dtype, device=cuda)
        seq = []
        for j in range(K1):
            logits, wk, wv = forward_window(dparams, cfg, fed[:, j], lens + j, cache, tables,
                                            lens, wk, wv, j)
            seq.append(logits.float())
        seq = torch.stack(seq, 1)
        before = int8_weight_matmul.launches
        h, _ = forward_chunk(dparams, cfg, fed, rows.int(), cache, tables, hidden_only=True)
        ver = lm_head(dparams, cfg, h.reshape(S * K1, -1)).reshape(S, K1, -1).float()
        launched = int8_weight_matmul.launches - before
    assert launched == (7 * cfg.num_layers + 1 if quantize else 0)
    rel = ((ver - seq).abs().max() / seq.abs().max()).item()
    assert rel <= 2e-2, rel
    assert torch.isfinite(ver).all()


# -- tensor parallelism: the paged kernel per rank, the collectives ----------------------

from dynamo_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention_sharded,
    paged_decode_attention_sharded_plain,
)
from dynamo_tpu_torch.parallel import collectives  # noqa: E402
from dynamo_tpu_torch.parallel.mesh import MeshConfig, kv_cache_sharding, make_mesh  # noqa: E402

# the per-rank shapes of the tp meshes the port serves: llama3-8b at tp=2
# (16 query heads over 4 kv heads), llama3-70b at tp=4 (16 over 2) and at
# tp=8 (8 over 1: a GQA group of 8 in an mma tile of 16 rows)
TP_SHAPES = [(32, 8, 2), (64, 8, 4), (64, 8, 8)]


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("H,KVH,tp", TP_SHAPES)
def test_sharded_kernel_per_rank_equals_unsharded_kernel(cuda, H, KVH, tp, num_splits):
    """Co-located ranks on the card: each rank's output against the plain
    version, and all ranks' heads against the unsharded kernel at the same
    forced split count (heads are independent: the same sums)."""
    mesh = make_mesh(MeshConfig(tp=tp), [cuda] * tp)
    q, k, v, tables, lengths = _case(8, H, KVH, 128, 16, 512, torch.bfloat16, 11, cuda)
    rule = kv_cache_sharding(mesh)
    pools = [[rule.shard(x[None], r)[0].contiguous() for r in range(tp)] for x in (k, v)]
    before = paged_decode_attention_sharded.launches
    got = paged_decode_attention_sharded(q, *pools, tables, lengths, mesh=mesh,
                                         return_stats=True, num_splits=num_splits)
    assert paged_decode_attention_sharded.launches == before + 1
    plain = paged_decode_attention_sharded_plain(q, *pools, tables, lengths, mesh=mesh,
                                                 return_stats=True)
    whole = paged_decode_attention(q, k, v, tables, lengths, return_stats=True,
                                   num_splits=num_splits)
    torch.cuda.synchronize()
    for r in range(tp):
        assert got[0][r].shape == (8, H // tp, 128)
        torch.testing.assert_close(got[0][r].float(), plain[0][r].float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(got[1][r], plain[1][r], atol=0, rtol=1e-3)
    for g, w in zip(got, whole):
        torch.testing.assert_close(torch.cat(g, dim=1).float(), w.float(), atol=2e-2, rtol=0)


def test_collectives_on_colocated_ranks_on_the_card(cuda):
    rng = np.random.default_rng(12)
    parts = [torch.from_numpy(rng.normal(size=(8, 4096)).astype(np.float32)).to(
        cuda, torch.bfloat16) for _ in range(2)]
    out = collectives.all_reduce(parts)
    assert out[0] is out[1]
    assert torch.equal(out[0], (parts[0].float() + parts[1].float()).bfloat16())
    g = collectives.all_gather(parts, dim=-1)
    assert torch.equal(g, torch.cat(parts, dim=-1))


def test_cross_device_reduction_and_launch():
    """Ranks on two cards: the NCCL reduction lands the fp32 sum rounded
    once on each card, and a rank's kernel launches on its own card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rng = np.random.default_rng(13)
    host = [rng.normal(size=(8, 4096)).astype(np.float32) for _ in devs]
    parts = [torch.from_numpy(h).to(d, torch.bfloat16) for h, d in zip(host, devs)]
    out = collectives.all_reduce(parts)
    want = (parts[0].float().cpu() + parts[1].float().cpu()).bfloat16()
    for o, d in zip(out, devs):
        assert o.device == d
        assert torch.equal(o.cpu(), want)
    args = _case(4, 32, 8, 128, 16, 256, torch.bfloat16, 14, devs[1])
    torch.cuda.set_device(devs[0])
    o = paged_decode_attention(*args)
    torch.cuda.synchronize(devs[1])
    assert o.device == devs[1]
    torch.testing.assert_close(o.float(), paged_decode_attention_plain(*args).float(),
                               atol=2e-2, rtol=0)


# -- the per-rank shapes of "int8-all" and the MoE family on a tp mesh -----------------

from dynamo_tpu_torch.models.llama import quantize_matrix, rank_config  # noqa: E402
from dynamo_tpu_torch.ops import moe  # noqa: E402


def _rank_int8_shapes():
    """(K, N) of one rank's products where "int8-all" serves a preset over
    tp = 2, 4 or 8 (the heads split), not already a whole model's shape."""
    whole = set(_int8_shapes())
    shapes = set()
    for c in LLAMA_PRESETS.values():
        for tp in (2, 4, 8):
            if c.num_heads % tp or c.num_kv_heads % tp or c.intermediate_size % (64 * tp):
                continue
            r = rank_config(c, tp)
            E, F = c.hidden_size, r.intermediate_size
            shapes |= {(E, r.q_dim), (E, r.kv_dim), (r.q_dim, E), (E, F), (F, E),
                       (E, r.vocab_size)}
    return sorted(s for s in shapes - whole if s[0] % 64 == 0 and s[1] % 16 == 0)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M", [1, 8, 65, 1024])
@pytest.mark.parametrize("K,N", _rank_int8_shapes())
def test_int8_kernel_tp_rank_shapes(cuda, K, N, M, out_dtype):
    """A tp rank's W8A16 products (a row-parallel rank's partial in fp32),
    decode to a prefill chunk, against the plain version."""
    q, s = _int8_weight(K, N)
    gen = torch.Generator(device="cuda").manual_seed(M + 1)
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    _check_int8(x, q, s, out_dtype, 1e-2)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("C", [1, 4, 17, 130, 512])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("down", [False, True], ids=["gate_up", "down"])
def test_int8_expert_kernel_tp_rank_stacks(cuda, tp, down, C, out_dtype):
    """mixtral-8x7b's expert stacks at F/tp (gate/up E -> F/tp, down F/tp
    -> E, the partial in fp32) on the planned kernel against the plain
    version."""
    c = LLAMA_PRESETS["mixtral-8x7b"]
    f = c.intermediate_size // tp
    K, N = (f, c.hidden_size) if down else (c.hidden_size, f)
    q, s = _expert_stack(K, N, 5 * K + N + tp)
    x = torch.randn((EXPERTS, C, K), device="cuda").bfloat16()
    _check_experts(x, q, s, out_dtype, EXPERT_BF16_TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_moe_tp_partials_on_the_card(cuda, int8):
    """An MoE layer at F/2 on two co-located ranks: each rank's fp32
    partial (``torch.bmm`` with an fp32 output, or the expert kernel's fp32
    epilogue), summed, against the unsharded layer on the card, and each
    partial against its plain version on the CPU."""
    X, E, F = EXPERTS, 512, 1024
    cfg = moe.MoeConfig(hidden_size=E, intermediate_size=F, num_experts=X, top_k=2,
                        capacity_factor=2.0)
    rank_cfg = dataclasses.replace(cfg, intermediate_size=F // 2)
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = {"w_gate": torch.randn((X, E, F), generator=gen, device="cuda") / E ** 0.5,
         "w_up": torch.randn((X, E, F), generator=gen, device="cuda") / E ** 0.5,
         "w_down": torch.randn((X, F, E), generator=gen, device="cuda") / F ** 0.5}
    router = torch.randn((E, X), generator=gen, device="cuda")
    x = torch.randn((8, 16, E), generator=gen, device="cuda").bfloat16()
    halves = {n: [t[:, :, r * F // 2:(r + 1) * F // 2] if n != "w_down"
                  else t[:, r * F // 2:(r + 1) * F // 2] for r in range(2)]
              for n, t in w.items()}

    def stack(t):
        if not int8:
            return t.bfloat16().contiguous()
        q, s_ = quantize_matrix(t.bfloat16())
        return Int8Weight(q.contiguous(), s_)

    whole = {"router": router, **{n: stack(t) for n, t in w.items()}}
    if int8:  # the down stack's scales are the whole contracted axis's
        qd = whole["w_down"]
        ranks = [{"router": router, "w_gate": stack(halves["w_gate"][r]),
                  "w_up": stack(halves["w_up"][r]),
                  "w_down": Int8Weight(qd.q[:, :, r * F // 2:(r + 1) * F // 2].contiguous(),
                                       qd.s)} for r in range(2)]
    else:
        ranks = [{"router": router, **{n: stack(halves[n][r]) for n in halves}}
                 for r in range(2)]
    want, _ = moe.moe_mlp(whole, cfg, x, with_aux=False)
    parts = [moe.moe_mlp(p, rank_cfg, x, with_aux=False, partial=True)[0] for p in ranks]
    torch.cuda.synchronize()
    assert all(p.dtype == torch.float32 for p in parts)
    got = collectives.all_reduce(parts)[0]
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel <= 2e-2, rel
    for p, part in zip(ranks, parts):
        cpu = {n: (Int8Weight(t.q.cpu(), t.s.cpu()) if isinstance(t, Int8Weight) else t.cpu())
               for n, t in p.items()}
        plain, _ = moe.moe_mlp(cpu, rank_cfg, x.cpu(), with_aux=False, partial=True)
        rel = (part.cpu() - plain).abs().max() / plain.abs().max()
        assert rel <= 1e-2, rel


# -- the profiling plane's device timing on the card -------------------------------


def _flags():
    return torch.zeros(2, dtype=torch.int32, pin_memory=True)


def test_dispatch_gate_holds_the_stream_until_released(cuda):
    """Work enqueued behind the gate does not run until the host writes the
    ticket, and runs after; the wrapper counts its launch."""
    import time

    from dynamo_tpu_torch.ops.dispatch_gate import dispatch_gate_wait

    flags = _flags()
    x = torch.zeros(1024, device=cuda)
    # load add_'s kernel first: a first launch waits for the card, and so
    # would wait behind the gate (the device timer's note)
    x.add_(0.0)
    torch.cuda.synchronize()
    before = dispatch_gate_wait.launches
    dispatch_gate_wait(flags, 1, cuda)
    x.add_(1.0)
    done = torch.cuda.Event()
    done.record()
    time.sleep(0.05)
    assert not done.query()  # nothing behind the gate has run
    flags.numpy().view("uint32")[0] = 1
    done.synchronize()
    assert x.eq(1.0).all().item() and flags[1].item() == 0
    assert dispatch_gate_wait.launches == before + 1
    # released already (the counter at or past the ticket, modulo 2^32): passes
    flags.numpy().view("uint32")[0] = 0xFFFFFFFF
    dispatch_gate_wait(flags, 0xFFFFFFFE, cuda)
    x.add_(1.0)
    torch.cuda.synchronize()
    assert x.eq(2.0).all().item()


def test_dispatch_gate_times_out_without_a_release(cuda):
    from dynamo_tpu_torch.ops.dispatch_gate import dispatch_gate_wait

    flags = _flags()
    dispatch_gate_wait(flags, 7, cuda, timeout_s=0.05)
    torch.cuda.synchronize()
    assert flags[1].item() == 1


def _layers(n, d=4096, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((d, d), generator=gen, device="cuda").bfloat16() / d ** 0.5
            for _ in range(n)]


def _run_layers(x, ws, mark=None, host_pause=0.0):
    import time

    for w in ws:
        x = torch.nn.functional.silu(x @ w) + x
        if host_pause:
            time.sleep(host_pause)  # a host slower than the card
        if mark is not None:
            mark()
    return x


def test_device_timer_times_the_device_not_the_host(cuda):
    """The segment-gated time of a layer chain equals the chain's execution
    time with every kernel queued ahead of the card (behind a sleep kernel),
    within 30% (the events and the gates cost the card a few microseconds
    per segment), even when the host pauses 2 ms per layer while
    enqueueing it; an event pair around the same paused enqueue times the
    host."""
    from dynamo_tpu_torch.engine_torch.device_timer import DeviceTimer

    ws = _layers(48)
    x = torch.randn((256, 4096), device=cuda).bfloat16()
    _run_layers(x, ws)
    torch.cuda.synchronize()
    refs = []
    for _ in range(3):  # the chain with its kernels queued ahead of the card
        torch.cuda._sleep(50_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _run_layers(x, ws)
        b.record()
        b.synchronize()
        refs.append(a.elapsed_time(b) * 1e3)
    ref = min(refs)
    timer = DeviceTimer(cuda)
    got = []
    for _ in range(3):
        timer.begin()
        try:
            y = _run_layers(x, ws, timer.mark, host_pause=0.002)
        finally:
            timer.end()
        got.append(timer.device_us())
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    _run_layers(x, ws, host_pause=0.002)
    b.record()
    b.synchronize()
    naive = a.elapsed_time(b) * 1e3
    assert timer.timeouts == 0 and all(g is not None for g in got)
    assert 0.8 * ref <= min(got) <= 1.3 * ref, (got, ref)
    assert naive > 48 * 2000 > 4 * max(got), (naive, got)
    torch.testing.assert_close(y, _run_layers(x, ws))


def test_device_timer_voids_a_wait_inside_a_segment_and_resumes(cuda, monkeypatch):
    """A host that waits for the card inside a gated segment stalls until
    the gate gives up: that dispatch's time is void and counted, the next
    RESUME_AFTER dispatches run untimed, and then a clean dispatch is timed
    again."""
    from dynamo_tpu_torch.engine_torch.device_timer import RESUME_AFTER, DeviceTimer

    ws = _layers(4)
    x = torch.randn((256, 4096), device=cuda).bfloat16()
    _run_layers(x, ws)
    torch.cuda.synchronize()
    monkeypatch.setattr("dynamo_tpu_torch.engine_torch.device_timer.GATE_TIMEOUT_S", 0.05)
    timer = DeviceTimer(cuda)
    step = object()
    timer.ready(step)  # the first run of a step function is never timed
    assert timer.ready(step)
    timer.begin()
    try:
        _run_layers(x, ws, timer.mark)
        x.sum().item()  # waits for the card behind the closed gate
    finally:
        timer.end()
    assert timer.device_us() is None and timer.timeouts == 1
    assert not any(timer.ready(step) for _ in range(RESUME_AFTER))
    assert timer.ready(step)
    timer.begin()
    try:
        _run_layers(x, ws, timer.mark)
    finally:
        timer.end()
    assert timer.device_us() > 0 and timer.timeouts == 1


def test_engine_timeline_on_the_card(cuda, monkeypatch):
    """DYN_TPU_PROFILE=1, every dispatch sampled: every dispatch of the
    tiny engine is counted and every one after its step function's first
    run has a record with device time; no gate timed out, and the greedy
    stream equals the unprofiled engine's."""
    from dynamo_tpu_torch.runtime import profiling

    prompt = list(range(3, 43))
    eng = _tiny_engine(cuda)
    try:
        want, _, _ = _greedy(eng, prompt, 24)
    finally:
        eng.close()
    monkeypatch.setenv("DYN_TPU_PROFILE", "1")
    monkeypatch.setenv("DYN_TPU_PROFILE_SAMPLE", "1")
    profiling.reset_for_tests()
    eng = _tiny_engine(cuda)
    try:
        got, _, _ = _greedy(eng, prompt, 24)
        recs = profiling.timeline().records()
        total = profiling.timeline().dispatches_total
        m = eng.metrics_snapshot()
    finally:
        eng.close()
        profiling.reset_for_tests()
    assert got == want
    assert m["dispatch_gate_timeouts"] == 0
    assert total == eng.chunk_dispatches + eng.decode_dispatches
    phases = [r["phase"] for r in recs]
    # the two chunks are the first runs of their variants (without and
    # with pool history): untimed; one decode variant
    assert phases.count("chunk") == 0 and eng.chunk_dispatches == 2
    assert phases.count("decode") == eng.decode_dispatches - 1 > 0
    assert all(r["device_us"] > 0 and r["host_us"] > 0 for r in recs)
