"""The port's paged attention ops against the JAX package's, on the CPU.

``paged_decode_attention`` on CPU tensors runs its plain version; it is held
against the three Pallas decode kernels (v1, v2, v4) in interpret mode with
softmax stats, at fp32 and atol 1e-5 (the kernels' own parity bound in
tests/test_pallas_attention.py). ``write_kv_to_pages`` and the eager
``paged_attention`` are held against their jnp counterparts.

``paged_decode_split_plain`` (the split and merge kernels' arithmetic) is
held against the unsplit plain version at fp32 to 1e-6, and against the v2
and v4 kernels on inputs whose garbage table entries and NaN dead slots only
the port sees; ``plan_splits`` is checked to be a function of shapes alone.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.attention import paged_attention as jax_paged_attention
from dynamo_tpu.ops.attention import write_kv_to_pages as jax_write_kv
from dynamo_tpu.ops.pallas.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_v2,
    paged_attention_decode_v4,
    v4_plan,
)
from dynamo_tpu_torch.ops.attention import paged_attention, write_kv_to_pages
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_split_plain,
    plan_splits,
)

ATOL = 1e-5


def _case(seed, s, h, kvh, d, bs, mb, lengths):
    rng = np.random.default_rng(seed)
    n_blocks = s * mb + 3
    k = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    q = rng.normal(size=(s, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: s * mb].reshape(s, mb).astype(np.int32)
    return q, k, v, tables, np.asarray(lengths, np.int32)


def _port(q, k, v, tables, lengths):
    t = torch.from_numpy
    return [
        x.numpy() for x in paged_decode_attention(
            t(q), t(k), t(v), t(tables), t(lengths), return_stats=True
        )
    ]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("lengths", [
    [16, 16, 16, 16],  # page-aligned
    [1, 7, 17, 31],  # ragged, partial pages
    [0, 5, 32, 12],  # padding lane
])
def test_plain_matches_v1_kernel(lengths):
    args = _case(0, 4, 8, 2, 32, 8, 4, lengths)
    want = paged_attention_decode(*map(jnp.asarray, args), interpret=True, return_stats=True)
    _close(_port(*args), want)


def test_plain_matches_v1_gqa_small_head():
    # the tiny preset's geometry: D=16, KVH=2, two query heads per kv head
    args = _case(1, 2, 4, 2, 16, 8, 2, [9, 13])
    want = paged_attention_decode(*map(jnp.asarray, args), interpret=True, return_stats=True)
    _close(_port(*args), want)


@pytest.mark.parametrize("lengths,pages_per_chunk", [
    ([16, 16, 16, 16], 2),
    ([1, 7, 17, 31], 2),
    ([0, 5, 32, 12], 4),
    ([31, 3, 9, 2], 8),
    ([31, 25, 17, 32], 1),
])
def test_plain_matches_v2_kernel(lengths, pages_per_chunk):
    args = _case(5, 4, 8, 2, 32, 8, 4, lengths)
    want = paged_attention_decode_v2(
        *map(jnp.asarray, args), pages_per_chunk=pages_per_chunk, interpret=True,
        return_stats=True,
    )
    _close(_port(*args), want)


@pytest.mark.parametrize("lengths", [[7, 31], [0, 17]])
def test_plain_matches_v4_kernel(lengths):
    # KVH·D = 2·64 = 128: the fused-lane geometry v4 serves (two lanes keep
    # the interpret-mode compile of its per-lane unroll short)
    s, h, kvh, d, bs, mb = 2, 8, 2, 64, 8, 4
    args = _case(9, s, h, kvh, d, bs, mb, lengths)
    plan = v4_plan(s, bs, kvh, d, 4, mb)
    want = paged_attention_decode_v4(
        *map(jnp.asarray, args), pages_per_chunk=plan, interpret=True, return_stats=True,
    )
    _close(_port(*args), want)


def test_plain_ignores_garbage_table_entries_and_dead_slots():
    """Entries past a lane's live pages are never read, and NaN in the dead
    slots of its last page never reaches the output."""
    q, k, v, tables, lengths = _case(3, 3, 4, 2, 16, 4, 4, [5, 0, 9])
    ref = paged_decode_attention_plain(*map(torch.from_numpy, (q, k, v, tables, lengths)),
                                       return_stats=True)
    for s, n in enumerate(lengths):
        n_pages = -(-int(n) // 4)
        tables[s, n_pages:] = 1 << 30
        if n % 4:
            k[tables[s, n_pages - 1], n % 4:] = np.nan
            v[tables[s, n_pages - 1], n % 4:] = np.nan
    got = paged_decode_attention_plain(*map(torch.from_numpy, (q, k, v, tables, lengths)),
                                       return_stats=True)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    o, m, l = got
    assert (o[1] == 0).all() and (m[1] == -1e30).all() and (l[1] == 0).all()


def test_write_kv_to_pages_drops_padding_and_out_of_table():
    rng = np.random.default_rng(4)
    n_blocks, bs, kvh, d = 8, 4, 2, 8
    kc = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    vc = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    kn = rng.normal(size=(2, 5, kvh, d)).astype(np.float32)
    vn = rng.normal(size=(2, 5, kvh, d)).astype(np.float32)
    # lane 0: positions 6..10 with table of 2 blocks (8 slots): 8..10 are
    # out of table; lane 1: padding (-1) mixed with real positions
    pos = np.array([[6, 7, 8, 9, 10], [-1, 0, 1, -1, 2]], np.int32)
    tables = np.array([[3, 5], [1, 6]], np.int32)
    wk, wv = jax_write_kv(*map(jnp.asarray, (kc, vc, kn, vn, pos, tables)))
    tk, tv = write_kv_to_pages(*map(torch.from_numpy, (kc.copy(), vc.copy(), kn, vn, pos, tables)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("t", [1, 5])
def test_eager_paged_attention_matches_jnp(t):
    rng = np.random.default_rng(6)
    b, h, kvh, d, bs, mb = 3, 4, 2, 16, 4, 4
    n_blocks = 16
    kc = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    vc = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: b * mb].reshape(b, mb).astype(np.int32)
    pos = np.stack([np.arange(p0, p0 + t) for p0 in (3, 9, 0)]).astype(np.int32)
    pos[2, :] = -1  # a padding row
    want = jax_paged_attention(*map(jnp.asarray, (q, kc, vc, tables, pos)), use_pallas=False)
    got = paged_attention(*map(torch.from_numpy, (q, kc, vc, tables, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _poison(tables, k, v, lengths, bs):
    """Copies with every table entry past a lane's live pages out of range
    and NaN in the dead slots of each lane's last page."""
    tables, k, v = tables.copy(), k.copy(), v.copy()
    for s, n in enumerate(lengths):
        n_pages = -(-int(n) // bs)
        if n % bs:
            k[tables[s, n_pages - 1], n % bs:] = np.nan
            v[tables[s, n_pages - 1], n % bs:] = np.nan
        tables[s, n_pages:] = 1 << 30
    return tables, k, v


# 0-length lane, a page-aligned lane, ragged lanes; 12 pages of 4 = 48 slots
SPLIT_LENGTHS = [0, 16, 45, 7]


@pytest.mark.parametrize("num_splits", [1, 2, 3, 40])  # 40 > any lane's pages
@pytest.mark.parametrize("tile_keys", [4, 8, 32])
def test_split_plain_equals_unsplit(num_splits, tile_keys):
    q, k, v, tables, lengths = _case(11, 4, 8, 2, 16, 4, 12, SPLIT_LENGTHS)
    args = [torch.from_numpy(x) for x in (q, k, v, tables, lengths)]
    want = paged_decode_attention_plain(*args, return_stats=True)
    got = paged_decode_split_plain(*args, num_splits, return_stats=True, tile_keys=tile_keys)
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=1e-6)
    o, m, l = got
    assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()


def test_cpu_wrapper_runs_the_plain_version_whatever_the_split_count():
    q, k, v, tables, lengths = _case(12, 4, 8, 2, 16, 4, 12, SPLIT_LENGTHS)
    args = [torch.from_numpy(x) for x in (q, k, v, tables, lengths)]
    got = paged_decode_attention(*args, return_stats=True, num_splits=3)
    want = paged_decode_attention_plain(*args, return_stats=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with pytest.raises(ValueError):
        paged_decode_attention(*args, num_splits=0)


@pytest.mark.parametrize("num_splits", [2, 3])
def test_split_plain_matches_v2_kernel_on_poisoned_inputs(num_splits):
    lengths = [0, 5, 32, 12]
    q, k, v, tables, lens = _case(5, 4, 8, 2, 32, 8, 4, lengths)
    want = paged_attention_decode_v2(
        *map(jnp.asarray, (q, k, v, tables, lens)), pages_per_chunk=2, interpret=True,
        return_stats=True,
    )
    pt, pk, pv = _poison(tables, k, v, lengths, 8)
    got = paged_decode_split_plain(*map(torch.from_numpy, (q, pk, pv, pt, lens)), num_splits,
                                   return_stats=True, tile_keys=8)
    for g in got:
        assert torch.isfinite(g).all()
    _close([g.numpy() for g in got], want)


@pytest.mark.parametrize("num_splits", [2, 5])
def test_split_plain_matches_v4_kernel_on_poisoned_inputs(num_splits):
    # v4's fused-lane geometry, KVH·D = 2·64 = 128, as in the v4 test above
    lengths = [0, 29]
    s, h, kvh, d, bs, mb = 2, 8, 2, 64, 8, 4
    q, k, v, tables, lens = _case(9, s, h, kvh, d, bs, mb, lengths)
    plan = v4_plan(s, bs, kvh, d, 4, mb)
    want = paged_attention_decode_v4(
        *map(jnp.asarray, (q, k, v, tables, lens)), pages_per_chunk=plan, interpret=True,
        return_stats=True,
    )
    pt, pk, pv = _poison(tables, k, v, lengths, bs)
    got = paged_decode_split_plain(*map(torch.from_numpy, (q, pk, pv, pt, lens)), num_splits,
                                   return_stats=True, tile_keys=8)
    for g in got:
        assert torch.isfinite(g).all()
    _close([g.numpy() for g in got], want)


def test_plan_splits_is_a_function_of_shapes():
    assert "lengths" not in inspect.signature(plan_splits).parameters
    for dtype in (torch.bfloat16, torch.float32):
        for lanes in (1, 2, 8, 64, 512):
            for heads, kv_heads in ((32, 8), (4, 2), (32, 1), (8, 8)):
                for mb, bs in ((1, 16), (3, 16), (128, 16), (16, 128)):
                    n = plan_splits(lanes, heads, kv_heads, mb, bs, dtype, 132)
                    assert 1 <= n <= mb
                    assert n == plan_splits(lanes, heads, kv_heads, mb, bs, dtype, 132)
    # one lane at long context gets many splits, a full grid gets none
    assert plan_splits(1, 32, 8, 128, 16, torch.bfloat16, 132) > 8
    assert plan_splits(512, 32, 8, 128, 16, torch.bfloat16, 132) == 1
