"""The port's paged attention ops against the JAX package's, on the CPU.

``paged_decode_attention`` on CPU tensors runs its plain version; it is held
against the three Pallas decode kernels (v1, v2, v4) in interpret mode with
softmax stats, at fp32 and atol 1e-5 (the kernels' own parity bound in
tests/test_pallas_attention.py). ``write_kv_to_pages`` and the eager
``paged_attention`` are held against their jnp counterparts.
"""

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
