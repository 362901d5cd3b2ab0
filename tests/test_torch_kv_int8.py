"""The port's int8 KV pool against the JAX package's, on the CPU in fp32.

- ``quantize_kv`` / ``dequantize_kv``: bit-equal to JAX, all-zero (padding)
  rows included.
- The int8 paged decode function (its plain version on CPU tensors) against
  JAX's ``dequantize_kv`` followed by the v2 Pallas kernel in interpret
  mode, at atol and rtol 1e-5 (the fp32 plain versions' parity bound,
  ``tests/test_torch_paged_attention.py``).
- The int8 decode function's folded scales (scores times k_scale, p times
  v_scale before p is rounded): in fp32 it equals ``dequantize_kv``
  followed by the plain paged attention at atol and rtol 1e-5; in bf16 it
  sits no farther from an fp64 evaluation of the same int8 pages than
  that path does.
- ``forward_chunk`` (with and without history), ``forward_window`` and
  ``flush_window`` on an int8 pool against JAX's ``forward_chunk``,
  ``forward_window(("dense", *gather_history(...)))`` and ``flush_window``:
  logits within 1e-4 of the largest (fp32, sums in other orders); scales
  at rtol 1e-6; int8 pages equal but for ±1 flips where the fp32 K/V of
  the two frameworks differ in their last bits and a value lies within
  that of a rounding boundary (at most ``MAX_FLIP_SHARE`` of the values).
- ``EngineConfig.kv_dtype`` and ``DYN_TPU_KV_DTYPE``, and ``inject_blocks``'
  ``KvDtypeMismatch`` both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops.pallas.paged_attention import paged_attention_decode_v2
from dynamo_tpu_torch.engine_torch.allocator import KvDtypeMismatch
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine, env_kv_dtype
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops.paged_attention import (
    paged_decode_attention_int8,
    paged_decode_attention_int8_plain,
    paged_decode_attention_plain,
)

LOGIT_RTOL = 1e-4  # max|Δlogits| / max|logits|
SCALE_RTOL = 1e-6
MAX_FLIP_SHARE = 1e-3  # int8 values that may differ by one, of all written


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jl.LLAMA_PRESETS["tiny"], dtype=jnp.float32)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tl.LlamaConfig)
              if f.name != "dtype"}
    tc = tl.LlamaConfig(dtype=torch.float32, **fields)
    rng = np.random.default_rng(11)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(3), jc))
    jp = jax.tree.map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape) / np.sqrt(sd.shape[-1]), sd.dtype),
        shapes,
    )
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _int8_pool(c, n_blocks, bs, seed):
    """A random int8 pool in the JAX layout: the quantization of normal K/V
    (numpy), so pages and scales are consistent."""
    rng = np.random.default_rng(seed)
    shape = (c.num_layers, n_blocks, bs, c.num_kv_heads, c.head_dim)
    k, v = (jnp.asarray(rng.normal(size=shape).astype(np.float32)) for _ in range(2))
    kq, vq, ks, vs = jl.quantize_kv(k, v)
    return {"k": np.asarray(kq), "v": np.asarray(vq), "k_scale": np.asarray(ks),
            "v_scale": np.asarray(vs)}


def _jax_pool(pool):
    return {n: jnp.asarray(x) for n, x in pool.items()}


def _torch_pool(pool):
    return {n: torch.from_numpy(np.array(x)) for n, x in pool.items()}


def _pools_agree(tpool, jpool, written=None) -> None:
    """Scales at SCALE_RTOL; int8 values equal but for at most
    MAX_FLIP_SHARE of ``written`` (the count of values either side wrote)
    differing by one."""
    for n in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tpool[n].numpy(), np.asarray(jpool[n]), rtol=SCALE_RTOL,
                                   atol=0)
    for n in ("k", "v"):
        d = np.abs(tpool[n].numpy().astype(np.int32) - np.asarray(jpool[n]).astype(np.int32))
        assert d.max() <= 1, n
        share = np.count_nonzero(d) / (written or d.size)
        assert share <= MAX_FLIP_SHARE, (n, share)


def _close_logits(got, want) -> None:
    want = np.asarray(want)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= LOGIT_RTOL, rel


def test_quantize_dequantize_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(3, 5, 2, 16)) * rng.uniform(0.01, 30, size=(3, 5, 1, 1)))
    v = rng.normal(size=(3, 5, 2, 16)) * 4
    k[1, 2:] = 0.0  # all-zero padding rows
    v[0, 4] = 0.0
    k, v = k.astype(np.float32), v.astype(np.float32)
    want = jl.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = tl.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    for g, w in zip(got, want):
        _bits_equal(g, w)
    assert not got[0][1, 2:].any() and (got[2][1, 2:] == np.float32(1e-12) / 127).all()
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        _bits_equal(tl.dequantize_kv(got[0], got[2], dt), jl.dequantize_kv(want[0], want[2], jdt))


@pytest.mark.parametrize("lengths", [[16, 1, 7, 32], [0, 31, 9, 17]])
def test_int8_decode_plain_matches_dequantize_then_v2_kernel(lengths):
    rng = np.random.default_rng(sum(lengths))
    s, h, kvh, d, bs, mb = 4, 8, 2, 32, 8, 4
    n_blocks = s * mb + 3
    pages = rng.integers(-127, 128, size=(2, n_blocks, bs, kvh, d)).astype(np.int8)
    scales = rng.uniform(1e-3, 5e-2, size=(2, n_blocks, bs)).astype(np.float32)
    q = rng.normal(size=(s, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: s * mb].reshape(s, mb).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    jk = jl.dequantize_kv(jnp.asarray(pages[0]), jnp.asarray(scales[0]), jnp.float32)
    jv = jl.dequantize_kv(jnp.asarray(pages[1]), jnp.asarray(scales[1]), jnp.float32)
    want = paged_attention_decode_v2(
        jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens), interpret=True,
        return_stats=True,
    )
    t = torch.from_numpy
    got = paged_decode_attention_int8(
        t(q), t(pages[0]), t(pages[1]), t(scales[0]), t(scales[1]), t(tables), t(lens),
        return_stats=True,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _ragged_int8_case(seed, dtype, s=6, h=8, kvh=2, d=32, bs=8, mb=6):
    """Random int8 pages and scales under permuted tables (garbage past each
    lane's live pages), ragged lengths with one empty lane, NaN scales in
    the dead slots of each lane's last page, q in ``dtype``."""
    rng = np.random.default_rng(seed)
    n_blocks = s * mb + 5
    pages = rng.integers(-127, 128, size=(2, n_blocks, bs, kvh, d)).astype(np.int8)
    scales = rng.uniform(1e-3, 5e-2, size=(2, n_blocks, bs)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: s * mb].reshape(s, mb).astype(np.int32)
    lens = rng.integers(1, mb * bs + 1, size=s).astype(np.int32)
    lens[1] = 0
    for lane, n in enumerate(lens):
        live = -(-int(n) // bs)
        if n % bs:
            scales[:, tables[lane, live - 1], n % bs:] = np.nan
        tables[lane, live:] = 1 << 30
    q = torch.from_numpy(rng.normal(size=(s, h, d)).astype(np.float32)).to(dtype)
    t = torch.from_numpy
    return q, t(pages[0]), t(pages[1]), t(scales[0]), t(scales[1]), t(tables), t(lens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_decode_plain_fp32_equals_dequantize_then_plain(seed):
    q, kq, vq, ks, vs, tables, lens = _ragged_int8_case(seed, torch.float32)
    got = paged_decode_attention_int8_plain(q, kq, vq, ks, vs, tables, lens, return_stats=True)
    want = paged_decode_attention_plain(q, tl.dequantize_kv(kq, ks, torch.float32),
                                        tl.dequantize_kv(vq, vs, torch.float32), tables, lens,
                                        return_stats=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_decode_plain_bf16_no_farther_from_fp64_than_dequantize_path(seed):
    """Folding the scales rounds each p · v_scale once, where dequantizing
    first rounds every k and v value and p: the folded bf16 result is no
    farther from the fp64 evaluation of the same int8 pages and scales, in
    the root mean square over all outputs. (The largest single error is
    that of one output's final rounding to bf16 in a short lane, which
    both paths share, and goes either way.)"""
    q, kq, vq, ks, vs, tables, lens = _ragged_int8_case(seed, torch.bfloat16)
    exact = paged_decode_attention_int8_plain(q.double(), kq, vq, ks, vs, tables, lens)
    assert exact.dtype == torch.float64 and torch.isfinite(exact).all()
    folded = paged_decode_attention_int8_plain(q, kq, vq, ks, vs, tables, lens)
    dequantized = paged_decode_attention_plain(q, tl.dequantize_kv(kq, ks, torch.bfloat16),
                                               tl.dequantize_kv(vq, vs, torch.bfloat16),
                                               tables, lens)
    assert folded.dtype == torch.bfloat16 and torch.isfinite(folded.float()).all()
    err_folded = (folded.double() - exact).pow(2).mean().sqrt().item()
    err_dequantized = (dequantized.double() - exact).pow(2).mean().sqrt().item()
    assert 0 < err_folded <= err_dequantized, (err_folded, err_dequantized)
    assert (folded[1] == 0).all()  # the empty lane


def test_int8_split_plan_is_one_wave_of_shapes_alone():
    """The int8 kernel's split count: a function of shapes and of the
    kernel's resident blocks per SM, never of lengths; the grid stays
    within one wave (8 lanes x 8 kv heads at 4 blocks per SM on 132 SMs:
    8 splits, 512 blocks of 528; at 3 blocks per SM 6, 384 of 396)."""
    import inspect

    from dynamo_tpu_torch.ops.paged_attention import plan_splits_int8

    assert "lengths" not in inspect.signature(plan_splits_int8).parameters
    assert plan_splits_int8(8, 32, 8, 128, 16, 4, 132) == 8
    assert plan_splits_int8(8, 32, 8, 128, 16, 3, 132) == 6
    assert plan_splits_int8(8, 32, 8, 512, 16, 4, 132) == 8  # 8192 tokens of table
    assert plan_splits_int8(64, 32, 8, 64, 16, 4, 132) == 1
    assert plan_splits_int8(1, 32, 8, 128, 16, 4, 132) == 16  # 2 tiles of 64 keys each
    for lanes in (1, 2, 8, 64, 256):
        for resident in (1, 2, 3, 4, 6):
            for mb in (1, 8, 128):
                n = plan_splits_int8(lanes, 32, 8, mb, 16, resident, 132)
                assert 1 <= n <= mb and n == plan_splits_int8(lanes, 32, 8, mb, 16, resident, 132)
                assert n == 1 or lanes * 8 * n <= resident * 132


@pytest.mark.parametrize("with_history", [False, True])
def test_forward_chunk_on_int8_pool_matches(models, with_history):
    jc, tc, jp, tp = models
    bs = 4
    pool = _int8_pool(jc, 16, bs, 1)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11]], np.int32)
    tokens = np.array([[3, 17, 42, 5, 9], [8, 1, 2, 0, 0]], np.int32)
    start = [6, 3] if with_history else [0, 0]
    pos = np.stack([np.arange(s0, s0 + 5) for s0 in start]).astype(np.int32)
    pos[1, 3:] = -1  # padding tail
    jlog, jcache = jl.forward_chunk(jp, jc, jnp.asarray(tokens), jnp.asarray(pos),
                                    _jax_pool(pool), jnp.asarray(tables),
                                    with_history=with_history)
    t = torch.from_numpy
    tlog, tcache = tl.forward_chunk(tp, tc, t(tokens), t(pos), _torch_pool(pool), t(tables),
                                    with_history=with_history)
    assert tl.kv_cache_quantized(tcache) and tcache["k"].dtype == torch.int8
    valid = pos >= 0
    _close_logits(tlog.numpy()[valid], np.asarray(jlog)[valid])
    written = int(valid.sum()) * jc.num_layers * jc.num_kv_heads * jc.head_dim
    _pools_agree(tcache, jcache, written)


def test_forward_window_and_flush_on_int8_pool_match(models):
    """Two decode steps over an int8 pool, the port through the int8 decode
    function (its plain version here), JAX through its dense tier
    (``gather_history`` dequantizes), then the window flush quantizes the
    window into the pool on both sides."""
    jc, tc, jp, tp = models
    bs, W = 4, 2
    pool = _int8_pool(jc, 16, bs, 2)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11], [4, 6, 8, 10]], np.int32)
    base = np.array([6, 0, -1], np.int32)  # lane 1: empty pool; lane 2: padding
    toks = np.array([11, 4, 0], np.int32)
    wshape = (jc.num_layers, 3, W, jc.num_kv_heads, jc.head_dim)
    jwk = jwv = jnp.zeros(wshape, jnp.float32)
    twk, twv = torch.zeros(wshape), torch.zeros(wshape)
    jcache, tcache = _jax_pool(pool), _torch_pool(pool)
    ttab, tbase = torch.from_numpy(tables), torch.from_numpy(base)
    hist = jl.gather_history(jcache, jnp.asarray(tables), jnp.float32)
    pos = base.copy()
    for step in range(W):
        jlog, jwk, jwv = jl.forward_window(
            jp, jc, jnp.asarray(toks), jnp.asarray(pos), ("dense",) + hist, jnp.asarray(base),
            jwk, jwv, jnp.int32(step),
        )
        tlog, twk, twv = tl.forward_window(
            tp, tc, torch.from_numpy(toks), torch.from_numpy(pos), tcache, ttab, tbase,
            twk, twv, step,
        )
        _close_logits(tlog.numpy()[:2], np.asarray(jlog)[:2])
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    np.testing.assert_allclose(twk.numpy(), np.asarray(jwk), atol=1e-5, rtol=0)
    jcache = jl.flush_window(jcache, jnp.asarray(tables), jnp.asarray(base), jwk, jwv, 14)
    tcache = tl.flush_window(tcache, ttab, tbase, twk, twv, 14)
    written = 2 * W * jc.num_layers * jc.num_kv_heads * jc.head_dim  # two live lanes
    _pools_agree(tcache, jcache, written)
    # the flush wrote the window: positions base .. base + W - 1 of lane 0
    assert not np.array_equal(tcache["k_scale"].numpy(), pool["k_scale"])


def test_kv_dtype_config_and_env(monkeypatch):
    with pytest.raises(ValueError, match="kv_dtype='INT8'"):
        EngineConfig(kv_dtype="INT8")
    monkeypatch.setenv("DYN_TPU_KV_DTYPE", "int-8")  # a typo: the native layout
    assert env_kv_dtype() == "bf16"
    monkeypatch.setenv("DYN_TPU_KV_DTYPE", " INT8 ")
    assert env_kv_dtype() == "int8"


def _tiny_engine(kv_dtype):
    c = dataclasses.replace(tl.LLAMA_PRESETS["tiny"], dtype=torch.float32)
    return TorchServingEngine(c, tl.init_params(c, seed=2), EngineConfig(
        max_slots=2, kv_block_size=8, max_model_len=32, num_kv_blocks=8, kv_dtype=kv_dtype,
    ), device="cpu")


def test_env_typo_gives_native_pool(monkeypatch):
    monkeypatch.setenv("DYN_TPU_KV_DTYPE", "int")
    eng = _tiny_engine(None)
    assert not tl.kv_cache_quantized(eng.cache) and eng.cache["k"].dtype == torch.float32
    monkeypatch.setenv("DYN_TPU_KV_DTYPE", "int8")
    eng = _tiny_engine(None)
    assert tl.kv_cache_quantized(eng.cache) and eng.metrics_snapshot()["kv_quantized"] == 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_inject_blocks_rejects_a_layout_mismatch(kv_dtype):
    eng = _tiny_engine(kv_dtype)
    c = eng.model_config
    shape = (c.num_layers, 2, 8, c.num_kv_heads, c.head_dim)
    before = {n: x.clone() for n, x in eng.cache.items()}
    if kv_dtype == "int8":  # int8 pool, pages without scales
        args = (torch.ones(shape, dtype=torch.int8), torch.ones(shape, dtype=torch.int8))
    else:  # native pool, pages that carry scales
        args = (torch.ones(shape), torch.ones(shape), torch.ones(shape[:3]),
                torch.ones(shape[:3]))
    with pytest.raises(KvDtypeMismatch):
        eng.inject_blocks([3, 5], *args)
    for n, x in eng.cache.items():  # no byte landed
        assert torch.equal(x, before[n])
    # the matching layout lands in place
    if kv_dtype == "int8":
        args = args + (torch.full(shape[:3], 0.5), torch.full(shape[:3], 0.25))
    else:
        args = args[:2]
    eng.inject_blocks([3, 5], *args)
    assert torch.equal(eng.cache["k"][:, [3, 5]], args[0].to(eng.cache["k"].dtype))
    if kv_dtype == "int8":
        assert torch.equal(eng.cache["v_scale"][:, [3, 5]], args[3])
