"""The port's Llama model against the JAX package's, on the CPU in fp32.

The JAX parameter pytree is carried across with ``params_from_numpy``; the
same tokens, positions, block tables and KV pool go through both. Logits
(and the pools both sides write) must agree to atol 1e-4: fp32 on both
sides, with sums taken in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.models import llama as tl

ATOL = 1e-4

GEOMETRIES = {
    # the tiny preset (D=16, KVH=2: the v1-kernel geometry)
    "tiny": dict(),
    # KVH·D = 2·64 = 128: the geometry the v4 kernel serves
    "kvd128": dict(num_heads=4, num_kv_heads=2, head_dim=64, hidden_size=128,
                   intermediate_size=256, vocab_size=256),
}


def _configs(name):
    jc = dataclasses.replace(jl.LLAMA_PRESETS["tiny"], dtype=jnp.float32, **GEOMETRIES[name])
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tl.LlamaConfig)
              if f.name != "dtype"}
    return jc, tl.LlamaConfig(dtype=torch.float32, **fields)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def models(request):
    jc, tc = _configs(request.param)
    # numpy-made weights in init_params' tree (eval_shape: no random-init compile)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(3), jc))
    jp = jax.tree.map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape) / np.sqrt(sd.shape[-1]), sd.dtype),
        shapes,
    )
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jp, tp


def _pool(c, n_blocks, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (c.num_layers, n_blocks, bs, c.num_kv_heads, c.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_forward_matches(models):
    jc, tc, jp, tp = models
    bs, mb = 4, 4
    k0, v0 = _pool(jc, 16, bs, 0)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11]], np.int32)
    tokens = np.array([[3, 17, 42, 5, 9], [8, 1, 2, 0, 0]], np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [6, 7, 8, -1, -1]], np.int32)
    jlog, jcache = jl.forward(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pos),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(tables), use_pallas=False,
    )
    tk, tv, tt, tpos, ttab = _t(k0, v0, tokens, pos, tables)
    tlog, tcache = tl.forward(tp, tc, tt, tpos, {"k": tk, "v": tv}, ttab)
    valid = pos >= 0
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_history", [False, True])
def test_forward_chunk_matches(models, with_history):
    jc, tc, jp, tp = models
    bs = 4
    k0, v0 = _pool(jc, 16, bs, 1)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11]], np.int32)
    tokens = np.array([[3, 17, 42, 5, 9], [8, 1, 2, 0, 0]], np.int32)
    start = [6, 3] if with_history else [0, 0]
    pos = np.stack([np.arange(s, s + 5) for s in start]).astype(np.int32)
    pos[1, 3:] = -1  # padding tail
    jlog, jcache = jl.forward_chunk(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pos),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(tables),
        with_history=with_history,
    )
    tk, tv, tt, tpos, ttab = _t(k0, v0, tokens, pos, tables)
    tlog, tcache = tl.forward_chunk(
        tp, tc, tt, tpos, {"k": tk, "v": tv}, ttab, with_history=with_history
    )
    valid = pos >= 0
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)


def test_forward_window_paged_and_flush_match(models):
    """Two decode steps of forward_window in the paged history mode (the
    JAX side through the Pallas kernel in interpret mode), then the
    window flush: logits, window and pool all agree."""
    jc, tc, jp, tp = models
    bs, W = 4, 2
    k0, v0 = _pool(jc, 16, bs, 2)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11], [4, 6, 8, 10]], np.int32)
    base = np.array([6, 0, -1], np.int32)  # lane 1: empty pool; lane 2: padding
    toks = np.array([11, 4, 0], np.int32)
    wshape = (jc.num_layers, 3, W, jc.num_kv_heads, jc.head_dim)
    jwk = jnp.zeros(wshape, jnp.float32)
    jwv = jnp.zeros(wshape, jnp.float32)
    twk, twv = torch.zeros(wshape), torch.zeros(wshape)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tk, tv, ttab, tbase = _t(k0, v0, tables, base)
    tcache = {"k": tk, "v": tv}
    pos = base.copy()

    @jax.jit
    def jax_step(p, toks, pos, cache, tables, base, wk, wv, step):
        # paged history mode, Pallas kernel in interpret mode
        return jl.forward_window(
            p, jc, toks, pos, ("paged", cache, tables, None, True), base, wk, wv, step
        )

    for step in range(W):
        jlog, jwk, jwv = jax_step(
            jp, jnp.asarray(toks), jnp.asarray(pos), jcache, jnp.asarray(tables),
            jnp.asarray(base), jwk, jwv, jnp.int32(step),
        )
        tlog, twk, twv = tl.forward_window(
            tp, tc, torch.from_numpy(toks), torch.from_numpy(pos), tcache, ttab, tbase,
            twk, twv, step,
        )
        np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], atol=ATOL, rtol=0)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    np.testing.assert_allclose(twk.numpy(), np.asarray(jwk), atol=ATOL, rtol=0)
    jcache = jl.flush_window(jcache, jnp.asarray(tables), jnp.asarray(base), jwk, jwv, 14)
    tcache = tl.flush_window(tcache, ttab, tbase, twk, twv, 14)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]), atol=ATOL, rtol=0)


def test_init_params_shapes_and_seed():
    c = tl.LLAMA_PRESETS["tiny"]
    a, b = tl.init_params(c, seed=5), tl.init_params(c, seed=5)
    jc = jl.LLAMA_PRESETS["tiny"]
    jshapes = jax.tree.map(lambda x: x.shape,
                           jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jc)))
    for name, p in a.named_parameters():
        parts = name.split(".")
        ref = jshapes[parts[0]] if len(parts) == 1 else jshapes["layers"][parts[1]]
        assert tuple(p.shape) == tuple(ref), name
        torch.testing.assert_close(p, dict(b.named_parameters())[name], atol=0, rtol=0)
    assert a.layers["wq"].dtype == torch.bfloat16
    assert a.layers["attn_norm"].dtype == torch.float32
