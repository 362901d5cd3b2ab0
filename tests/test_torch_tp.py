"""The port's tensor parallelism against the JAX package on the conftest's
CPU mesh (``dp=1, tp=2``), with the port's two ranks co-located on the CPU,
on the tiny preset in fp32 (H 4 over KVH 2: one kv head per rank):

1. every leaf of ``shard_params`` equal to JAX's addressable shard r, for
   the bf16 tree, the ``"int8"`` tree (and the sharded quantization of the
   sharded bf16 tree, bit for bit) and a ``qkv_bias`` + ``tie_embeddings``
   config; safetensors loaded straight onto a mesh equal to the same;
2. ``paged_decode_attention_sharded_plain`` against JAX's
   ``paged_attention_decode_sharded`` in interpret mode;
3. ``forward_chunk``, ``forward_window`` then ``flush_window`` and
   ``forward`` against JAX's on the mesh, logits and pools;
4. greedy streams of the port's tp engine equal to JAX's mesh engine and to
   the port's unsharded engine: plain weights, ``"int8"``, speculation at
   k = 2, and a host-tier spill and re-hit;
5. seal crcs equal to JAX's ``page_checksums`` of the same head-ordered
   pages;
6. the refusals: int8 KV on a mesh, tp not dividing the heads, dp/pp/sp/ep
   > 1, a mesh larger than its devices; MoE and ``"int8-all"`` on tp, once
   refused, build and serve (``test_torch_tp_int8.py`` and
   ``test_torch_tp_moe.py`` hold their numbers).

fp32 numbers at rtol 1e-5 and atol 1e-5 (sums split over two ranks differ
from the unsharded order by fp32 round-off); token streams exactly equal.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops.pallas.paged_attention import paged_attention_decode_sharded
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel.mesh import kv_cache_sharding as jax_kv_cache_sharding
from dynamo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dynamo_tpu.runtime import integrity as jintegrity
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.cli.run import build_engine, build_parser
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.weights import params_from_hf, params_from_numpy
from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops.paged_attention import paged_decode_attention_sharded_plain
from dynamo_tpu_torch.parallel import collectives
from dynamo_tpu_torch.parallel.mesh import MeshConfig, kv_cache_sharding, make_mesh
from dynamo_tpu_torch.runtime.engine import Context

from .test_engine_jax import CFG, ENGINE_CFG
from .test_engine_multichip import PROMPTS
from .torch_checkpoints import hf_tensors

TOL = dict(rtol=1e-5, atol=1e-5)
TP = 2


def _tcfg(jcfg):
    return tl.LlamaConfig(dtype=torch.float32, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tl.LlamaConfig)
        if f.name != "dtype"})


TCFG = _tcfg(CFG)
# the port's engine settings of ENGINE_CFG (the JAX engine tests' engine)
ENGINE = dict(max_slots=ENGINE_CFG.max_slots, kv_block_size=ENGINE_CFG.kv_block_size,
              max_model_len=ENGINE_CFG.max_model_len)
# a pool too small for two waves: the second evicts the first's sealed
# blocks to the host tier and the third re-hits them (tests/test_torch_engine.py)
HOST_TIER = dict(max_slots=2, kv_block_size=8, max_model_len=48, num_kv_blocks=8,
                 prefill_chunk=16, decode_steps=2, host_cache_blocks=16)
REPEATED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]
EVICTING = [[2, 7, 1, 8, 2, 8, 1, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5],
            [1, 4, 1, 4, 2, 1, 3, 5, 6, 2, 3, 7, 3, 0, 9, 5, 7]]
REP_PROMPT = ([3, 1, 4, 1, 5, 9, 2, 6] * 4)[:24]  # drafts for speculation


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(JaxMeshConfig(tp=TP))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(MeshConfig(tp=TP), ["cpu"] * TP)


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), CFG)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _jax_shard(tree, jmesh, r: int):
    """Rank r's addressable shard of every leaf, as numpy."""
    dev = jmesh.devices.reshape(-1)[r]

    def leaf(a):
        (s,) = [s for s in a.addressable_shards if s.device == dev]
        return np.asarray(s.data)

    return jax.tree.map(leaf, tree)


def _assert_shards_equal(sharded: "tl.ShardedParams", jax_tree, jmesh, cfg):
    rc = tl.rank_config(cfg, TP)
    for r, shard in enumerate(sharded.shards):
        want = dict(params_from_numpy(_jax_shard(jax_tree, jmesh, r), rc).named_parameters())
        got = dict(shard.named_parameters())
        assert set(got) == set(want)
        for name, x in got.items():
            assert tuple(x.shape) == tuple(want[name].shape), name
            assert torch.equal(x, want[name]), (r, name)


# -- 1. the params ----------------------------------------------------------------


def test_shard_params_equal_jax_addressable_shards(weights, jmesh, tmesh):
    jparams, tparams = weights
    jsharded = jax.device_put(jparams, jl.param_shardings(CFG, jmesh))
    _assert_shards_equal(tl.shard_params(tparams, TCFG, tmesh), jsharded, jmesh, TCFG)


def test_shard_int8_params_equal_jax_addressable_shards(weights, jmesh, tmesh):
    """The ``"int8"`` tree: the whole tree quantized, then sharded as
    ``quantized_param_shardings`` shards it; and the port's quantization of
    the sharded bf16 tree (row-parallel scales from the whole contracted
    axis) gives the same leaves bit for bit."""
    jparams, tparams = weights
    jq = jl.quantize_params_int8(jparams, CFG)
    jsharded = jax.device_put(jq, jl.quantized_param_shardings(CFG, jmesh))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), TCFG)
    _assert_shards_equal(tl.shard_params(tq, TCFG, tmesh), jsharded, jmesh, TCFG)
    _assert_shards_equal(tl.quantize_params_int8(tl.shard_params(tparams, TCFG, tmesh), TCFG),
                         jsharded, jmesh, TCFG)


def test_shard_params_qkv_bias_tied_embeddings(jmesh, tmesh):
    cfg = dataclasses.replace(CFG, qkv_bias=True, tie_embeddings=True)
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(2), cfg))
    rng = np.random.default_rng(2)
    for b in ("bq", "bk", "bv"):  # init zeros them: give them values
        tree["layers"][b] = rng.normal(size=tree["layers"][b].shape).astype(np.float32)
    tcfg = _tcfg(cfg)
    jsharded = jax.device_put(jax.tree.map(jnp.asarray, tree), jl.param_shardings(cfg, jmesh))
    sharded = tl.shard_params(params_from_numpy(tree, tcfg), tcfg, tmesh)
    assert "lm_head" not in dict(sharded.shards[0].named_parameters())
    _assert_shards_equal(sharded, jsharded, jmesh, tcfg)


@pytest.mark.parametrize("int8", [False, True])
def test_safetensors_load_onto_mesh_equals_sharded_load(tmesh, int8):
    """Each checkpoint tensor sliced to its ranks as it is read equals the
    whole load sharded afterwards (int8: the whole matrix quantized)."""
    tensors = hf_tensors(TCFG, 7)
    whole = params_from_hf(tensors, TCFG, device="cpu", int8=int8)
    direct = params_from_hf(tensors, TCFG, int8=int8, mesh=tmesh)
    want = tl.shard_params(whole, TCFG, tmesh)
    for a, b in zip(direct.shards, want.shards):
        for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(x, y), n


def test_random_init_on_mesh_equals_sharded_init(tmesh):
    """One seed, one device: the tp draw holds the unsharded draw's weights."""
    want = tl.shard_params(tl.init_params(TCFG, seed=5), TCFG, tmesh)
    got = tl.init_params(TCFG, seed=5, mesh=tmesh)
    for a, b in zip(got.shards, want.shards):
        for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(x, y), n


# -- 2. the sharded decode kernel ----------------------------------------------------


@pytest.mark.parametrize("lengths", [[9, 17, 1, 0], [16, 32, 5, 24]])
def test_sharded_plain_matches_jax_sharded_kernel(jmesh, tmesh, lengths):
    s, h, kvh, d, bs, mb = 4, 8, 2, 32, 8, 4
    rng = np.random.default_rng(3)
    n_blocks = s * mb + 3
    k = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    v = rng.normal(size=(n_blocks, bs, kvh, d)).astype(np.float32)
    q = rng.normal(size=(s, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: s * mb].reshape(s, mb).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    qs = jax.device_put(q, NamedSharding(jmesh, P(None, "tp", None)))
    ks = jax.device_put(k, NamedSharding(jmesh, P(None, None, "tp", None)))
    vs = jax.device_put(v, NamedSharding(jmesh, P(None, None, "tp", None)))
    want = paged_attention_decode_sharded(qs, ks, vs, jnp.asarray(tables), jnp.asarray(lens),
                                          mesh=jmesh, interpret=True, return_stats=True)
    t = torch.from_numpy
    rule = kv_cache_sharding(tmesh)
    pools = [[rule.shard(t(x)[None], r)[0].contiguous() for r in range(TP)] for x in (k, v)]
    got = paged_decode_attention_sharded_plain(t(q), *pools, t(tables), t(lens), mesh=tmesh,
                                               return_stats=True)
    assert [o.shape for o in got[0]] == [(s, h // TP, d)] * TP
    for g, w in zip(got, want):
        np.testing.assert_allclose(torch.cat(g, dim=1).numpy(), np.asarray(w), **TOL)


# -- 3. the forward functions ----------------------------------------------------------


def _whole_pool(pools, name):
    return torch.cat([p[name] for p in pools], dim=3).numpy()


def test_forward_chunk_window_flush_equal_jax_on_mesh(weights, jmesh, tmesh):
    jparams, tparams = weights
    L, kvh, d = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
    n_blocks, bs, b, c, w = 24, 8, 3, 11, 2
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, CFG.vocab_size, size=(b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    positions[1, 7:] = -1  # a shorter lane
    positions[2] += 5  # a lane with pool history (its first 5 positions below)
    tables = rng.permutation(n_blocks)[: b * 4].reshape(b, 4).astype(np.int32)

    psharded = jax.device_put(jparams, jl.param_shardings(CFG, jmesh))
    jcache = jax.device_put(jl.make_kv_cache(CFG, n_blocks, bs), jax_kv_cache_sharding(jmesh))
    sp = tl.shard_params(tparams, TCFG, tmesh)
    tcache = tl.make_kv_cache(TCFG, n_blocks, bs, mesh=tmesh)
    assert [p["k"].shape for p in tcache] == [(L, n_blocks, bs, kvh // TP, d)] * TP
    t = torch.from_numpy

    # the history of lane 2 first (a chunk at positions 0..4), then the chunk
    hist_pos = np.full((b, 5), -1, np.int32)
    hist_pos[2] = np.arange(5)
    jl_out, jcache = jl.forward_chunk(psharded, CFG, jnp.asarray(tokens[:, :5]),
                                      jnp.asarray(hist_pos), jcache, jnp.asarray(tables))
    tl_out, _ = tl.forward_chunk(sp, TCFG, t(tokens[:, :5]), t(hist_pos), tcache, t(tables))
    jl_out, jcache = jl.forward_chunk(psharded, CFG, jnp.asarray(tokens), jnp.asarray(positions),
                                      jcache, jnp.asarray(tables))
    tl_out, _ = tl.forward_chunk(sp, TCFG, t(tokens), t(positions), tcache, t(tables))
    keep = positions >= 0
    np.testing.assert_allclose(tl_out.numpy()[keep], np.asarray(jl_out)[keep], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_whole_pool(tcache, name), np.asarray(jcache[name]), **TOL)

    # two decode steps over the pool plus a window, then the flush
    base = positions.max(axis=1) + 1
    base[1] = -1  # a padding lane
    pos = base.copy()
    jwk = jnp.zeros((L, b, w, kvh, d), jnp.float32)
    jwv = jnp.zeros_like(jwk)
    rc = tl.rank_config(TCFG, TP)
    twk = [torch.zeros(L, b, w, rc.num_kv_heads, d) for _ in range(TP)]
    twv = [x.clone() for x in twk]
    toks = tokens[:, -1]
    for slot in range(w):
        jlog, jwk, jwv = jl.forward_window(
            psharded, CFG, jnp.asarray(toks), jnp.asarray(pos),
            ("paged", jcache, jnp.asarray(tables), jmesh, True), jnp.asarray(base), jwk, jwv,
            jnp.asarray(slot, jnp.int32))
        tlog, _, _ = tl.forward_window(sp, TCFG, t(toks), t(pos), tcache, t(tables), t(base),
                                       twk, twv, slot)
        live = pos >= 0
        np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live], **TOL)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
    jcache = jl.flush_window(jcache, jnp.asarray(tables), jnp.asarray(base), jwk, jwv, 31)
    tl.flush_window(tcache, t(tables), t(base), twk, twv, 31)
    for name in ("k", "v"):
        np.testing.assert_allclose(_whole_pool(tcache, name), np.asarray(jcache[name]), **TOL)

    # forward (scatter, then attend) one more token per lane
    fpos = np.where(base >= 0, base + w, -1).astype(np.int32)[:, None]
    jf, _ = jl.forward(psharded, CFG, jnp.asarray(toks[:, None]), jnp.asarray(fpos), jcache,
                       jnp.asarray(tables), use_pallas=False)
    tf, _ = tl.forward(sp, TCFG, t(toks[:, None]), t(fpos), tcache, t(tables))
    live = fpos[:, 0] >= 0
    np.testing.assert_allclose(tf.numpy()[live], np.asarray(jf)[live], **TOL)


def test_collectives_on_colocated_ranks():
    """fp32 sums rounded once to the parts' dtype, one tensor for ranks on
    one device; the gather in rank order; calls and bytes counted."""
    collectives.reset_counts()
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32)).bfloat16()
             for _ in range(TP)]
    out = collectives.all_reduce(parts)
    want = (parts[0].float() + parts[1].float()).bfloat16()
    assert all(o is out[0] for o in out) and torch.equal(out[0], want)
    assert collectives.all_reduce(parts[:1])[0] is parts[0]  # one rank: no collective
    g = collectives.all_gather(parts, dim=-1)
    assert torch.equal(g, torch.cat(parts, dim=-1))
    assert collectives.all_reduce.calls == 1 and collectives.all_gather.calls == 1
    assert collectives.all_reduce.bytes == 2 * 3 * 64 * 2
    # row-parallel partials arrive in fp32, unrounded: one rounding in all
    f32 = [p.float() * 1.001 for p in parts]
    out = collectives.all_reduce(f32, torch.bfloat16)
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], (f32[0] + f32[1]).bfloat16())
    assert torch.equal(f32[0], parts[0].float() * 1.001)  # the parts are not written


def test_matw_partial_is_the_unrounded_product():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).bfloat16()
    y = tl.matw_partial(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float(), rtol=1e-6, atol=1e-6)
    assert torch.equal(y.bfloat16(), tl.matw(x, w))
    q, s_ = tl.quantize_matrix(w.float())
    w8 = tl.Int8Weight(q.contiguous(), s_)
    y8 = tl.matw_partial(x, w8)  # x @ q rounded to x's dtype, scaled, not rounded again
    assert y8.dtype == torch.float32
    assert torch.equal(y8, (x.float() @ q.float().T).bfloat16().float() * s_)


# -- 4. the engine ----------------------------------------------------------------------


async def _tokens(engine, ctx_cls, prompt, max_tokens):
    req = {"token_ids": list(prompt),
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
           "sampling_options": {"temperature": 0.0}}
    toks = []
    async for item in engine.generate(ctx_cls(req)):
        if item.data:
            toks.extend(item.data.get("token_ids", []))
    return toks


def _wave(engine, ctx_cls, prompts, n):
    async def go():
        return await asyncio.gather(*[_tokens(engine, ctx_cls, p, n) for p in prompts])
    return asyncio.run(go())


def _drive(engine, ctx_cls, mode):
    if mode != "host_tier":
        prompts = PROMPTS + [REP_PROMPT] if mode == "spec_k2" else PROMPTS
        return _wave(engine, ctx_cls, prompts, 10)
    out = _wave(engine, ctx_cls, [REPEATED], 6) + _wave(engine, ctx_cls, EVICTING, 6)
    deadline = time.monotonic() + 30  # spills reach the host pool off the step
    while len(engine.host_pool) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    return out + _wave(engine, ctx_cls, [REPEATED], 6)


MODES = {"plain": dict(ENGINE), "int8": dict(ENGINE, quantize="int8"),
         "spec_k2": dict(ENGINE, spec_k=2), "host_tier": HOST_TIER}


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_engine_streams_equal_jax_mesh_and_unsharded(weights, jmesh, tmesh, mode):
    jparams, tparams = weights
    cfg = MODES[mode]
    jeng = JaxServingEngine(CFG, jax.device_put(jparams, jl.param_shardings(CFG, jmesh)),
                            JaxEngineConfig(**cfg), mesh=jmesh)
    try:
        want = _drive(jeng, JaxContext, mode)
    finally:
        jeng.close()
    tp_eng = TorchServingEngine(TCFG, tl.shard_params(tparams, TCFG, tmesh),
                                EngineConfig(**cfg), mesh=tmesh)
    one = TorchServingEngine(TCFG, tparams, EngineConfig(**cfg), device="cpu")
    try:
        got = _drive(tp_eng, Context, mode)
        unsharded = _drive(one, Context, mode)
        m = tp_eng.metrics_snapshot()
    finally:
        tp_eng.close()
        one.close()
    assert got == want
    assert got == unsharded
    assert m["tensor_parallel_size"] == TP
    if mode == "int8":
        assert tp_eng.params_decode.int8 and not tp_eng.params.int8
    if mode == "spec_k2":
        assert m["verify_dispatches"] > 0 and m["spec_drafted_tokens"] > 0
    if mode == "host_tier":
        assert m["host_cache_hits"] > 0


def test_tp_host_tier_pages_interchangeable_with_unsharded(weights, tmesh):
    """A tp engine's spilled pages are the global pool's pages: injected
    into an unsharded engine they land bit for bit, and back."""
    _, tparams = weights
    tp_eng = TorchServingEngine(TCFG, tparams, EngineConfig(**HOST_TIER), mesh=tmesh)
    one = TorchServingEngine(TCFG, tparams, EngineConfig(**HOST_TIER), device="cpu")
    try:
        _drive(tp_eng, Context, "host_tier")
        pages = tp_eng.pages([1, 4])
        assert pages["k"].shape[3] == TCFG.num_kv_heads
        one.inject_blocks([2, 5], pages["k"], pages["v"])
        assert torch.equal(one.pages([2, 5])["k"], pages["k"])
        tp_eng.inject_blocks([6, 7], pages["k"], pages["v"])
        assert torch.equal(tp_eng.pages([6, 7])["v"], pages["v"])
        assert torch.equal(tp_eng.cache[1]["v"][:, [6, 7]], pages["v"][:, :, :, 1:])
    finally:
        tp_eng.close()
        one.close()


# -- 5. seal checksums -------------------------------------------------------------------


def test_tp_seal_checksums_equal_jax_page_checksums(weights, tmesh):
    """Every block the tp engine sealed carries the crc that the JAX
    ``page_checksums`` gives for the same pages in global head order (the
    rank pools concatenated along the kv heads)."""
    _, tparams = weights
    eng = TorchServingEngine(TCFG, tparams, EngineConfig(**ENGINE, prefill_chunk=16),
                             mesh=tmesh)
    try:
        toks = _wave(eng, Context, [list(range(3, 27))], 12)[0]
        assert len(toks) == 12
        bids = sorted(eng.allocator._crc_of)
        assert len(bids) >= 4 and eng.crc_blocks >= 4
        got = [eng.allocator.crc_of_block(bid) for bid in bids]
        pages = [np.concatenate([p[n][:, bids].numpy() for p in eng.cache], axis=3)
                 for n in ("k", "v")]
        assert got == jintegrity.page_checksums(*pages)
    finally:
        eng.close()


# -- 6. what a mesh refuses, and the launcher -------------------------------------------


@pytest.mark.parametrize("axis", ["dp", "pp", "sp", "ep"])
def test_mesh_other_axes_refused(axis):
    with pytest.raises(ValueError, match="ROADMAP A7"):
        make_mesh(MeshConfig(tp=2, **{axis: 2}), ["cpu"] * 4)


def test_mesh_larger_than_devices_refused():
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 2"):
        make_mesh(MeshConfig(tp=4), ["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
            make_mesh(MeshConfig(tp=2))


def test_engine_refusals_on_mesh(weights, tmesh):
    """What a mesh still refuses raises with its ROADMAP id (int8 KV as the
    JAX engine refuses it); ``"int8-all"`` and the MoE family, once refused
    (A10, A9), build and serve a stream."""
    _, tparams = weights
    with pytest.raises(ValueError, match="kv_dtype='int8'"):
        TorchServingEngine(TCFG, tparams, EngineConfig(**ENGINE, kv_dtype="int8"), mesh=tmesh)
    mesh4 = make_mesh(MeshConfig(tp=4), ["cpu"] * 4)  # 4 ranks over 2 kv heads
    with pytest.raises(ValueError, match="ROADMAP A11"):
        TorchServingEngine(TCFG, tparams, EngineConfig(**ENGINE), mesh=mesh4)
    with pytest.raises(ValueError, match="ROADMAP A11"):
        tl.shard_params(tparams, TCFG, mesh4)
    with pytest.raises(ValueError, match="ROADMAP A7"):
        make_mesh(MeshConfig(tp=2, ep=2), ["cpu"] * 4)
    moe = dataclasses.replace(tl.LLAMA_PRESETS["tiny-moe"], dtype=torch.float32)
    for cfg, params, quantize in ((TCFG, tparams, "int8-all"), (moe, tl.init_params(moe), None)):
        eng = TorchServingEngine(cfg, params, EngineConfig(**ENGINE, quantize=quantize),
                                 mesh=tmesh)
        try:
            assert isinstance(eng.params, tl.ShardedParams)
            assert eng.params.int8 == (quantize == "int8-all")
            assert len(_wave(eng, Context, PROMPTS[:1], 4)[0]) == 4
        finally:
            eng.close()


def test_tp_engine_watchdog_off_checksums_on(weights, tmesh):
    """As the JAX engine on a mesh: seal checksums on, the output watchdog
    off (no extra dispatch argument)."""
    _, tparams = weights
    eng = TorchServingEngine(TCFG, tparams, EngineConfig(**ENGINE), mesh=tmesh)
    try:
        assert eng._integrity is not None and not eng._watchdog and eng._wd_steady() == ()
    finally:
        eng.close()


def test_launcher_tensor_parallel_size(model_dir):
    flags = build_parser().parse_args(["--model-path", model_dir, "--device", "cpu",
                                       "--tensor-parallel-size", "2"])
    chat, _, name, core = build_engine("torch", flags)
    try:
        assert core.mesh is not None and core.mesh.tp == 2
        assert [p["k"].shape[3] for p in core.cache] == [core.model_config.num_kv_heads // 2] * 2

        async def go():
            req = ChatCompletionRequest.from_dict({"model": name, "max_tokens": 4, "messages": [
                {"role": "user", "content": "hi"}]})
            return [i.data async for i in chat.generate(Context(req)) if i.data]

        items = asyncio.run(go())
        assert items[-1]["choices"][0]["finish_reason"]
    finally:
        core.close()
