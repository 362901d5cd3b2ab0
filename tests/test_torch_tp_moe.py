"""The mixtral family on a tp mesh against the port's unsharded MoE layer
and the JAX package on the conftest's CPU mesh (``dp=1, tp=2``), the port's
two ranks co-located on the CPU, in fp32:

1. ``moe_mlp(..., partial=True)`` on each rank's F/tp slice of the expert
   stacks, the partials summed, against the unsharded ``moe_mlp`` and JAX's
   ``moe_mlp`` on the mesh (GSPMD), plain and int8 stacks, with capacity
   drops and padding;
2. ``tiny-moe``'s ``forward_chunk`` (with pool history) and
   ``forward_window`` (paged history plus the window) of the sharded
   weights against JAX's on the mesh with the same weights;
3. greedy streams of the port's tp engine equal to JAX's mesh engine and to
   the port's unsharded engine, plain and in ``"int8-all"``; the tree
   drawn onto the ranks equal to the unsharded draw, sharded; a mixtral
   safetensors checkpoint read onto the ranks (one expert slice at a time)
   equal to its whole load, sharded, in bf16 and int8.

Numbers at atol 1e-4 (``test_torch_moe.py``'s; partials summed over two
ranks add in another order than the unsharded sums); token streams exactly
equal.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel.mesh import kv_cache_sharding as jax_kv_cache_sharding
from dynamo_tpu.parallel.mesh import logical_to_sharding as jax_logical_to_sharding
from dynamo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.safetensors import hf_tensors
from dynamo_tpu_torch.engine_torch.weights import config_from_card, params_from_hf, params_from_numpy
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import moe as tmoe
from dynamo_tpu_torch.ops.int8_matmul import Int8Weight
from dynamo_tpu_torch.parallel import collectives
from dynamo_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dynamo_tpu_torch.runtime.engine import Context

from .test_torch_moe import MIXTRAL_CONFIG, _configs, _mixtral_tensors, _numpy_tree
from .torch_checkpoints import write_safetensors

ATOL = 1e-4
TP = 2
E, F, X = 32, 64, 4
ENGINE = dict(max_slots=2, kv_block_size=8, max_model_len=48, prefill_chunk=16,
              decode_steps=2)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 4, 5, 9, 0, 4]]


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(JaxMeshConfig(tp=TP))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(MeshConfig(tp=TP), ["cpu"] * TP)


@pytest.fixture(scope="module")
def tiny_moe():
    jc, tc = _configs()
    jp = _numpy_tree(jc, 21)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc)


# -- 1. the MoE layer's partials ---------------------------------------------------


def _layer_params(seed):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    return {"router": w(E, X), "w_gate": w(X, E, F), "w_up": w(X, E, F), "w_down": w(X, F, E)}


def _rank_stacks(p, r, int8):
    """Rank r's slice of F: gate/up columns, down rows (int8: each whole
    expert quantized first, its q sliced, the down scales whole)."""
    f = F // TP
    cols, rows = slice(r * f, (r + 1) * f), slice(r * f, (r + 1) * f)
    out = {"router": torch.from_numpy(p["router"])}
    for name in ("w_gate", "w_up", "w_down"):
        w = torch.from_numpy(p[name])
        if not int8:
            out[name] = w[:, :, cols] if name != "w_down" else w[:, rows, :]
            continue
        q, s = tl.quantize_matrix(w)  # q [X, out, in], s [X, out]
        if name == "w_down":
            out[name] = Int8Weight(q[:, :, rows].contiguous(), s)
        else:
            out[name] = Int8Weight(q[:, cols, :].contiguous(), s[:, cols].contiguous())
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("factor", [8.0, 0.5], ids=["ample", "drops"])
def test_moe_partials_sum_to_the_unsharded_layer(jmesh, int8, factor):
    p = _layer_params(31)
    kw = dict(hidden_size=E, num_experts=X, top_k=2, capacity_factor=factor)
    whole_cfg = tmoe.MoeConfig(intermediate_size=F, **kw)
    rank_cfg = tmoe.MoeConfig(intermediate_size=F // TP, **kw)
    x = torch.from_numpy(np.random.default_rng(32).normal(size=(3, 7, E)).astype(np.float32))
    valid = torch.ones((3, 7), dtype=torch.bool)
    valid[2, 4:] = False
    whole = {k: torch.from_numpy(v) for k, v in p.items()}
    if int8:
        for name in ("w_gate", "w_up", "w_down"):
            q, s = tl.quantize_matrix(whole[name])
            whole[name] = Int8Weight(q.contiguous(), s)
    want, aux = tmoe.moe_mlp(whole, whole_cfg, x, token_valid=valid)
    if factor < 1:
        assert float(aux["dropped_fraction"]) > 0
    parts = [tmoe.moe_mlp(_rank_stacks(p, r, int8), rank_cfg, x, token_valid=valid,
                          with_aux=False, partial=True)[0] for r in range(TP)]
    assert all(t.dtype == torch.float32 for t in parts)
    got = collectives.all_reduce(parts)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    if int8:
        return
    # JAX's layer with the FFN width sharded over tp (GSPMD sums the partials)
    axes = jmoe.moe_param_logical_axes()
    jp = {k: jax.device_put(jnp.asarray(v), jax_logical_to_sharding(jmesh, *axes[k]))
          for k, v in p.items()}
    jcfg = jmoe.MoeConfig(intermediate_size=F, **kw)
    jout, _ = jax.jit(lambda q, y, m: jmoe.moe_mlp(q, jcfg, y, token_valid=m))(
        jp, jnp.asarray(x.numpy()), jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), atol=ATOL, rtol=0)


def test_moe_partial_of_a_bf16_stack_is_unrounded():
    """A bf16 stack's partial keeps ``w_down``'s output in fp32 (the
    unsharded layer rounds it to bf16 before the combine)."""
    p = _layer_params(33)
    cfg = tmoe.MoeConfig(hidden_size=E, intermediate_size=F, num_experts=X, top_k=2,
                         capacity_factor=8.0)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16 if k != "router" else torch.float32)
          for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(34).normal(size=(2, 5, E))).bfloat16()
    part, _ = tmoe.moe_mlp(bf, cfg, x, with_aux=False, partial=True)
    out, _ = tmoe.moe_mlp(bf, cfg, x, with_aux=False)
    assert part.dtype == torch.float32 and out.dtype == torch.bfloat16
    assert not torch.equal(part, part.bfloat16().float())
    # each routed expert's output rounded once in the unsharded layer: a
    # bf16 ulp of each term, at most 2^-7 of the largest output
    diff = (part.bfloat16().float() - out.float()).abs().max()
    assert diff <= 2.0 ** -7 * out.float().abs().max()


# -- 2. the forwards ---------------------------------------------------------------


def _whole_pool(pools, name):
    return torch.cat([p[name] for p in pools], dim=3).numpy()


def test_tiny_moe_forward_chunk_and_window_equal_jax_on_mesh(tiny_moe, jmesh, tmesh):
    jc, tc, jp, tparams = tiny_moe
    L, kvh, d = jc.num_layers, jc.num_kv_heads, jc.head_dim
    n_blocks, bs, b, c, w = 16, 4, 2, 5, 1
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11]], np.int32)
    tokens = np.array([[3, 17, 42, 5, 9], [8, 1, 2, 0, 0]], np.int32)
    rng = np.random.default_rng(35)
    k0 = rng.normal(size=(L, n_blocks, bs, kvh, d)).astype(np.float32)
    v0 = rng.normal(size=(L, n_blocks, bs, kvh, d)).astype(np.float32)
    pos = np.stack([np.arange(s, s + c) for s in (6, 3)]).astype(np.int32)  # with history
    pos[1, 3:] = -1
    psharded = jax.device_put(jp, jl.param_shardings(jc, jmesh))
    jcache = jax.device_put({"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                            jax_kv_cache_sharding(jmesh))
    sp = tl.shard_params(tparams, tc, tmesh)
    assert sp.shards[0].layers["w_gate"].shape == (L, tc.num_experts, tc.hidden_size,
                                                   tc.intermediate_size // TP)
    h = kvh // TP
    t = torch.from_numpy
    tcache = [{"k": t(k0[:, :, :, r * h:(r + 1) * h].copy()),
               "v": t(v0[:, :, :, r * h:(r + 1) * h].copy())} for r in range(TP)]
    jlog, jcache = jl.forward_chunk(psharded, jc, jnp.asarray(tokens), jnp.asarray(pos), jcache,
                                    jnp.asarray(tables))
    tlog, _ = tl.forward_chunk(sp, tc, t(tokens), t(pos), tcache, t(tables))
    keep = pos >= 0
    np.testing.assert_allclose(tlog.numpy()[keep], np.asarray(jlog)[keep], atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(_whole_pool(tcache, name), np.asarray(jcache[name]),
                                   atol=ATOL, rtol=0)

    # a decode step over the pool plus the window, a padding lane
    base = np.array([11, -1], np.int32)
    cur = base.copy()
    jwk = jnp.zeros((L, b, w, kvh, d), jnp.float32)
    jwv = jnp.zeros_like(jwk)
    twk = [torch.zeros(L, b, w, h, d) for _ in range(TP)]
    twv = [x.clone() for x in twk]
    toks = tokens[:, 2].copy()
    for slot in range(w):
        jlog, jwk, jwv = jl.forward_window(
            psharded, jc, jnp.asarray(toks), jnp.asarray(cur),
            ("paged", jcache, jnp.asarray(tables), jmesh, True), jnp.asarray(base), jwk, jwv,
            jnp.asarray(slot, jnp.int32))
        tlog, _, _ = tl.forward_window(sp, tc, t(toks), t(cur), tcache, t(tables), t(base),
                                       twk, twv, slot)
        np.testing.assert_allclose(tlog.numpy()[:1], np.asarray(jlog)[:1], atol=ATOL, rtol=0)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        cur = np.where(cur >= 0, cur + 1, -1).astype(np.int32)


# -- 3. the engines ------------------------------------------------------------------


async def _tokens(engine, ctx_cls, prompt, max_tokens):
    req = {"token_ids": list(prompt),
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
           "sampling_options": {"temperature": 0.0}}
    toks = []
    async for item in engine.generate(ctx_cls(req)):
        if item.data:
            toks.extend(item.data.get("token_ids", []))
    return toks


def _drive(engine, ctx_cls, n=8):
    async def wave():
        return await asyncio.gather(*[_tokens(engine, ctx_cls, p, n) for p in PROMPTS])

    try:
        return asyncio.run(wave())
    finally:
        engine.close()


@pytest.mark.parametrize("mode", [None, "int8-all"], ids=["plain", "int8-all"])
def test_tiny_moe_tp_engine_streams_equal_jax_mesh_and_unsharded(tiny_moe, jmesh, tmesh, mode):
    jc, tc, jp, tparams = tiny_moe
    want = _drive(JaxServingEngine(jc, jax.device_put(jp, jl.param_shardings(jc, jmesh)),
                                   JaxEngineConfig(quantize=mode, **ENGINE), mesh=jmesh),
                  JaxContext)
    tp_eng = TorchServingEngine(tc, tl.shard_params(tparams, tc, tmesh),
                                EngineConfig(quantize=mode, **ENGINE), mesh=tmesh)
    assert tp_eng.params.int8 == (mode == "int8-all")
    got = _drive(tp_eng, Context)
    unsharded = _drive(TorchServingEngine(tc, tparams, EngineConfig(quantize=mode, **ENGINE),
                                          device="cpu"), Context)
    assert got == want
    assert got == unsharded
    assert all(len(x) == 8 for x in got)


def test_tiny_moe_random_draws_onto_a_mesh(tmesh):
    """bf16 and int8 tiny-moe drawn onto the ranks hold the unsharded
    draw's slices: every expert at F/tp, the router and the row-parallel
    scales whole on each rank."""
    cfg = dataclasses.replace(tl.LLAMA_PRESETS["tiny-moe"], dtype=torch.bfloat16)
    for init in (tl.init_params, tl.init_params_int8):
        whole = init(cfg, seed=6)
        sharded = init(cfg, seed=6, mesh=tmesh)
        want = tl.shard_params(whole, cfg, tmesh)
        for a, b in zip(sharded.shards, want.shards):
            for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
                assert torch.equal(x, y), n
    s0 = sharded.shards[0].layers
    assert s0["w_gate_q"].shape == (cfg.num_layers, 4, cfg.intermediate_size // TP, 64)
    assert s0["w_down_q"].shape == (cfg.num_layers, 4, 64, cfg.intermediate_size // TP)
    assert torch.equal(s0["w_down_s"], whole.layers["w_down_s"])
    assert torch.equal(s0["moe_router"], whole.layers["moe_router"])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_mixtral_checkpoint_loads_onto_a_mesh_equal_to_sharded_load(tmesh, tmp_path, int8):
    """A mixtral safetensors file under the HF names, read onto the ranks
    (each expert's matrix sliced to F/tp as it is read; int8: quantized
    whole, then sliced) equals its whole load, sharded, bit for bit."""
    card = ModelDeploymentCard(display_name="m", model_config=MIXTRAL_CONFIG)
    cfg = config_from_card(card, dtype=torch.bfloat16)
    write_safetensors(str(tmp_path / "model.safetensors"), _mixtral_tensors(cfg, 15))
    tensors = hf_tensors(str(tmp_path))
    direct = params_from_hf(tensors, cfg, int8=int8, mesh=tmesh)
    want = tl.shard_params(params_from_hf(tensors, cfg, int8=int8), cfg, tmesh)
    for a, b in zip(direct.shards, want.shards):
        got, ref = dict(a.named_parameters()), dict(b.named_parameters())
        assert set(got) == set(ref)
        for n, x in got.items():
            assert torch.equal(x, ref[n]), n
    L, X, E, F = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size // TP
    layers = direct.shards[1].layers
    want_shape = {"w_gate_q": (L, X, F, E), "w_down_q": (L, X, E, F)} if int8 else {
        "w_gate": (L, X, E, F), "w_down": (L, X, F, E)}
    for n, shape in want_shape.items():
        assert layers[n].shape == shape, n
