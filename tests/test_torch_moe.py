"""The port's MoE layer and mixtral family against the JAX package's, on the
CPU in fp32.

Seeded numpy inputs go through ``dynamo_tpu.ops.moe`` and
``dynamo_tpu_torch.ops.moe``: outputs and aux agree to atol 1e-4 (fp32 on
both sides, sums in other orders; the tolerance of ``test_torch_model.py``)
at ample, default and tight capacity (tokens dropped), with padding masked
out of routing, with int8 experts from the JAX ``quantize_params_int8``, and
through a forced routing tie (the lower expert index wins, as in
``jax.lax.top_k``). The ``tiny-moe`` model agrees in ``forward``,
``forward_chunk`` and ``forward_window``; ``init_params_int8`` and the int8
``params_from_hf`` equal the quantization of the bf16 tree bit for bit;
mixtral HF names and config load as in JAX; and the serving engine gives
``JaxServingEngine``'s greedy tokens with the plain tree and in
``"int8-all"``.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax import weights as jw
from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import moe as jmoe
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch import weights as tw
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import moe as tmoe
from dynamo_tpu_torch.ops.int8_matmul import Int8Weight
from dynamo_tpu_torch.runtime.engine import Context

ATOL = 1e-4
E, F, X = 32, 64, 4


def _cfg(capacity_factor):
    kw = dict(hidden_size=E, intermediate_size=F, num_experts=X, top_k=2)
    if capacity_factor is not None:
        kw["capacity_factor"] = capacity_factor
    return jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)


def _moe_params(seed):
    """numpy weights in init_moe_params' tree: router [E, X], w_gate/w_up
    [X, E, F], w_down [X, F, E], fan-in scaled."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    return {"router": w(E, X), "w_gate": w(X, E, F), "w_up": w(X, E, F), "w_down": w(X, F, E)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jout, jaux, tout, taux):
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    for key in ("load_balancing_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), atol=ATOL, rtol=0)


# (capacity factor, expect drops): ample (8.0), the MoeConfig default (1.25),
# and the tight capacity of test_capacity_overflow_drops_gracefully (0.25)
@pytest.mark.parametrize("factor,drops", [(8.0, False), (None, None), (0.25, True)],
                         ids=["ample", "default", "tight"])
def test_moe_mlp_and_aux_match_jax(factor, drops):
    jc, tc = _cfg(factor)
    jp, tp = _both(_moe_params(1))
    x = _x(2, (2, 8, E))
    jout, jaux = jmoe.moe_mlp(jp, jc, jnp.asarray(x))
    tout, taux = tmoe.moe_mlp(tp, tc, torch.from_numpy(x))
    _check(jout, jaux, tout, taux)
    if drops is not None:
        assert (float(taux["dropped_fraction"]) > 0) == drops
    assert np.isfinite(tout.numpy()).all()
    # serving skips the aux terms; the output is the same
    quiet, none = tmoe.moe_mlp(tp, tc, torch.from_numpy(x), with_aux=False)
    assert torch.equal(quiet, tout) and none == {}


def test_padding_is_masked_out_of_routing():
    """A mostly padded batch with a tight capacity: the real tokens get
    their unpadded outputs, padding rows are zero, and both sides agree
    (mirrors test_padding_tokens_cannot_steal_expert_capacity); then a
    random mask over a full batch."""
    jc, tc = _cfg(1.0)
    jp, tp = _both(_moe_params(3))
    real = _x(4, (1, 4, E))
    padded = np.zeros((16, 4, E), np.float32)
    padded[0] = real[0]
    valid = np.zeros((16, 4), bool)
    valid[0] = True
    jout, jaux = jmoe.moe_mlp(jp, jc, jnp.asarray(padded), token_valid=jnp.asarray(valid))
    tout, taux = tmoe.moe_mlp(tp, tc, torch.from_numpy(padded),
                              token_valid=torch.from_numpy(valid))
    _check(jout, jaux, tout, taux)
    want = tmoe.moe_mlp_reference(tp, tc, torch.from_numpy(real))
    np.testing.assert_allclose(tout[0].numpy(), want[0].numpy(), atol=ATOL, rtol=0)
    assert float(taux["dropped_fraction"]) == 0.0
    assert (tout[1:] == 0).all()
    x = _x(5, (3, 6, E))
    mask = np.random.default_rng(6).random((3, 6)) < 0.6
    jout, jaux = jmoe.moe_mlp(jp, _cfg(0.5)[0], jnp.asarray(x), token_valid=jnp.asarray(mask))
    tout, taux = tmoe.moe_mlp(tp, _cfg(0.5)[1], torch.from_numpy(x),
                              token_valid=torch.from_numpy(mask))
    _check(jout, jaux, tout, taux)


@pytest.mark.parametrize("factor", [8.0, 0.5], ids=["ample", "tight"])
def test_int8_experts_match_jax(factor):
    """Expert stacks quantized by the JAX ``quantize_params_int8`` (contract
    over ndim - 2), carried across with ``q`` transposed to [X, out, in]."""
    jc, tc = _cfg(factor)
    p = _moe_params(7)
    jq = jl.quantize_params_int8(
        {"embed": jnp.zeros((1, 1)),
         "layers": {k: jnp.asarray(p[k]) for k in ("w_gate", "w_up", "w_down")}}, None)["layers"]
    jp = {"router": jnp.asarray(p["router"]), **jq}
    tp = {"router": torch.from_numpy(p["router"])}
    for k, w in jq.items():
        assert w["q"].shape[0] == X and w["s"].shape == (X, w["q"].shape[-1])
        tp[k] = Int8Weight(torch.from_numpy(np.swapaxes(np.asarray(w["q"]), -1, -2).copy()),
                           torch.from_numpy(np.array(w["s"])))
    x = _x(8, (2, 5, E))
    _check(*jmoe.moe_mlp(jp, jc, jnp.asarray(x)), *tmoe.moe_mlp(tp, tc, torch.from_numpy(x)))


@pytest.mark.parametrize("c", [2, 5, 17, 130])
@pytest.mark.parametrize("k,n", [(64, 128), (128, 64)])
def test_expert_mat_int8_matches_jax(c, k, n):
    """``_expert_mat`` on an int8 stack: the JAX convert-einsum and the
    port's ``int8_expert_matmul`` (its plain version on the CPU), at
    capacities on either side of the expert tile kernel's cut (the planner's
    choice on the card), fp32."""
    rng = np.random.default_rng(c * 1000 + k)
    x = rng.normal(size=(X, c, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(X, k, n), dtype=np.int8)  # JAX [X, in, out]
    s = (rng.random((X, n)) * 1e-2 + 1e-4).astype(np.float32)
    want = jmoe._expert_mat(jnp.asarray(x), {"q": jnp.asarray(q), "s": jnp.asarray(s)},
                            "xce,xef->xcf")
    w = Int8Weight(torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1))),
                   torch.from_numpy(s))
    got = tmoe._expert_mat(torch.from_numpy(x), w)
    assert got.shape == (X, c, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_routing_ties_break_toward_the_lower_expert():
    """Experts 0, 1 and 2 share one router column: every token ties among
    them. jax.lax.top_k takes the lower indices; so must the port."""
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    p = _moe_params(9)
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 2] = p["router"][:, 0]
    jc, tc = _cfg(0.5)
    jp, tp = _both(p)
    x = _x(10, (2, 8, E))
    _, _, idx = tmoe.route(tp["router"], tc, torch.from_numpy(x).reshape(-1, E))
    assert not (idx == 2).any()  # never above 0 and 1, its equals
    _check(*jmoe.moe_mlp(jp, jc, jnp.asarray(x)), *tmoe.moe_mlp(tp, tc, torch.from_numpy(x)))


def test_reference_matches_jax_reference():
    jc, tc = _cfg(None)
    jp, tp = _both(_moe_params(11))
    x = _x(12, (2, 6, E))
    want = jmoe.moe_mlp_reference(jp, jc, jnp.asarray(x))
    got = tmoe.moe_mlp_reference(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # with ample capacity the dispatch path is the exact top-k mixture
    out, _ = tmoe.moe_mlp(tp, _cfg(8.0)[1], torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), got.numpy(), atol=ATOL, rtol=0)


# -- the tiny-moe model ------------------------------------------------------------

def _configs(name="tiny-moe"):
    jc = dataclasses.replace(jl.LLAMA_PRESETS[name], dtype=jnp.float32)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tl.LlamaConfig)
              if f.name != "dtype"}
    return jc, tl.LlamaConfig(dtype=torch.float32, **fields)


def _numpy_tree(jc, seed):
    """init_params' tree with numpy-made weights (eval_shape: no compile)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jc))
    return jax.tree.map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape) / np.sqrt(sd.shape[-2] if len(
            sd.shape) > 1 else 1), sd.dtype), shapes)


@pytest.fixture(scope="module")
def tiny_moe():
    jc, tc = _configs()
    jp = _numpy_tree(jc, 13)
    return jc, tc, jp, tw.params_from_numpy(jax.tree.map(np.asarray, jp), tc)


def _pool(c, n_blocks, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (c.num_layers, n_blocks, bs, c.num_kv_heads, c.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


TABLES = np.array([[5, 1, 9, 2], [0, 7, 3, 11]], np.int32)
TOKENS = np.array([[3, 17, 42, 5, 9], [8, 1, 2, 0, 0]], np.int32)


def test_tiny_moe_params_carry_across(tiny_moe):
    jc, tc, jp, tp = tiny_moe
    assert tp.layers["moe_router"].shape == (2, 64, 4)
    assert tp.layers["moe_router"].dtype == torch.float32
    assert tp.layers["w_gate"].shape == (2, 4, 64, 128)
    assert tp.layers["w_down"].shape == (2, 4, 128, 64)
    np.testing.assert_array_equal(tp.layers["w_up"].numpy(), np.asarray(jp["layers"]["w_up"]))


def test_tiny_moe_forward_matches(tiny_moe):
    jc, tc, jp, tp = tiny_moe
    k0, v0 = _pool(jc, 16, 4, 0)
    pos = np.array([[0, 1, 2, 3, 4], [6, 7, 8, -1, -1]], np.int32)
    jlog, jcache = jl.forward(jp, jc, jnp.asarray(TOKENS), jnp.asarray(pos),
                              {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                              jnp.asarray(TABLES), use_pallas=False)
    tlog, tcache = tl.forward(tp, tc, torch.from_numpy(TOKENS), torch.from_numpy(pos),
                              {"k": torch.from_numpy(k0), "v": torch.from_numpy(v0)},
                              torch.from_numpy(TABLES))
    valid = pos >= 0
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_history", [False, True])
def test_tiny_moe_forward_chunk_matches(tiny_moe, with_history):
    jc, tc, jp, tp = tiny_moe
    k0, v0 = _pool(jc, 16, 4, 1)
    start = [6, 3] if with_history else [0, 0]
    pos = np.stack([np.arange(s, s + 5) for s in start]).astype(np.int32)
    pos[1, 3:] = -1
    jlog, _ = jl.forward_chunk(jp, jc, jnp.asarray(TOKENS), jnp.asarray(pos),
                               {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                               jnp.asarray(TABLES), with_history=with_history)
    tlog, _ = tl.forward_chunk(tp, tc, torch.from_numpy(TOKENS), torch.from_numpy(pos),
                               {"k": torch.from_numpy(k0), "v": torch.from_numpy(v0)},
                               torch.from_numpy(TABLES), with_history=with_history)
    valid = pos >= 0
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid], atol=ATOL, rtol=0)


def test_tiny_moe_forward_window_matches(tiny_moe):
    """One decode step in the paged history mode (the JAX side through the
    Pallas kernel in interpret mode) with a padding lane."""
    jc, tc, jp, tp = tiny_moe
    k0, v0 = _pool(jc, 16, 4, 2)
    tables = np.array([[5, 1, 9, 2], [0, 7, 3, 11], [4, 6, 8, 10]], np.int32)
    base = np.array([6, 0, -1], np.int32)
    toks = np.array([11, 4, 0], np.int32)
    wshape = (jc.num_layers, 3, 2, jc.num_kv_heads, jc.head_dim)
    jlog, _, _ = jax.jit(lambda p, cache: jl.forward_window(
        p, jc, jnp.asarray(toks), jnp.asarray(base),
        ("paged", cache, jnp.asarray(tables), None, True), jnp.asarray(base),
        jnp.zeros(wshape, jnp.float32), jnp.zeros(wshape, jnp.float32), jnp.int32(0),
    ))(jp, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)})
    tlog, _, _ = tl.forward_window(
        tp, tc, torch.from_numpy(toks), torch.from_numpy(base),
        {"k": torch.from_numpy(k0), "v": torch.from_numpy(v0)}, torch.from_numpy(tables),
        torch.from_numpy(base), torch.zeros(wshape), torch.zeros(wshape), 0)
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], atol=ATOL, rtol=0)


def test_jax_int8_moe_tree_carries_across(tiny_moe):
    """The JAX ``quantize_params_int8`` tree of tiny-moe through
    ``params_from_numpy``: the expert pairs' ``q`` transposed from [L, X,
    in, out] to [L, X, out, in] equal the port's quantization of the same
    weights, ``s`` within one fp32 ulp, the router as it is."""
    jc, tc, jp, tp = tiny_moe
    got = dict(tw.params_from_numpy(
        jax.tree.map(np.asarray, jl.quantize_params_int8(jp, jc)), tc).named_parameters())
    want = dict(tl.quantize_params_int8(tp, tc).named_parameters())
    assert set(got) == set(want)
    assert got["layers.w_down_q"].shape == (2, 4, 64, 128)
    for key, p in got.items():
        if p.dtype == torch.int8 or key.endswith("moe_router"):
            assert torch.equal(p, want[key]), key
        else:
            np.testing.assert_array_max_ulp(p.numpy(), want[key].numpy(), maxulp=1)


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_init_params_int8_is_quantized_init_params_bit_for_bit(name):
    c = tl.LLAMA_PRESETS[name]
    want = dict(tl.quantize_params_int8(tl.init_params(c, seed=4), c).named_parameters())
    got = dict(tl.init_params_int8(c, seed=4).named_parameters())
    assert set(got) == set(want)
    for key, p in got.items():
        assert p.dtype == want[key].dtype and torch.equal(p, want[key]), key
    if name == "tiny-moe":
        assert got["layers.w_gate_q"].shape == (2, 4, 128, 64)
        assert got["layers.w_gate_s"].shape == (2, 4, 128)
        assert got["layers.moe_router"].dtype == torch.float32


# -- mixtral checkpoints and config ---------------------------------------------------

MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "vocab_size": 512,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-5, "num_local_experts": 4, "num_experts_per_tok": 2,
    "tie_word_embeddings": False,
}


def _mixtral_tensors(c, seed):
    """fp32 weights under the HF mixtral names ([out, in] matrices)."""
    rng = np.random.default_rng(seed)
    Ec, Fc, V = c.hidden_size, c.intermediate_size, c.vocab_size
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim

    def mat(o, i):
        return (rng.normal(size=(o, i)) / np.sqrt(i)).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.normal(size=(Ec,))).astype(np.float32)

    t = {"model.embed_tokens.weight": mat(V, Ec), "model.norm.weight": norm(),
         "lm_head.weight": mat(V, Ec)}
    for i in range(c.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": norm(),
                  p + "post_attention_layernorm.weight": norm(),
                  p + "self_attn.q_proj.weight": mat(q, Ec),
                  p + "self_attn.k_proj.weight": mat(kv, Ec),
                  p + "self_attn.v_proj.weight": mat(kv, Ec),
                  p + "self_attn.o_proj.weight": mat(Ec, q),
                  p + "block_sparse_moe.gate.weight": mat(c.num_experts, Ec)})
        for x in range(c.num_experts):
            e = f"{p}block_sparse_moe.experts.{x}."
            t.update({e + "w1.weight": mat(Fc, Ec), e + "w3.weight": mat(Fc, Ec),
                      e + "w2.weight": mat(Ec, Fc)})
    return t


def test_mixtral_config_and_hf_weights_match_jax():
    jc = jw.config_from_card(JaxCard(display_name="m", model_config=MIXTRAL_CONFIG),
                             dtype=jnp.float32)
    tc = tw.config_from_card(ModelDeploymentCard(display_name="m", model_config=MIXTRAL_CONFIG),
                             dtype=torch.float32)
    assert (tc.num_experts, tc.num_experts_per_tok) == (4, 2)
    for f in dataclasses.fields(tl.LlamaConfig):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    tensors = _mixtral_tensors(tc, 14)
    jp = jw.params_from_hf(tensors, jc)
    tp = tw.params_from_hf(tensors, tc)
    ref = dict(tw.params_from_numpy(jax.tree.map(np.asarray, jp), tc).named_parameters())
    for key, p in tp.named_parameters():
        assert torch.equal(p, ref[key]), key
    # straight to int8: the quantization of the plain tree, bit for bit
    want = dict(tl.quantize_params_int8(tp, tc).named_parameters())
    got = dict(tw.params_from_hf(tensors, tc, int8=True).named_parameters())
    assert set(got) == set(want)
    for key, p in got.items():
        assert torch.equal(p, want[key]), key


# -- the serving engine ----------------------------------------------------------------

ENGINE = dict(max_slots=2, kv_block_size=8, max_model_len=48, prefill_chunk=16,
              decode_steps=2)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 4, 5, 9, 0, 4])


async def _tokens(engine, common, ctx_cls, prompt, max_tokens):
    req = common.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=common.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=common.SamplingOptions(temperature=0.0),
    )
    toks = []
    async for item in engine.generate(ctx_cls(req)):
        if item.data is not None:
            toks.extend(item.data.get("token_ids", []))
    return toks


def _drive(engine, common, ctx_cls, n=8):
    async def wave():
        return await asyncio.gather(*[_tokens(engine, common, ctx_cls, p, n) for p in PROMPTS])

    try:
        return asyncio.run(wave())
    finally:
        engine.close()


@pytest.fixture(scope="module", params=[None, "int8-all"], ids=["plain", "int8-all"])
def engine_tokens(request, tiny_moe):
    """JaxServingEngine's greedy tokens at tiny-moe, once per mode."""
    jc, tc, jp, tp = tiny_moe
    mode = request.param
    want = _drive(JaxServingEngine(jc, jp, JaxEngineConfig(quantize=mode, **ENGINE)),
                  jcommon, JaxContext)
    return mode, want


def test_engine_greedy_tokens_equal_jax_engine(engine_tokens, tiny_moe):
    jc, tc, jp, tp = tiny_moe
    mode, want = engine_tokens
    teng = TorchServingEngine(tc, tw.params_from_numpy(jax.tree.map(np.asarray, jp), tc),
                              EngineConfig(quantize=mode, **ENGINE), device="cpu")
    assert teng.params.int8 == (mode == "int8-all")
    got = _drive(teng, tcommon, Context)
    assert got == want
    assert all(len(t) == 8 for t in got)
