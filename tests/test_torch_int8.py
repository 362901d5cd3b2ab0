"""The port's weight-only int8 against the JAX package's, on the CPU.

``quantize_params_int8`` gives the same ``q`` (and ``s`` within one fp32
ulp) as the JAX function on the same weights; ``matw``, the int8
``embed_lookup`` and ``lm_head`` (tied and untied) agree within 1e-5 in
fp32; the int8 kernel's plain version agrees with the JAX ``matw`` in bf16
within one bf16 ulp of the output; and the serving engine in both modes
(``"int8"``, ``"int8-all"``) gives the greedy tokens of ``JaxServingEngine``
with the same ``quantize`` on the same weights.
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
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.ops import int8_matmul
from dynamo_tpu_torch.ops.int8_matmul import (
    int8_weight_matmul,
    int8_weight_matmul_plain,
    int8_weight_matmul_splitk_plain,
)
from dynamo_tpu_torch.runtime.engine import Context

ATOL = 1e-5  # fp32 on both sides; sums in another order


def _configs(tied: bool):
    jc = dataclasses.replace(jl.LLAMA_PRESETS["tiny"], dtype=jnp.float32, tie_embeddings=tied)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(tl.LlamaConfig)
              if f.name != "dtype"}
    return jc, tl.LlamaConfig(dtype=torch.float32, **fields)


def _numpy_params(jc, seed):
    """init_params' tree with numpy-made weights (eval_shape: no compile)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jc))
    return jax.tree.map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape) / np.sqrt(sd.shape[-1]), sd.dtype),
        shapes,
    )


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def quantized(request):
    jc, tc = _configs(request.param)
    jp = _numpy_params(jc, 11)
    jq = jl.quantize_params_int8(jp, jc)
    tq = tl.quantize_params_int8(params_from_numpy(jax.tree.map(np.asarray, jp), tc), tc)
    return jc, tc, jq, tq


def test_quantize_params_int8_matches_jax(quantized):
    jc, tc, jq, tq = quantized
    ref = dict(params_from_numpy(jax.tree.map(np.asarray, jq), tc).named_parameters())
    names = dict(tq.named_parameters())
    assert set(names) == set(ref)
    assert tq.int8 and ("lm_head_q" in names) == (not tc.tie_embeddings)
    for name, p in names.items():
        if p.dtype == torch.int8:
            assert torch.equal(p, ref[name]), name
        else:
            np.testing.assert_array_max_ulp(p.numpy(), ref[name].numpy(), maxulp=1)
    # the port's layout: q [.., out, in], the transpose of the JAX [.., in, out]
    np.testing.assert_array_equal(
        tq.layers["w_down_q"][1].numpy(), np.asarray(jq["layers"]["w_down"]["q"][1]).T
    )


def test_matw_embed_and_lm_head_int8_match_jax(quantized):
    jc, tc, jq, tq = quantized
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 2, jc.hidden_size)).astype(np.float32)
    for name in tl.INT8_MATS:
        w = jq["layers"][name]
        xin = x if w["q"].shape[-2] == jc.hidden_size else rng.normal(
            size=(3, 2, w["q"].shape[-2])).astype(np.float32)
        want = jl.matw(jnp.asarray(xin), jax.tree.map(lambda a: a[0], w))
        got = tl.matw(torch.from_numpy(xin), tq.layer(0)[name])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    tokens = np.array([[3, 0, 511], [-1, 7, 42]], np.int32)
    want = jl.embed_lookup(jq, jnp.asarray(tokens), jnp.float32)
    got = tl.embed_lookup(tq, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    want = jl.lm_head(jq, jc, jnp.asarray(x))
    got = tl.lm_head(tq, tc, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _within_one_bf16_ulp(got, want):
    mag = np.maximum(np.abs(want), np.abs(got))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


# (m, splits): None is the plain version; an int the split-K kernel's order
# of sums (int8_weight_matmul_splitk_plain) with that many splits of K = 256
@pytest.mark.parametrize("m,splits", [(1, None), (8, None), (33, None), (1, 3), (8, 4), (33, 2)],
                         ids=["1", "8", "33", "splitk3-1", "splitk4-8", "splitk2-33"])
def test_plain_kernel_function_matches_jax_matw_in_bf16(m, splits):
    """bf16 activations, the int8 pair of a [K, N] weight: within one bf16
    ulp of the output (both round the product to bf16, scale in fp32 and
    round again; their sums run in other orders)."""
    rng = np.random.default_rng(m)
    k, n = (128 if splits is None else 256), 48
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jw = jl.quantize_params_int8(
        {"embed": jnp.zeros((1, 1)), "layers": {"wq": jnp.asarray(w)}}, None
    )["layers"]["wq"]
    want = np.asarray(jl.matw(jnp.asarray(x, jnp.bfloat16), jw).astype(jnp.float32))
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(np.asarray(jw["q"]).T.copy()),
            torch.from_numpy(np.array(jw["s"])))
    plain = int8_weight_matmul_plain(*args)
    assert plain.dtype == torch.bfloat16
    if splits is not None:
        got = int8_weight_matmul_splitk_plain(*args, splits)
        assert got.dtype == torch.bfloat16
        _within_one_bf16_ulp(got.float().numpy(), plain.float().numpy())
    else:
        got = plain
    _within_one_bf16_ulp(got.float().numpy(), want)


# (K, N) of every int8 product of the llama-family presets that the kernel
# tiles, and M from one lane to a prefill chunk
_PLAN_SHAPES = sorted({
    (k, n) for c in tl.LLAMA_PRESETS.values()
    for k, n in ((c.hidden_size, c.q_dim), (c.hidden_size, c.kv_dim), (c.q_dim, c.hidden_size),
                 (c.hidden_size, c.intermediate_size), (c.intermediate_size, c.hidden_size),
                 (c.hidden_size, c.vocab_size))
})
_PLAN_M = (1, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 128, 256, 1000, 1024)


def test_plan_int8_is_a_function_of_shapes_alone():
    import inspect

    assert list(inspect.signature(int8_matmul.plan_int8).parameters) == [
        "m", "n", "k", "sms", "path", "experts"]
    for k, n in _PLAN_SHAPES:
        for m in _PLAN_M:
            for x in (1, 8):  # one product, and a stack of 8 experts
                a = int8_matmul.plan_int8(m, n, k, 132, experts=x)
                b = int8_matmul.plan_int8(m, n, k, 132, experts=x)
                assert a == b and hash(a) == hash(b)
                tile = int8_matmul.plan_int8(m, n, k, 132, path="tile", experts=x)
                wide = tile.blocks >= int8_matmul.TILE_MIN_SM_SHARE * 132
                if x > 1 and m >= int8_matmul.EXPERT_TILE_MIN_C:  # an expert stack's prefill
                    assert a.path == "expert_tile"
                else:
                    assert a.path == ("tile" if m >= int8_matmul.TILE_MIN_M and wide
                                      else "splitk")
    # an "int8-all" prefill chunk of 8 x 128 tokens: every llama3-8b product on the tile kernel
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)):
        assert int8_matmul.plan_int8(1024, n, k, 132).path == "tile"


# llama3-8b's products (K, N), the LM head included
_LLAMA3_8B_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))


@pytest.mark.parametrize("m", [17, 40, 64, 65, 128, 1024])
@pytest.mark.parametrize("k,n", _LLAMA3_8B_SHAPES)
def test_plan_int8_keeps_up_to_64_rows_on_split_k(k, n, m):
    """A speculative verify dispatch (8 lanes x (k + 1) = 40 rows at k = 4)
    and any product of up to SPLITK_MAX_LANES rows run on the split-K
    kernel, the kernel of a decode step, in one lane tile; from 65 rows on
    the plan is as before: the tile kernel wherever its grid keeps a
    quarter of the SMs busy (every product of a 1024-row chunk)."""
    plan = int8_matmul.plan_int8(m, n, k, 132)
    tile = int8_matmul.plan_int8(m, n, k, 132, path="tile")
    if m <= int8_matmul.SPLITK_MAX_LANES:
        assert plan.path == "splitk" and plan.kernel == "w8a16_splitk_kernel"
        assert plan.lanes >= m and plan.blocks == plan.splits * -(-n // plan.rows)
    elif tile.blocks >= int8_matmul.TILE_MIN_SM_SHARE * 132:
        assert plan == tile and plan.kernel == "w8a16_tile_kernel"
    else:
        assert plan.path == "splitk" and m < 1024


# mixtral-8x7b's expert stacks (8 experts): C = 2, 4 (decode at 8 lanes) and
# 5 on the split-K kernel; C = 130 as one token tile of 136, C = 512 (a
# 1024-row prefill chunk) as two of 256, on the expert tile kernel
_EXPERT_PLANS = {
    (4096, 14336): {
        2: ("splitk", 64, 8, 1, 1792), 4: ("splitk", 64, 8, 1, 1792),
        5: ("splitk", 64, 8, 1, 1792), 130: ("expert_tile", 128, 136, 1, 896),
        512: ("expert_tile", 128, 256, 1, 1792),
    },
    (14336, 4096): {
        2: ("splitk", 64, 8, 1, 512), 4: ("splitk", 64, 8, 1, 512),
        5: ("splitk", 64, 8, 1, 512), 130: ("expert_tile", 128, 136, 1, 256),
        512: ("expert_tile", 128, 256, 1, 512),
    },
}


@pytest.mark.parametrize("k,n", list(_EXPERT_PLANS))
def test_expert_plans_for_mixtral(k, n):
    for c, want in _EXPERT_PLANS[(k, n)].items():
        plan = int8_matmul.plan_int8(c, n, k, 132, experts=8)
        assert dataclasses.astuple(plan) == want, (c, plan)
        assert plan.kernel == f"w8a16_{want[0]}_kernel"
        assert plan.kernel in int8_matmul._KERNELS.values()


def test_expert_tile_width_is_the_narrowest_that_covers_c_in_fewest_tiles():
    widths = int8_matmul.EXPERT_TILE_TOKENS
    for c in range(1, 1100):
        plan = int8_matmul.plan_int8(c, 4096, 14336, 132, path="expert_tile", experts=8)
        tiles = -(-c // widths[-1])
        assert plan.lanes in widths and -(-c // plan.lanes) == tiles
        assert all(w * tiles < c for w in widths if w < plan.lanes)
        assert plan.blocks == 8 * tiles * 4096 // int8_matmul.EXPERT_TILE_ROWS
    # the dense product keeps its plans: never the expert tile kernel unforced
    for m in (1, 17, 130, 1024):
        assert int8_matmul.plan_int8(m, 14336, 4096, 132).path != "expert_tile"


def test_planned_splits_cut_k_into_nonempty_ranges():
    for k, n in _PLAN_SHAPES:
        chunks = k // int8_matmul.K_TILE
        for m in _PLAN_M:
            for path in ("tile", "splitk"):
                p = int8_matmul.plan_int8(m, n, k, 132, path=path)
                assert 1 <= p.splits <= min(chunks, int8_matmul.MAX_SPLITS)
                bounds = [i * chunks // p.splits for i in range(p.splits + 1)]
                assert bounds[0] == 0 and bounds[-1] == chunks
                assert all(b > a for a, b in zip(bounds, bounds[1:]))
                tiles = -(-n // p.rows) * -(-m // p.lanes)
                assert p.blocks == tiles * p.splits and p.lanes >= min(m, 64)
                if path == "splitk":  # the 4-stage ring fits a block's shared memory
                    c = int8_matmul.SPLITK_ROWS[p.rows]
                    assert 4 * (p.rows * (c * 64 + 16) + p.lanes * (c * 128 + 16)) <= 227 * 1024


def test_plan_fills_the_card_for_narrow_weights():
    # 4096 -> 1024 (wk, wv) at the slice's 8 lanes: its row tiles alone would
    # leave most of 132 SMs idle; splits bring it to 128 blocks, one per SM
    # (the plan does not pass one block per SM where it needs splits)
    p = int8_matmul.plan_int8(8, 1024, 4096, 132)
    assert p.path == "splitk" and p.splits > 1 and 0.95 * 132 <= p.blocks <= 132
    # every llama3-8b decode shape keeps at least 95% of the SMs busy
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)):
        assert int8_matmul.plan_int8(8, n, k, 132).blocks >= 0.95 * 132


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, size=(32, 64)).astype(np.int8))
    s = torch.from_numpy(rng.random(32).astype(np.float32))
    before = int8_weight_matmul.launches
    kernels_before = dict(int8_matmul.device_launches)
    got = int8_weight_matmul(x, q, s)
    assert got.shape == (2, 5, 32) and got.dtype == torch.float32
    assert torch.equal(got, int8_weight_matmul_plain(x, q, s))
    assert torch.equal(int8_weight_matmul(x, q, s, out_dtype=torch.bfloat16),
                       int8_weight_matmul_plain(x, q, s, out_dtype=torch.bfloat16))
    assert int8_weight_matmul.launches == before
    assert int8_matmul.device_launches == kernels_before


@pytest.mark.parametrize("n,k,why", [
    (24, 64, "N not a multiple of 16"),
    (32, 96, "K not a multiple of 64"),
])
def test_unsupported_shapes_are_refused(n, k, why):
    x = torch.zeros((8, k), dtype=torch.bfloat16)
    q = torch.zeros((n, k), dtype=torch.int8)
    s = torch.ones(n)
    with pytest.raises(ValueError, match="tiles"):
        int8_matmul._check(x, q, s, torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul._check(x, q.float(), s, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul._check(torch.zeros((8, 64)), torch.zeros((64, 32), dtype=torch.int8).T,
                           torch.ones(32), torch.float32)


# -- the serving engine ------------------------------------------------------

ENGINE = dict(max_slots=2, kv_block_size=8, max_model_len=48, prefill_chunk=16,
              decode_steps=2)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 4, 5])


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


@pytest.fixture(scope="module")
def engine_weights():
    jc, tc = _configs(False)
    jp = _numpy_params(jc, 12)
    return jc, tc, jp


@pytest.mark.parametrize("mode", ["int8", "int8-all"])
def test_engine_greedy_tokens_equal_jax_engine(engine_weights, mode):
    jc, tc, jp = engine_weights
    tree = jax.tree.map(np.asarray, jp)
    want = _drive(JaxServingEngine(jc, jp, JaxEngineConfig(quantize=mode, **ENGINE)),
                  jcommon, JaxContext)
    teng = TorchServingEngine(tc, params_from_numpy(tree, tc),
                              EngineConfig(quantize=mode, **ENGINE), device="cpu")
    assert teng.params_decode.int8
    assert teng.params.int8 == (mode == "int8-all")
    got = _drive(teng, tcommon, Context)
    assert got == want
    if mode == "int8":
        # the hybrid contract: the first token comes from the bf16 prefill
        plain = _drive(TorchServingEngine(tc, params_from_numpy(tree, tc),
                                          EngineConfig(**ENGINE), device="cpu"),
                       tcommon, Context, n=1)
        assert [t[:1] for t in got] == plain


def test_int8_all_takes_a_quantized_tree_as_it_is(engine_weights):
    jc, tc, jp = engine_weights
    tq = params_from_numpy(jax.tree.map(np.asarray, jl.quantize_params_int8(jp, jc)), tc)
    eng = TorchServingEngine(tc, tq, EngineConfig(quantize="int8-all", **ENGINE), device="cpu")
    try:
        assert eng.params is tq and eng.params_decode is tq
    finally:
        eng.close()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TorchServingEngine(tc, tq, EngineConfig(quantize="int4", **ENGINE), device="cpu")
