"""Random draws layer by layer and ``"int8-all"`` on a tp mesh, against the
port's unsharded engine and the JAX package on the conftest's CPU mesh
(``dp=1, tp=2``), the port's two ranks co-located on the CPU:

1. the draw rule: which presets draw their layer matrices whole and which
   one slice at a time (llama3-70b slices, llama3-8b does not), and sliced
   draws on a mesh equal to the unsharded sliced draws, sharded;
2. the random int8 tree drawn onto a mesh equal to
   ``shard_params(init_params_int8(...))`` bit for bit, for a dense preset,
   a dense preset that draws slices and ``tiny-moe``, through
   ``init_params_int8`` and through ``load_params``;
3. the ``"int8-all"`` tp engine: its decode tree's ``q`` and ``s`` equal to
   the addressable shards of the JAX engine's ``"int8"`` decode tree
   (quantized under ``quantized_param_shardings``), and its greedy streams
   equal to the port's unsharded ``"int8-all"`` engine's, the tree drawn on
   the mesh or handed over whole.

Weights and streams are compared for exact equality, but for the scales of
the JAX engine's jitted quantization: to one fp32 ulp (test 3 says why).
The tiny preset runs in fp32 (``test_torch_tp.py``'s TCFG).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from dynamo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dynamo_tpu_torch.cli.run import build_engine, build_parser
from dynamo_tpu_torch.engine_torch.engine import (
    EngineConfig,
    TorchServingEngine,
    build_torch_serving_engine,
)
from dynamo_tpu_torch.engine_torch.weights import load_params, params_from_numpy
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from dynamo_tpu_torch.runtime.engine import Context

from .test_engine_jax import CFG
from .test_torch_tp import ENGINE, TCFG, TP, _assert_shards_equal, _jax_shard, _wave

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5], [8, 9, 7, 9], [2, 7, 1, 8]]
# which presets draw each layer matrix whole, stacked over the layers (the
# draws of every measurement before slicing came in), and which one slice
# at a time
WHOLE = {"tiny": True, "llama3.2-1b": True, "llama3-8b": True, "llama3-70b": False,
         "qwen2.5-7b": True, "qwen2.5-1.5b": True, "tiny-moe": False, "mixtral-8x7b": False}


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(MeshConfig(tp=TP), ["cpu"] * TP)


@pytest.fixture
def sliced(monkeypatch):
    """The tiny preset under a rule that slices every dense draw."""
    monkeypatch.setattr(tl, "WHOLE_DRAW_MAX_BYTES", 0)
    assert not tl.draws_whole(TCFG)
    return TCFG


def _equal_trees(a, b):
    for x, y in zip(getattr(a, "shards", [a]), getattr(b, "shards", [b])):
        got, want = dict(x.named_parameters()), dict(y.named_parameters())
        assert set(got) == set(want)
        for name, t in got.items():
            assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name


# -- 1. the draw rule -------------------------------------------------------------


def test_draw_rule_pins_the_presets():
    assert {n: tl.draws_whole(c) for n, c in tl.LLAMA_PRESETS.items()} == WHOLE
    # llama3-70b cut to 4 layers (the widths that chip_smoke.py serves at
    # tp=8) stacks 3.8 GB per matrix and keeps its whole draws
    cut = dataclasses.replace(tl.LLAMA_PRESETS["llama3-70b"], num_layers=4)
    assert tl.draws_whole(cut)


def test_sliced_draws_on_a_mesh_equal_the_sharded_sliced_draws(sliced, tmesh):
    slices = tl.init_params(sliced, seed=5)
    # layer 0's slice of wq is the first draw after the embedding and head
    gen = torch.Generator().manual_seed(5)
    for shape in ((TCFG.vocab_size, TCFG.hidden_size), (TCFG.hidden_size, TCFG.vocab_size)):
        torch.randn(shape, generator=gen)
    first = torch.randn(TCFG.hidden_size, TCFG.q_dim, generator=gen) / TCFG.hidden_size ** 0.5
    assert torch.equal(slices.layers["wq"][0], first)
    _equal_trees(tl.init_params(sliced, seed=5, mesh=tmesh),
                 tl.shard_params(slices, sliced, tmesh))


# -- 2. the random int8 tree on a mesh -----------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "tiny-sliced", "tiny-moe"])
def test_random_int8_on_mesh_equals_sharded_int8(request, tmesh, preset):
    if preset == "tiny-sliced":
        cfg = request.getfixturevalue("sliced")
    else:
        cfg = dataclasses.replace(tl.LLAMA_PRESETS[preset], dtype=torch.bfloat16)
    whole = tl.init_params_int8(cfg, seed=9)
    _equal_trees(whole, tl.quantize_params_int8(tl.init_params(cfg, seed=9), cfg))
    want = tl.shard_params(whole, cfg, tmesh)
    _equal_trees(tl.init_params_int8(cfg, seed=9, mesh=tmesh), want)
    # and through the loader, for a card without weight files
    card = ModelDeploymentCard(display_name=preset, model_path=None)
    _equal_trees(load_params(card, cfg, seed=9, int8=True, mesh=tmesh), want)


def test_quantization_slices_are_exact(monkeypatch):
    """Quantizing over slices of whole output channels gives the one-pass
    quantization: per column of an [in, out] matrix, per row of the
    embedding, with a given absmax (a row-parallel shard's)."""
    w = torch.randn(96, 200, generator=torch.Generator().manual_seed(2)).bfloat16()
    amax = w.float().abs().amax(dim=0) * 1.5
    want = [tl.quantize_matrix(w), tl.quantize_matrix(w, per_row=True),
            tl.quantize_matrix(w, amax=amax)]
    monkeypatch.setattr(tl, "_QUANT_CHUNK", 96 * 7)  # 7 channels per pass, the last short
    got = [tl.quantize_matrix(w), tl.quantize_matrix(w, per_row=True),
           tl.quantize_matrix(w, amax=amax)]
    for (q, s), (wq, ws) in zip(got, want):
        assert torch.equal(q, wq) and torch.equal(s, ws)
    wf = w.float()
    s = (wf.abs().amax(dim=0) / 127.0).clamp(min=1e-12)
    assert torch.equal(got[0][0].T, torch.round(wf / s).clamp(-127, 127).to(torch.int8))


# -- 3. "int8-all" on a tp mesh -------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jax.random.PRNGKey(0), CFG)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def test_int8_all_tp_decode_tree_equals_jax_int8_shards(weights, tmesh):
    """The ``"int8-all"`` tp engine's one sharded int8 tree against the
    JAX engine's ``"int8"`` decode tree on its mesh, shard for shard: every
    ``q`` bit for bit, every ``s`` to one fp32 ulp. The engine quantizes
    under ``jax.jit``, where XLA computes ``absmax / 127`` as ``absmax *
    (1 / 127)``: a few scales sit one ulp from the eager
    ``quantize_params_int8``, which the port's tree equals bit for bit
    (checked here too)."""
    jparams, tparams = weights
    jmesh = jax_make_mesh(JaxMeshConfig(tp=TP))
    jeng = JaxServingEngine(CFG, jax.device_put(jparams, jl.param_shardings(CFG, jmesh)),
                            JaxEngineConfig(quantize="int8"), mesh=jmesh)
    try:
        jtree = jeng.params_decode
    finally:
        jeng.close()
    eng = TorchServingEngine(TCFG, tparams, EngineConfig(**ENGINE, quantize="int8-all"),
                             mesh=tmesh)
    try:
        assert eng.params is eng.params_decode and eng.params.int8
        rc = tl.rank_config(TCFG, TP)
        for r, shard in enumerate(eng.params_decode.shards):
            want = dict(params_from_numpy(_jax_shard(jtree, jmesh, r), rc).named_parameters())
            got = dict(shard.named_parameters())
            assert set(got) == set(want)
            for name, x in got.items():
                if name.endswith("_s"):
                    torch.testing.assert_close(x, want[name], rtol=2.0 ** -23, atol=0)
                else:
                    assert torch.equal(x, want[name]), (r, name)
        eager = jax.device_put(jl.quantize_params_int8(jparams, CFG),
                               jl.quantized_param_shardings(CFG, jmesh))
        _assert_shards_equal(eng.params_decode, eager, jmesh, TCFG)
    finally:
        eng.close()


def test_int8_all_tp_streams_equal_unsharded(weights, tmesh):
    _, tparams = weights
    cfg = EngineConfig(**ENGINE, quantize="int8-all")
    one = TorchServingEngine(TCFG, tparams, cfg, device="cpu")
    tp_eng = TorchServingEngine(TCFG, tparams, cfg, mesh=tmesh)
    try:
        want = _wave(one, Context, PROMPTS, 10)
        got = _wave(tp_eng, Context, PROMPTS, 10)
    finally:
        one.close()
        tp_eng.close()
    assert got == want and all(len(t) == 10 for t in got)


def test_int8_all_tp_engine_from_random_weights(model_dir):
    """``build_torch_serving_engine(quantize="int8-all",
    tensor_parallel_size=2)`` on a card without weight files: the tree is
    drawn onto the ranks (the unsharded draw, sharded) and serves the
    unsharded engine's streams."""
    card = ModelDeploymentCard.from_local_path(model_dir)
    kw = dict(max_batch_size=4, kv_block_size=8, max_model_len=64, seed=3,
              quantize="int8-all", device="cpu")
    tp_eng = build_torch_serving_engine(card, tensor_parallel_size=TP, **kw)
    one = build_torch_serving_engine(card, **kw)
    try:
        assert tp_eng.params.int8 and tp_eng.params is tp_eng.params_decode
        _equal_trees(tp_eng.params, tl.shard_params(one.params, one.model_config, tp_eng.mesh))
        assert _wave(tp_eng, Context, PROMPTS, 6) == _wave(one, Context, PROMPTS, 6)
    finally:
        tp_eng.close()
        one.close()


def test_launcher_quantize_int8_all_on_a_mesh(model_dir):
    """``--quantize int8-all --tensor-parallel-size 2`` through the
    launcher: one sharded int8 tree, each rank's pool sized by the
    engine's rule from ``--max-batch-size`` and ``--max-model-len``."""
    flags = build_parser().parse_args(["--model-path", model_dir, "--device", "cpu",
                                       "--tensor-parallel-size", "2", "--quantize", "int8-all",
                                       "--max-batch-size", "2", "--max-model-len", "64"])
    _, _, _, core = build_engine("torch", flags)
    try:
        assert core.mesh.tp == 2 and core.params.int8 and core.params is core.params_decode
        blocks = 2 * (64 // flags.kv_block_size) * 3 // 2  # 1.5 x the slots' contexts
        assert core.config.resolve_num_blocks() == blocks
        assert core.num_blocks == blocks and [p["k"].shape[1] for p in core.cache] == [blocks] * 2
    finally:
        core.close()
