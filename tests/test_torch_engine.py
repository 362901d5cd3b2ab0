"""The port's serving engine against JaxServingEngine on the tiny preset in
fp32: the same parameters (carried across with ``params_from_numpy``) and
the same requests give equal greedy token streams, through recompute
preemption, a prefix-cache hit, chunked prefill and multi-step decode
dispatches; and, with bf16 and int8 KV pages, through a prefix hit served
from the host-RAM KV tier."""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models.llama import LLAMA_PRESETS, init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine, resolve_device
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.runtime.engine import Context

JCFG = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=jnp.float32)
TCFG = LlamaConfig(dtype=torch.float32, **{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(LlamaConfig) if f.name != "dtype"
})
# 6 blocks of 8 cannot hold two 26-token sequences: the second lane preempts
ENGINE = dict(max_slots=2, kv_block_size=8, max_model_len=48, num_kv_blocks=6,
              prefill_chunk=16, decode_steps=2)


async def _tokens(engine, common, ctx_cls, prompt, max_tokens):
    req = common.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=common.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=common.SamplingOptions(temperature=0.0),
    )
    toks, finish = [], None
    async for item in engine.generate(ctx_cls(req)):
        if item.data is None:
            continue
        toks.extend(item.data.get("token_ids", []))
        finish = item.data.get("finish_reason") or finish
    return toks, finish


def _drive(engine, common, ctx_cls):
    async def wave(prompts, n):
        return await asyncio.gather(*[_tokens(engine, common, ctx_cls, p, n) for p in prompts])

    first = asyncio.run(wave([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 4, 5]], 18))
    # shares the first prompt's sealed block: a prefix-cache hit
    second = asyncio.run(wave([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]], 12))
    return first + second


def test_greedy_streams_equal_jax_engine():
    jparams = init_params(jax.random.PRNGKey(0), JCFG)
    jeng = JaxServingEngine(JCFG, jparams, JaxEngineConfig(**ENGINE))
    teng = TorchServingEngine(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG),
        EngineConfig(**ENGINE), device="cpu",
    )
    try:
        want = _drive(jeng, jcommon, JaxContext)
        got = _drive(teng, tcommon, Context)
    finally:
        jeng.close()
        teng.close()
    assert got == want
    assert all(f == "length" for _, f in got)
    assert teng.preemptions > 0 and jeng.preemptions > 0
    m = teng.metrics_snapshot()
    assert m["gpu_prefix_cache_hit_rate"] > 0
    assert m["decode_dispatches"] > 0 and m["decode_steps_total"] == 2 * m["decode_dispatches"]


# 8 blocks of 8: the second wave's two 17-token prompts need every block, so
# the first wave's two sealed blocks are evicted to the host tier; the third
# wave repeats the first prompt and finds them there
HOST_TIER = dict(max_slots=2, kv_block_size=8, max_model_len=48, num_kv_blocks=8,
                 prefill_chunk=16, decode_steps=2, host_cache_blocks=16)
REPEATED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]
EVICTING = [[2, 7, 1, 8, 2, 8, 1, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5],
            [1, 4, 1, 4, 2, 1, 3, 5, 6, 2, 3, 7, 3, 0, 9, 5, 7]]


def _drive_host_tier(engine, common, ctx_cls):
    def wave(prompts, n):
        async def go():
            return await asyncio.gather(
                *[_tokens(engine, common, ctx_cls, p, n) for p in prompts])
        return asyncio.run(go())

    out = wave([REPEATED], 6) + wave(EVICTING, 6)
    deadline = time.monotonic() + 30  # spills reach the host pool off the step
    while len(engine.host_pool) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    return out + wave([REPEATED], 6)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_streams_equal_jax_engine_with_host_tier(kv_dtype):
    """A pool too small for two waves: blocks evicted by the second wave
    spill to host RAM (an int8 pool's scales with them) and serve the third
    wave's prefix hit, in both engines, with equal greedy streams."""
    jparams = init_params(jax.random.PRNGKey(1), JCFG)
    jeng = JaxServingEngine(JCFG, jparams, JaxEngineConfig(**HOST_TIER, kv_dtype=kv_dtype))
    teng = TorchServingEngine(
        TCFG, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG),
        EngineConfig(**HOST_TIER, kv_dtype=kv_dtype), device="cpu",
    )
    try:
        want = _drive_host_tier(jeng, jcommon, JaxContext)
        got = _drive_host_tier(teng, tcommon, Context)
        jm, tm = jeng.metrics_snapshot(), teng.metrics_snapshot()
    finally:
        jeng.close()
        teng.close()
    assert got == want
    assert all(len(t) == 6 and f == "length" for t, f in got)
    assert tm["kv_quantized"] == int(kv_dtype == "int8")
    assert teng.cache["k"].dtype == (torch.int8 if kv_dtype == "int8" else torch.float32)
    assert jm["host_cache_hits"] > 0 and tm["host_cache_hits"] > 0
    assert tm["host_cache_blocks"] >= 2


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _port_engine(seed=1):
    from dynamo_tpu_torch.models.llama import LLAMA_PRESETS as TP, init_params as tinit

    cfg = dataclasses.replace(TP["tiny"], dtype=torch.float32)
    return TorchServingEngine(cfg, tinit(cfg, seed=seed), EngineConfig(
        max_slots=2, kv_block_size=8, max_model_len=64, decode_steps=3), device="cpu")


async def _items(engine, prompt, n, **sampling):
    req = tcommon.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=tcommon.StopConditions(max_tokens=n, ignore_eos=True),
        sampling_options=tcommon.SamplingOptions(**sampling),
    )
    return [i.data async for i in engine.generate(Context(req)) if i.data]


def test_logprobs_penalties_and_seeded_sampling():
    prompt = [5, 9, 2, 7, 1, 3]
    eng = _port_engine()
    try:
        items = asyncio.run(_items(eng, prompt, 7, logprobs=2))
        toks = [t for d in items for t in d["token_ids"]]
        lps = [x for d in items for x in d.get("log_probs") or []]
        tops = [x for d in items for x in d.get("top_logprobs") or []]
        assert len(toks) == len(lps) == len(tops) == 7
        assert all(lp <= 0 for lp in lps) and all(len(t) == 2 for t in tops)
        # greedy: the chosen token is the top alternative
        assert all(int(max(t, key=t.get)) == tok for t, tok in zip(tops, toks))
        pen = asyncio.run(_items(eng, prompt, 10, presence_penalty=2.0, frequency_penalty=2.0))
        pen_toks = [t for d in pen for t in d["token_ids"]]
        assert len(set(pen_toks)) == len(pen_toks)  # penalties forbid repeats here
    finally:
        eng.close()
    draws = []
    for _ in range(2):  # same seed, same engine history: the same tokens
        eng = _port_engine()
        try:
            out = asyncio.run(_items(eng, prompt, 9, temperature=0.9, top_k=20, seed=5))
        finally:
            eng.close()
        draws.append([t for d in out for t in d["token_ids"]])
    assert draws[0] == draws[1] and len(draws[0]) == 9
