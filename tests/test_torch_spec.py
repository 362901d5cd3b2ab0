"""The port's self-draft speculative decoding against the JAX package's, on
the tiny preset in fp32: the knob clamps, ``NgramDrafter`` over seeded token
streams, ``speculative_targets`` (greedy, penalised, with logprobs), and
greedy speculative streams at k in {1, 2, 4} equal to the JAX spec engine's
and to the port's own spec-off streams; penalties, logprobs, preemption and
an int8 KV pool against both as well; then EOS inside an accepted run, and
spec off building nothing."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax import drafter as jdrafter
from dynamo_tpu.engine_jax import sampling as jsampling
from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.models.llama import LLAMA_PRESETS, init_params
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch import drafter, sampling
from dynamo_tpu_torch.engine_torch import engine as engine_mod
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.runtime.engine import Context

JCFG = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=jnp.float32)
TCFG = LlamaConfig(dtype=torch.float32, **{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(LlamaConfig) if f.name != "dtype"
})
# the JAX package's spec tests' engine (tests/test_engine_spec.py)
ENGINE = dict(max_slots=4, kv_block_size=8, max_model_len=128)
# repetition-heavy prompt: the shape prompt-lookup drafting exists for
REP_PROMPT = ([3, 1, 4, 1, 5, 9, 2, 6] * 4)[:24]


@pytest.fixture(scope="module")
def weights():
    jparams = init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _payload(prompt, max_tokens, with_lp=False, eos=None, **sampling_options):
    return {"token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": eos is None},
            "sampling_options": dict(logprobs=2 if with_lp else None, **sampling_options),
            "eos_token_ids": [] if eos is None else [eos]}


async def _collect(engine, ctx_cls, prompt, max_tokens=20, **kw):
    toks, lps, finish = [], [], None
    async for item in engine.generate(ctx_cls(_payload(prompt, max_tokens, **kw))):
        d = item.data or {}
        toks.extend(d.get("token_ids", []))
        lps.extend(d.get("log_probs") or [])
        finish = d.get("finish_reason") or finish
    return toks, lps, finish


def _port(weights, spec_k, **cfg):
    return TorchServingEngine(TCFG, weights[1], EngineConfig(**{**ENGINE, **cfg}, spec_k=spec_k),
                              device="cpu")


def _serve(engine, *requests, ctx_cls=Context):
    """Run the requests concurrently on ``engine``, close it, and return
    (results, metrics)."""
    async def go():
        return await asyncio.gather(*[_collect(engine, ctx_cls, *r[:1], **r[1]) for r in requests])

    try:
        return asyncio.run(go()), engine.metrics_snapshot()
    finally:
        engine.close()


@pytest.fixture(scope="module")
def spec_off(weights):
    """The port's spec-off streams of the cases below, once."""
    return {
        "greedy": _serve(_port(weights, 0), (REP_PROMPT, {}))[0][0],
        "logprobs": _serve(_port(weights, 0), (REP_PROMPT, {"with_lp": True}))[0][0],
        "penalties": _serve(_port(weights, 0), (REP_PROMPT, dict(
            frequency_penalty=0.7, presence_penalty=0.4)), (REP_PROMPT, {}))[0],
    }


# -- knobs, drafter, targets ------------------------------------------------------


@pytest.mark.parametrize("knob,raw", [
    ("DYN_TPU_SPEC_K", raw) for raw in (None, "", "garbage", "-3", "4", "999", "0")
] + [("DYN_TPU_SPEC_NGRAM", raw) for raw in (None, "junk", "0", "5", "99")])
def test_env_knob_clamps_equal_jax(monkeypatch, knob, raw):
    if raw is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, raw)
    assert drafter.env_spec_k() == jdrafter.env_spec_k()
    assert drafter.env_spec_ngram() == jdrafter.env_spec_ngram()
    assert (drafter.MAX_SPEC_K, drafter.MIN_NGRAM) == (jdrafter.MAX_SPEC_K, jdrafter.MIN_NGRAM)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drafter_equals_jax_over_seeded_streams(seed):
    """Drafts, ``would_draft`` and dormancy of both drafters over a random
    stream of a 4-token vocabulary (many repeats), fed in runs of 1-3
    tokens with random acceptance results."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 4, size=240).tolist()
    k, ngram = int(rng.integers(1, 6)), int(rng.integers(1, 5))
    d, jd = drafter.NgramDrafter(stream[:6], k, ngram), jdrafter.NgramDrafter(stream[:6], k, ngram)
    pos, drafted = 6, 0
    while pos < len(stream):
        assert d.draft() == jd.draft()
        assert d.would_draft() == jd.would_draft() == (d.draft() is not None)
        assert d.dormant == jd.dormant and len(d) == len(jd)
        prop = d.draft()
        if prop:
            a = int(rng.random() < 0.04)  # mostly rejected: the drafter goes dormant
            d.note_result(len(prop), a)
            jd.note_result(len(prop), a)
            drafted += len(prop)
        n = int(rng.integers(1, 4))
        d.extend(stream[pos:pos + n])
        jd.extend(stream[pos:pos + n])
        pos += n
    assert drafted >= drafter.DORMANT_MIN_DRAFTED and d.dormant and d.draft() is None


@pytest.mark.parametrize("case", ["greedy", "penalized", "logprobs"])
def test_speculative_targets_equal_jax(case):
    rng = np.random.default_rng(5)
    B, K1, V, n_top = 3, 5, 64, 3
    logits = rng.standard_normal((B, K1, V), dtype=np.float32) * 3
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    active = np.ones((B, K1), bool)
    active[1, 3:] = False  # a lane with two padding positions
    freq = np.array([0.7, 0.0, 1.3], np.float32)
    pres = np.array([0.4, 0.5, 0.0], np.float32)
    kw = dict(with_pen=case == "penalized", with_sample=False, with_lp=case == "logprobs",
              n_top=n_top)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    want = jsampling.speculative_targets(
        jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(active),
        jax.random.PRNGKey(0), jnp.zeros(B, jnp.int32), jnp.asarray(zeros),
        jnp.zeros(B, jnp.int32), jnp.asarray(ones), jnp.asarray(freq), jnp.asarray(pres), **kw)
    t = torch.from_numpy
    got = sampling.speculative_targets(
        t(logits), t(counts.copy()), t(active), [0] * B, [False] * B, 1, t(zeros),
        torch.zeros(B, dtype=torch.int32), t(ones), t(freq), t(pres), **kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # targets
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))  # counts
    for g, w in zip(got[1:-1], want[1:-1]):  # chosen lp, top ids, top lps
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# -- the engine -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_spec_streams(weights):
    """The JAX spec engine's results of a case, computed once per case:
    ``get(key, k, *requests, **engine_config)`` serves the requests
    concurrently on a JAX engine with ``spec_k = k``."""
    memo = {}

    def get(key, k, *requests, **cfg):
        if key not in memo:
            eng = JaxServingEngine(JCFG, weights[0],
                                   JaxEngineConfig(**{**ENGINE, **cfg}, spec_k=k))
            res, snap = _serve(eng, *requests, ctx_cls=JaxContext)
            assert snap["spec_drafted_tokens"] > 0
            memo[key] = res
        return memo[key]

    return get


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_greedy_equals_jax_spec_engine_and_spec_off(weights, spec_off, jax_spec_streams, k):
    (got,), snap = _serve(_port(weights, k), (REP_PROMPT, {}))
    (want,) = jax_spec_streams(f"greedy k={k}", k, (REP_PROMPT, {}))
    assert got[0] == spec_off["greedy"][0] == want[0]
    assert got[2] == spec_off["greedy"][2] == "length"
    assert snap["spec_drafted_tokens"] > 0 and snap["spec_accepted_tokens"] > 0
    assert snap["verify_dispatches"] > 0 and 0 < snap["spec_accept_rate"] <= 1


def test_spec_penalties_equal_spec_off(weights, spec_off, jax_spec_streams):
    """A penalized lane batched with a drafting one: every verify dispatch
    runs the penalized variant with real drafts, and the count fix after
    each (an ``index_put_`` of -1 here, ``_counts_fix_fn`` in JAX) keeps
    both streams equal to the JAX spec engine's and to spec off."""
    reqs = (REP_PROMPT, dict(frequency_penalty=0.7, presence_penalty=0.4)), (REP_PROMPT, {})
    results, snap = _serve(_port(weights, 4), *reqs)
    want = jax_spec_streams("penalties", 4, *reqs)
    assert [r[0] for r in results] == [r[0] for r in spec_off["penalties"]]
    assert [r[0] for r in results] == [r[0] for r in want]
    assert snap["spec_drafted_tokens"] > 0


def test_spec_penalized_lane_drafts_and_counts_stay_exact(weights, jax_spec_streams):
    """A penalized lane that drafts itself (penalties light enough to keep
    it repeating) with drafts rejected: after every verify dispatch its
    count row equals the counts of the tokens it emitted, so the fix took
    back each rejected target; its stream equals the JAX spec engine's and
    spec off's."""
    req = (REP_PROMPT, dict(frequency_penalty=0.2, presence_penalty=0.1))
    eng = _port(weights, 4)
    rows, verify = [], eng._verify_step

    def checked():
        n = eng.verify_dispatches
        verify()
        seq = eng._slots[0]
        if eng.verify_dispatches > n and seq is not None:
            want = np.bincount(seq.out_tokens, minlength=TCFG.vocab_size)
            rows.append(np.array_equal(eng._counts[0].numpy(), want))

    eng._verify_step = checked
    (got,), snap = _serve(eng, req)
    (want,), _ = _serve(_port(weights, 0), req)
    (jax_got,) = jax_spec_streams("penalized drafting lane", 4, req)
    assert snap["spec_accepted_tokens"] < snap["spec_drafted_tokens"]
    assert rows and all(rows)
    assert got[0] == want[0] == jax_got[0]


def test_spec_logprobs_equal_spec_off(weights, spec_off, jax_spec_streams):
    req = (REP_PROMPT, {"with_lp": True})
    (got,), snap = _serve(_port(weights, 4), req)
    (jax_got,) = jax_spec_streams("logprobs", 4, req)
    for want in (spec_off["logprobs"], jax_got):
        assert got[0] == want[0] and len(got[1]) == len(want[1]) == 20
        # verify scores through the chunk attention, decode through the
        # window: the same math in another f32 reduction order
        np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    assert snap["spec_drafted_tokens"] > 0


def test_spec_eos_cuts_a_verify_run(weights):
    """EOS emitted by a verify dispatch: the stream stops there, as spec off
    does. On this prompt the tiny model repeats 465, then emits 339 for the
    first time as a verify dispatch's target (drafts can only repeat
    earlier tokens, so the first occurrence of a token is a target)."""
    prompt, eos = [5, 4, 3, 2, 1], 339
    (ref,), _ = _serve(_port(weights, 0), (prompt, {"max_tokens": 24}))
    (got,), snap = _serve(_port(weights, 4), (prompt, {"max_tokens": 24, "eos": eos}))
    assert got[2] == "eos" and snap["verify_dispatches"] > 0
    assert got[0] == ref[0][: ref[0].index(eos) + 1] and len(got[0]) > 10


def test_spec_preemption_equals_spec_off(weights, jax_spec_streams):
    cfg = dict(max_slots=2, kv_block_size=8, max_model_len=48, num_kv_blocks=6,
               prefill_chunk=16)
    reqs = [(REP_PROMPT[:8], {"max_tokens": 18}), (REP_PROMPT[2:10], {"max_tokens": 18})]
    eng = _port(weights, 4, **cfg)
    got, snap = _serve(eng, *reqs)
    want, _ = _serve(_port(weights, 0, **cfg), *reqs)
    jax_got = jax_spec_streams("preemption", 4, *reqs, **cfg)
    assert eng.preemptions > 0
    assert [r[0] for r in got] == [r[0] for r in want] == [r[0] for r in jax_got]
    assert snap["spec_drafted_tokens"] > 0


def test_spec_over_int8_kv_pool_equals_spec_off(weights, jax_spec_streams):
    """Verify writes go through the int8 pool's per-token quantization and
    read the dequantized pages, as decode does: the same stream, and the
    JAX spec engine's over its int8 pool (its tests/test_engine_spec.py
    int8 case)."""
    req = (REP_PROMPT, {"max_tokens": 16})
    eng = _port(weights, 4, kv_dtype="int8")
    (got,), snap = _serve(eng, req)
    (want,), _ = _serve(_port(weights, 0, kv_dtype="int8"), req)
    (jax_got,) = jax_spec_streams("int8 pool", 4, req, kv_dtype="int8")
    assert eng.kv_quantized and snap["kv_quantized"] == 1
    assert got[0] == want[0] == jax_got[0] and snap["spec_drafted_tokens"] > 0


def test_spec_off_builds_nothing(weights, monkeypatch):
    monkeypatch.delenv("DYN_TPU_SPEC_K", raising=False)

    def _boom(*a, **kw):
        raise AssertionError("NgramDrafter constructed with speculation off")

    monkeypatch.setattr(engine_mod, "NgramDrafter", _boom)
    eng = TorchServingEngine(TCFG, weights[1], EngineConfig(**ENGINE), device="cpu")
    assert eng._spec_k == 0
    eng.warmup()
    (got,), snap = _serve(eng, (REP_PROMPT, {"max_tokens": 8}))
    assert len(got[0]) == 8 and eng._verify_fns == {}
    assert (snap["spec_drafted_tokens"], snap["spec_accepted_tokens"],
            snap["verify_dispatches"]) == (0, 0, 0)


def test_spec_env_knob_turns_speculation_on(weights, monkeypatch, spec_off):
    monkeypatch.setenv("DYN_TPU_SPEC_K", "3")
    eng = TorchServingEngine(TCFG, weights[1], EngineConfig(**ENGINE), device="cpu")
    assert eng._spec_k == 3
    eng.warmup()
    assert eng._verify_fns  # warmed only with speculation on
    (got,), snap = _serve(eng, (REP_PROMPT, {}))
    assert got[0] == spec_off["greedy"][0] and snap["spec_drafted_tokens"] > 0
