"""The port's fail-slow feed (``dynamo_tpu_torch/runtime/straggler.py``) and
engine heartbeat (``runtime/health.py``) against the JAX package's: the
same dispatch feeds give equal EWMA gauges and debug dumps; the verdict
latch and the ``DYN_TPU_STRAGGLER`` gate agree over a table of env values;
with the gate unset the engine builds no detector, and with it set its
snapshot carries the gauges; the engine beats its heartbeat. (The JAX
module's arbiter and judging knobs come with the port's aggregator.)"""

import asyncio
import itertools

import pytest

from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime import straggler as jstraggler
from dynamo_tpu_torch.runtime import health, straggler

KNOBS = ("DYN_TPU_STRAGGLER", "DYN_TPU_STRAGGLER_FACTOR", "DYN_TPU_STRAGGLER_WINDOW",
         "DYN_TPU_STRAGGLER_MIN_PEERS", "DYN_TPU_STRAGGLER_TRIPS")
RING = straggler.StragglerDetector.RING


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    straggler.reset_for_tests()
    yield
    straggler.reset_for_tests()


FEEDS = {
    "mixed phases, a spike, a negative time": [
        (("chunk", "decode", "verify")[i % 3], 1000.0 + 37.0 * (i % 11) * (3 if i == 40 else 1),
         (0, 8, 32, 5)[i % 4]) for i in range(120)] + [("decode", -5.0, 8)],
    "token-free dispatches only": [("decode", 500.0 + i, 0) for i in range(20)],
    "one phase, a step change": [("decode", 200.0 if i < 30 else 900.0, 8) for i in range(60)],
    "past the debug ring": [(("chunk", "decode")[i % 2], 100.0 + (i * 7919) % 613, 1 + i % 9)
                            for i in range(RING + 88)],
}


@pytest.mark.parametrize("feed", list(FEEDS), ids=range(len(FEEDS)))
def test_detector_gauges_equal_jax(feed):
    a, b = straggler.StragglerDetector(), jstraggler.StragglerDetector()
    for phase, us, toks in FEEDS[feed]:
        a.note_dispatch(phase, us, toks)
        b.note_dispatch(phase, us, toks)
        assert a.gauges() == b.gauges()
    assert a.debug_dump() == b.debug_dump() and a.us_per_token() == b.us_per_token()


@pytest.mark.parametrize("state", ["ok", "suspect", "confirmed", "weird"])
def test_verdict_latch_equals_jax(state):
    try:
        straggler.set_verdict(state)
        jstraggler.set_verdict(state)
        assert straggler.verdict() == jstraggler.verdict()
        straggler.clear_verdict()
        jstraggler.clear_verdict()
        assert straggler.verdict() == jstraggler.verdict() == "ok"
    finally:
        jstraggler.reset_for_tests()


STRAGGLER_ENV = [
    {}, {"DYN_TPU_STRAGGLER": "1"},
    {"DYN_TPU_STRAGGLER": "1", "DYN_TPU_STRAGGLER_FACTOR": "1.0", "DYN_TPU_STRAGGLER_WINDOW": "0.01",
     "DYN_TPU_STRAGGLER_MIN_PEERS": "1", "DYN_TPU_STRAGGLER_TRIPS": "1000"},
    {"DYN_TPU_STRAGGLER": "on", "DYN_TPU_STRAGGLER_FACTOR": "-2", "DYN_TPU_STRAGGLER_WINDOW": "x",
     "DYN_TPU_STRAGGLER_MIN_PEERS": "0", "DYN_TPU_STRAGGLER_TRIPS": "2.5"},
    {"DYN_TPU_STRAGGLER": "0", "DYN_TPU_STRAGGLER_FACTOR": "7.5"},
]


@pytest.mark.parametrize("env", STRAGGLER_ENV, ids=range(len(STRAGGLER_ENV)))
def test_straggler_gate_equals_jax(monkeypatch, env):
    """The gate reads DYN_TPU_STRAGGLER as JAX's does, whatever the judging
    knobs (which only the aggregator's arbiter reads) say."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert straggler.enabled() == jstraggler.enabled()
    assert (straggler.maybe_detector() is None) == (jstraggler.maybe_from_env() is None)


def _tiny_engine(**kw):
    from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
    from dynamo_tpu_torch.models.llama import LLAMA_PRESETS, init_params

    cfg = LLAMA_PRESETS["tiny"]
    return TorchServingEngine(cfg, init_params(cfg, seed=0), EngineConfig(
        max_slots=2, kv_block_size=8, max_model_len=48, prefill_chunk=16, decode_steps=2),
        device="cpu")


def _serve(eng, n=6):
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def go():
        req = PreprocessedRequest(token_ids=list(range(3, 24)),
                                  stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
                                  sampling_options=SamplingOptions(temperature=0.0))
        return [i async for i in eng.generate(Context(req))]

    return asyncio.run(go())


@pytest.mark.parametrize("armed", [False, True])
def test_engine_straggler_feed_and_heartbeat(monkeypatch, armed):
    def boom(*a, **kw):
        raise AssertionError("a detector was built with the plane off")

    if armed:
        monkeypatch.setenv("DYN_TPU_STRAGGLER", "1")
    else:
        monkeypatch.setattr(straggler.StragglerDetector, "__init__", boom)
    eng = _tiny_engine()
    beats0 = eng.heartbeat.beats
    try:
        _serve(eng)
        m = eng.metrics_snapshot()
    finally:
        eng.close()
    assert eng.heartbeat.beats > beats0 and eng.heartbeat.age() < 60
    keys = {"dispatch_us_per_token_ewma", "straggler_samples_total", "straggler_state"}
    if not armed:
        assert eng._straggler is None and not keys & set(m)
        return
    dispatches = eng.chunk_dispatches + eng.decode_dispatches
    assert m["straggler_samples_total"] == dispatches > 0
    assert m["dispatch_us_per_token_ewma"] > 0 and m["straggler_state"] == "ok"


def test_heartbeat_equals_jax():
    a, b = health.EngineHeartbeat(), jhealth.EngineHeartbeat()
    for busy in itertools.islice(itertools.cycle([True, False, True]), 7):
        a.beat(busy)
        b.beat(busy)
        assert (a.beats, a.busy) == (b.beats, b.busy)
    assert 0 <= a.age() < 5 and a.__slots__ == b.__slots__
