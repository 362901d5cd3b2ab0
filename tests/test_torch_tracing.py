"""The port's request-tracing plane (``dynamo_tpu_torch/runtime/tracing.py``)
against the JAX package's ``runtime/tracing.py``: ``traceparent`` parsing
and formatting over a table of inputs, malformed ones included; the same
span sequence under the same ``TracePolicy`` gives equal flight-recorder
dumps (names, phases, parentage, status, attributes, durations, pinning;
span and trace ids are random, so they are compared by structure); equal
phase-histogram text and summaries after the same observations; the
knobs' clamping over a table of env values; and with ``DYN_TPU_TRACE=0``
no span is allocated, by the module or by the port's engine."""

import asyncio
import json
import time

import pytest

from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu_torch.runtime import tracing

MODULES = (jtracing, tracing)
KNOBS = ("DYN_TPU_TRACE", "DYN_TPU_TRACE_RING", "DYN_TPU_TRACE_PINNED", "DYN_TPU_TRACE_SLOW_MS")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for m in MODULES:
        m.configure()
    yield
    monkeypatch.undo()
    for m in MODULES:
        m.configure()


TRACEPARENTS = [
    None, 17, b"00-" + b"a" * 32, "", "garbage", "00-short-short-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-01",  # upper case
    "  00-" + "ab" * 16 + "-" + "cd" * 8 + "-00  ",  # whitespace, flags 00
    "01-" + "12" * 16 + "-" + "34" * 8 + "-ff",  # another version byte
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",  # non-hex trace id
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",  # all-zero trace id
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",  # all-zero span id
    "00-" + "1" * 32 + "-" + "1" * 16,  # no flags
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",  # short trace id
    "00-" + "1" * 32 + "-" + "1" * 17 + "-01",  # long span id
    "00_" + "1" * 32 + "_" + "1" * 16 + "_01",  # wrong separator
]


@pytest.mark.parametrize("value", TRACEPARENTS, ids=range(len(TRACEPARENTS)))
def test_traceparent_parse_and_format_equal_jax(value):
    got, want = tracing.parse_traceparent(value), jtracing.parse_traceparent(value)
    assert got == want
    if want is not None:
        assert tracing.format_traceparent(got) == jtracing.format_traceparent(want)
        assert tracing.parse_traceparent(tracing.format_traceparent(got)) == got


@pytest.mark.parametrize("ctx", [None, ("ab" * 16, "cd" * 8), ("x", "y", "z"), "str"])
def test_format_traceparent_contexts_equal_jax(ctx):
    assert tracing.format_traceparent(ctx) == jtracing.format_traceparent(ctx)


ENV_TABLE = [
    {}, {"DYN_TPU_TRACE": "0"}, {"DYN_TPU_TRACE": "off"}, {"DYN_TPU_TRACE": "FALSE"},
    {"DYN_TPU_TRACE": "yes"}, {"DYN_TPU_TRACE": ""},
    {"DYN_TPU_TRACE_RING": "7", "DYN_TPU_TRACE_PINNED": "3", "DYN_TPU_TRACE_SLOW_MS": "12.5"},
    {"DYN_TPU_TRACE_RING": "0", "DYN_TPU_TRACE_PINNED": "-4", "DYN_TPU_TRACE_SLOW_MS": "-1"},
    {"DYN_TPU_TRACE_RING": "many", "DYN_TPU_TRACE_PINNED": "2.5", "DYN_TPU_TRACE_SLOW_MS": "x"},
]


@pytest.mark.parametrize("env", ENV_TABLE, ids=range(len(ENV_TABLE)))
def test_policy_clamping_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = tracing.TracePolicy.from_env(), jtracing.TracePolicy.from_env()
    assert ([getattr(got, a) for a in want.__slots__]
            == [getattr(want, a) for a in want.__slots__])


def _scenario(m):
    """One span sequence through module ``m`` under a small recorder: an
    edge span under a wire context with an engine request and its phase
    spans below it, an errored trace, a slow (pinned) one, a shed marker,
    then enough ordinary traces to overflow the ring."""
    m.configure(m.TracePolicy(ring_size=4, pinned_size=2, slow_ms=50.0))
    t = time.perf_counter() - 100.0
    edge = m.start_span("http.edge", parent=("ab" * 16, "cd" * 8),
                        attributes={"model": "tiny", "stream": True})
    req = m.record_span("engine.request", t, t + 0.03, parent=edge,
                        attributes={"prompt_tokens": 5, "output_tokens": 4,
                                    "finish_reason": "length"})
    m.record_span("engine.queue_wait", t, t + 0.001, parent=req, phase="queue_wait")
    m.record_span("engine.prefill", t + 0.001, t + 0.01, parent=req, phase="prefill")
    m.record_span("engine.decode", t + 0.01, t + 0.03, parent=req, phase="decode",
                  attributes={"tokens": 4})
    edge.add_event("first_token", index=0)
    edge.end("ok")
    first = m.recorder().traces(trace_id="ab" * 16)[0]
    # each trace's retroactive spans start a second after the last one's,
    # so that the recorder's start order is the same in both runs
    bad = m.start_span("http.edge", attributes={"model": "tiny"})
    m.record_span("engine.request", t + 1, t + 1.002, parent=bad, status="error")
    bad.end("error")
    slow = m.start_span("http.edge")
    m.record_span("engine.decode", t + 2, t + 2.2, parent=slow, phase="decode")
    slow.end()
    m.record_event_span("http.edge", status="overloaded", attributes={"shed": True})
    with pytest.raises(ValueError):
        with m.span("client.route", parent=slow):
            raise ValueError("boom")
    for i in range(6):
        s = m.start_span("http.edge", attributes={"i": i})
        m.record_span("engine.request", t + 3 + i, t + 3 + 0.001 * (i + 1) + i, parent=s)
        s.end()
    return m.recorder(), first


def _normalize(traces):
    """Traces with ids replaced by their order of appearance, wall-clock
    starts and edge durations (host timing) dropped, event times dropped."""
    out = []
    for tr in traces:
        ids = {}
        spans = []
        for s in tr["spans"]:
            ids.setdefault(s["span_id"], len(ids))
        for s in tr["spans"]:
            d = {k: v for k, v in s.items()
                 if k not in ("trace_id", "span_id", "parent_id", "start", "duration_ms", "events")}
            d["parent"] = ids.get(s.get("parent_id"), s.get("parent_id"))
            if s["name"] != "http.edge" and s["name"] != "client.route":
                d["duration_ms"] = s.get("duration_ms")  # retroactive: given
            d["events"] = [e["name"] for e in s.get("events", [])]
            spans.append(d)
        out.append({"pinned": tr["pinned"], "spans": spans})
    return out


def test_flight_recorder_dumps_equal_jax():
    (got, first), (want, jfirst) = _scenario(tracing), _scenario(jtracing)
    assert len(got) == len(want) and got.dropped == want.dropped > 0
    assert _normalize(got.traces()) == _normalize(want.traces())
    errored = _normalize(got.traces(errored=True))
    assert errored == _normalize(want.traces(errored=True)) and errored
    assert _normalize(got.traces(limit=2)) == _normalize(want.traces(limit=2))
    lines = got.dump_jsonl().splitlines()
    assert len(lines) == len(want.dump_jsonl().splitlines())
    assert all(json.loads(ln)["spans"] for ln in lines)
    # the wire-context trace (evicted since by the ordinary ones): its edge
    # span's parent is the wire span id, and its tree renders alike
    assert _normalize([first]) == _normalize([jfirst])
    assert {s["name"]: s.get("parent_id") for s in first["spans"]}["http.edge"] == "cd" * 8
    assert all(t["trace_id"] != "ab" * 16 for t in got.traces())
    shape = lambda txt: [ln.split("  ")[0] for ln in txt.splitlines()]  # noqa: E731
    assert shape(tracing.render_trace(first)) == shape(jtracing.render_trace(jfirst))


SAMPLES = [("ttft", 0.0004), ("ttft", 0.2), ("decode", 1.7), ("decode", 45.0), ("decode", 90.0),
           ("queue_wait", 0.0), ("inter_token", 0.003), ("inter_token", 0.003),
           ("spec_accept", 0.5), ("prefill", 0.05)]


def test_phase_metrics_equal_jax():
    for m in MODULES:
        for phase, sec in SAMPLES:
            m.observe_phase(phase, sec)
    assert tracing.render_phase_metrics() == jtracing.render_phase_metrics()
    assert tracing.phase_summary() == jtracing.phase_summary()
    # span ends feed the same histogram
    for m in MODULES:
        m.record_span("engine.prefill", 0.0, 0.02, phase="prefill")
    assert tracing.render_phase_metrics() == jtracing.render_phase_metrics()


def test_trace_disabled_allocates_no_span(monkeypatch):
    """DYN_TPU_TRACE=0: every entry point returns None before a Span is
    built, and the port's engine serves a request without building one."""
    from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LLAMA_PRESETS, init_params
    from dynamo_tpu_torch.runtime.engine import Context

    monkeypatch.setenv("DYN_TPU_TRACE", "0")
    tracing.configure()

    def boom(*a, **kw):
        raise AssertionError("a span was allocated with tracing off")

    monkeypatch.setattr(tracing.Span, "__init__", boom)
    assert tracing.start_span("x") is None
    assert tracing.record_span("x", 0.0, 1.0, phase="decode") is None
    assert tracing.record_event_span("x", status="error") is None
    with tracing.span("x") as s:
        assert s is None
    cfg = LLAMA_PRESETS["tiny"]
    eng = TorchServingEngine(cfg, init_params(cfg, seed=0), EngineConfig(
        max_slots=2, kv_block_size=8, max_model_len=48, prefill_chunk=16, decode_steps=2),
        device="cpu")

    async def go():
        req = PreprocessedRequest(token_ids=[3, 1, 4, 1, 5],
                                  stop_conditions=StopConditions(max_tokens=4, ignore_eos=True),
                                  sampling_options=SamplingOptions(temperature=0.0))
        return [i async for i in eng.generate(Context(req))]

    try:
        items = asyncio.run(go())
    finally:
        eng.close()
    assert items[-1].data["finish_reason"] == "length"
    assert len(tracing.recorder()) == 0
