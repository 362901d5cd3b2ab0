"""The port's profiling plane (``dynamo_tpu_torch/runtime/profiling.py``)
against the JAX package's ``runtime/profiling.py``: the same dispatch
records and events give an equal ``summary()``, ``gauges()``,
``device_idle_frac`` and Chrome-trace JSON (its ``source`` label aside);
``ProfilePolicy.from_env`` clamps alike over a table of env values; the
frontend CPU split and the lag sampler's gauges render alike; and with
``DYN_TPU_PROFILE`` unset neither the engine nor the HTTP service builds a
timeline, a frontend CPU accumulator, a lag sampler or a device timer. The
device timer's bookkeeping, which does not need the card: a quiesce waits
for the timed dispatch in flight and holds timing off, and a gate timeout
runs a doubling number of dispatches untimed before timing resumes."""

import asyncio
import json
import threading

import pytest

from dynamo_tpu.runtime import profiling as jprofiling
from dynamo_tpu_torch.runtime import profiling

KNOBS = ("DYN_TPU_PROFILE", "DYN_TPU_PROFILE_SAMPLE", "DYN_TPU_PROFILE_RING",
         "DYN_TPU_PROFILE_LAG_MS")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    profiling.reset_for_tests()
    yield
    profiling.reset_for_tests()


def _records():
    """A pipelined capture: chunks, decodes with a sampling stride, a
    verify, loop-lag samples, one step-counter reset and a clock skew."""
    out = []
    ts, step = 1.7e9, 0
    for i in range(40):
        phase = "chunk" if i < 3 else ("verify" if i % 11 == 0 else "decode")
        step += 1 if i != 25 else -30  # an engine restart resets the counter
        out.append(dict(phase=phase, step=step, batch=8 - i % 3, tokens=(8 - i % 3) * 4,
                        host_us=900.0 + 13 * i, device_us=2500.0 + (i % 7) * 111.0,
                        post_us=120.0 + i, alloc_us=float(i % 5), queue=i % 4,
                        reqs=[f"r{j}" for j in range(i % 10)],
                        traces=[f"t{j}" for j in range(i % 3)],
                        ts=ts + 0.01 * i - (0.02 if i == 30 else 0.0)))
        if i % 6 == 0:
            out.append(dict(phase="loop_lag", host_us=300.0 + i, ts=ts + 0.01 * i + 0.001))
    return out


def _timeline(m, sample_every=3):
    tl = m.StepTimeline(m.ProfilePolicy(enabled=True, sample_every=sample_every, ring_size=256))
    for _ in range(17):
        tl.should_sample()
    for r in _records():
        r = dict(r)
        tl.note_dispatch(r.pop("phase"), **r)
    tl.note_event("jit_compile", detail="decode S=8", phase="decode")
    tl.note_event("drain", detail="x")
    for e in tl._events:
        e["ts"] = 1.7e9 + 0.123  # wall-clock stamps: aligned for the comparison
    return tl


def test_summary_gauges_and_idle_equal_jax():
    got, want = _timeline(profiling), _timeline(jprofiling)
    assert got.summary() == want.summary()
    assert got.gauges() == want.gauges()
    recs = got.records()
    assert recs == want.records() and len(recs) == 47
    assert got.device_idle_frac(recs) == want.device_idle_frac(recs) > 0
    assert profiling.StepTimeline.device_idle_frac(recs[:1]) == 0.0
    assert got.events() == want.events()
    assert (got.dispatches_total, got.sampled_total, got.jit_compiles_total) == (
        want.dispatches_total, want.sampled_total, want.jit_compiles_total)


def test_sampling_stride_equals_jax():
    a = profiling.StepTimeline(profiling.ProfilePolicy(sample_every=3))
    b = jprofiling.StepTimeline(jprofiling.ProfilePolicy(sample_every=3))
    assert [a.should_sample() for _ in range(20)] == [b.should_sample() for _ in range(20)]


def test_chrome_trace_equal_jax():
    recs = _records()
    caps = [("worker-0", recs[:30], [{"ts": 1.7e9 + 0.05, "kind": "jit_compile",
                                      "detail": "chunk"}]),
            ("frontend", recs[30:] + [dict(phase="custom", step=1, batch=1, tokens=1,
                                           host_us=5.0, device_us=7.0, post_us=0.0,
                                           alloc_us=0.0, queue=0, ts=1.7e9 + 0.5)], [])]
    got, want = profiling.to_chrome_trace(caps), jprofiling.to_chrome_trace(caps)
    assert got.pop("otherData")["epoch_t0"] == want.pop("otherData")["epoch_t0"]
    assert got == want
    assert json.loads(profiling.chrome_trace_json(caps))["traceEvents"] == got["traceEvents"]
    assert profiling.to_chrome_trace([])["traceEvents"] == []


ENV_TABLE = [
    {}, {"DYN_TPU_PROFILE": "1"}, {"DYN_TPU_PROFILE": "off"},
    {"DYN_TPU_PROFILE": "1", "DYN_TPU_PROFILE_SAMPLE": "1", "DYN_TPU_PROFILE_RING": "10",
     "DYN_TPU_PROFILE_LAG_MS": "1"},
    {"DYN_TPU_PROFILE": "1", "DYN_TPU_PROFILE_SAMPLE": "0", "DYN_TPU_PROFILE_RING": "-1",
     "DYN_TPU_PROFILE_LAG_MS": "nan?"},
    {"DYN_TPU_PROFILE": "yes", "DYN_TPU_PROFILE_SAMPLE": "9999999",
     "DYN_TPU_PROFILE_RING": "999999999", "DYN_TPU_PROFILE_LAG_MS": "1e9"},
    {"DYN_TPU_PROFILE_SAMPLE": "2.5", "DYN_TPU_PROFILE_RING": "300"},
]


@pytest.mark.parametrize("env", ENV_TABLE, ids=range(len(ENV_TABLE)))
def test_policy_clamping_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = profiling.ProfilePolicy.from_env(), jprofiling.ProfilePolicy.from_env()
    assert (got.enabled, got.sample_every, got.ring_size, got.lag_ms) == (
        want.enabled, want.sample_every, want.ring_size, want.lag_ms)
    assert profiling.enabled() == jprofiling.enabled()
    assert (profiling.maybe_from_env() is None) == (jprofiling.maybe_from_env() is None)


def test_frontend_gauges_render_equal_jax():
    try:
        for m in (profiling, jprofiling):
            fc = m.frontend_cpu()
            for part, us, n in (("detokenize", 30.0, 4), ("serialize", 12.5, 1),
                                ("transport_write", 80.0, 1), ("serialize", 3.0, 0)):
                fc.note(part, us, tokens=n)
            lag = m.lag_sampler(0.05)
            lag.samples, lag.lag_ema_ms, lag.lag_max_ms = 3, 1.25, 4.5
        assert profiling.render_frontend_prometheus() == jprofiling.render_frontend_prometheus()
        got, want = profiling.dump_state(), jprofiling.dump_state()
        for d in (got, want):
            d["summary"].pop("phases")
        assert got == want
    finally:
        jprofiling.reset_for_tests()


def test_profiling_off_builds_nothing(monkeypatch, model_dir):
    """The zero-overhead guard: with DYN_TPU_PROFILE unset, the engine and
    the HTTP service answer a streamed request without constructing any
    part of the plane."""
    import http.client

    from dynamo_tpu_torch.cli.run import build_engine, build_parser, make_service
    from dynamo_tpu_torch.engine_torch import device_timer

    def boom(*a, **kw):
        raise AssertionError("the profiling plane was constructed while off")

    for cls in (profiling.StepTimeline, profiling.FrontendCpu, profiling.EventLoopLagSampler,
                device_timer.DeviceTimer):
        monkeypatch.setattr(cls, "__init__", boom)
    flags = build_parser().parse_args(["--model-path", model_dir, "--device", "cpu",
                                       "--port", "0", "--host", "127.0.0.1"])
    chat, comp, name, core = build_engine("torch", flags)
    service = make_service(chat, comp, name, flags)
    loop = asyncio.new_event_loop()

    async def serve_one():
        port = await service.start()

        def post():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/v1/chat/completions", json.dumps(
                {"model": name, "stream": True, "max_tokens": 4,
                 "messages": [{"role": "user", "content": "hi"}]}))
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            return resp.status, body

        try:
            return await loop.run_in_executor(None, post)
        finally:
            await service.stop()

    try:
        status, body = loop.run_until_complete(serve_one())
    finally:
        loop.close()
        core.close()
    assert status == 200 and b"data: [DONE]" in body
    assert core._timeline is None and core._device_timer is None and service._fcpu is None
    assert profiling.maybe_timeline() is None and profiling.maybe_lag_sampler() is None
    assert profiling.dump_state() == {"enabled": False, "summary": {}, "records": [],
                                      "events": []}


def _cpu_timer():
    import torch

    from dynamo_tpu_torch.engine_torch.device_timer import DeviceTimer

    return DeviceTimer(torch.device("cpu"))


def test_device_timer_quiesce_waits_for_the_timed_dispatch(monkeypatch):
    """A quiesce entered while a dispatch is timed returns only once that
    dispatch has ended; inside it no dispatch is timed (sampled or not);
    after it timing resumes."""
    timer = _cpu_timer()
    step = object()
    assert timer.ready(step, sampled=True)
    timer.begin()
    entered, inside = threading.Event(), []

    def pause():
        with timer.quiesce():
            entered.set()
            inside.append(timer.ready(step, sampled=True))

    t = threading.Thread(target=pause)
    t.start()
    assert not entered.wait(0.2)  # held back by the timed dispatch
    timer.end()
    t.join(30)
    assert entered.is_set() and inside == [False]
    assert not timer.ready(step, sampled=False) and timer.ready(step, sampled=True)
    timer.end()
    assert timer.device_us() >= 0.0
    timer.ready(step)  # a timed dispatch that never ends: a quiesce gives up
    monkeypatch.setattr("dynamo_tpu_torch.engine_torch.device_timer.QUIESCE_TIMEOUT_S", 0.05)
    with pytest.raises(TimeoutError):
        with timer.quiesce():
            pass
    timer.end()
    with timer.quiesce():  # and the failed one left no pause behind
        pass
    assert timer.ready(step)


def test_device_timer_resumes_after_a_gate_timeout(caplog):
    """After a gate timeout the next RESUME_AFTER dispatches run untimed,
    twice as many after a second, and then timing resumes; each timeout is
    counted and logged."""
    from dynamo_tpu_torch.engine_torch.device_timer import RESUME_AFTER

    timer = _cpu_timer()
    step = object()
    for n, skip in ((1, RESUME_AFTER), (2, 2 * RESUME_AFTER)):
        with caplog.at_level("ERROR"):
            timer._timed_out()
        assert timer.timeouts == n and f"next {skip} dispatches" in caplog.text
        assert not any(timer.ready(step) for _ in range(skip))
        assert timer.ready(step)
        timer.end()
