"""The port's telemetry plane (``dynamo_tpu_torch/runtime/telemetry.py``) and
HTTP service metrics (``llm/http/metrics.py``) against the JAX package's:
``TimeSeries``, ``MetricStore`` and ``SloEngine`` fed the same writes under
one injected clock give equal windowed sums, rates, averages, percentiles
and fractions, equal burn rates and page/ticket states and an equal
``dump_state()`` (``build_info`` aside: the port names torch's and CUDA's
versions where the JAX package names jax's, the one intended difference);
the knobs clamp alike over a table of env values, and so does every
parser of the port's ``runtime/envknobs.py`` against the JAX module's; and
the same ``InflightGuard`` traffic renders the same ``/metrics``
exposition."""

import math

import pytest

from dynamo_tpu.llm.http import metrics as jmetrics
from dynamo_tpu.runtime import envknobs as jenvknobs
from dynamo_tpu.runtime import telemetry as jtelemetry
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu_torch.llm.http import metrics
from dynamo_tpu_torch.runtime import envknobs, telemetry, tracing

KNOBS = ("DYN_TPU_SLO", "DYN_TPU_SLO_FAST_S", "DYN_TPU_SLO_MID_S", "DYN_TPU_SLO_SLOW_S",
         "DYN_TPU_SLO_BURN_FAST", "DYN_TPU_SLO_BURN_SLOW", "DYN_TPU_SLO_TTFT_MS",
         "DYN_TPU_SLO_ITL_MS", "DYN_TPU_TRACE")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for m in (telemetry, jtelemetry, tracing, jtracing):
        m.configure()
    yield
    monkeypatch.undo()
    for m in (telemetry, jtelemetry, tracing, jtracing):
        m.configure()


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


POLICY = dict(fast_window=3.0, mid_window=12.0, slow_window=60.0, burn_fast=2.0,
              burn_slow=1.5, ttft_target_ms=200.0, itl_target_ms=20.0)


def _feed(m, clock, store):
    """Twelve seconds of edge traffic for two models, a latency cliff in
    the middle, then quiet: the same writes in both modules."""
    for step in range(40):
        clock.t += 0.3
        bad = 12 <= step < 24
        for model in ("a", "b"):
            store.series("ttft_ms", model=model).observe(900.0 if bad and model == "a" else 80.0)
            store.series("itl_ms", model=model).observe(35.0 if bad else 4.0 + step % 3)
            store.series("requests_total", model=model).inc()
            if bad and step % 4 == 0:
                store.series("requests_errored", model=model).inc()
            if step % 9 == 0:
                store.series("requests_shed", model=model).inc()
        store.series("worker_available").set(0.0 if bad and step % 2 else 1.0)
        store.series("queue_depth").set(step % 5)


def _engines():
    out = []
    for m in (telemetry, jtelemetry):
        clock = Clock()
        pol = m.TelemetryPolicy(**POLICY)
        store = m.declare_standard_series(m.MetricStore(pol, clock=clock))
        _feed(m, clock, store)
        out.append((m, clock, store, m.SloEngine(store, pol)))
    return out


WINDOWS = (0.5, 3.0, 12.0, 60.0, 1e5)


@pytest.mark.parametrize("name,labels", [("ttft_ms", {"model": "a"}), ("itl_ms", {"model": "b"}),
                                         ("requests_total", {"model": "a"}),
                                         ("requests_errored", {"model": "a"}),
                                         ("worker_available", {}), ("queue_depth", {})])
def test_time_series_windows_equal_jax(name, labels):
    (_, _, store, _), (_, _, jstore, _) = _engines()
    s, js = store.series(name, **labels), jstore.series(name, **labels)
    assert s.kind == js.kind and s.bounds == js.bounds
    for w in WINDOWS:
        assert s.window_sum(w) == js.window_sum(w)
        assert s.window_count(w) == js.window_count(w)
        assert s.window_rate(w) == js.window_rate(w)
        assert s.window_avg(w) == js.window_avg(w)
        if s.kind == "histogram":
            for q in (0.5, 0.9, 0.95, 0.99):
                assert s.window_percentile(q, w) == js.window_percentile(q, w)
            for thr in (1.0, 20.0, 200.0, 1e9):
                assert s.window_fraction_le(thr, w) == js.window_fraction_le(thr, w)
    assert s.last() == js.last()
    assert s.dump(WINDOWS) == js.dump(WINDOWS)


def test_bucketed_ingest_and_bounds_check_equal_jax():
    for m in (telemetry, jtelemetry):
        s = m.TimeSeries("h", m.HISTOGRAM, 1.0, 8, bounds=(1.0, 10.0), clock=Clock())
        s.observe_bucketed([2, 0, 3], delta_sum=40.0)
        s.observe_bucketed([1, -5, 1], delta_sum=12.5)
        with pytest.raises(ValueError):
            s.observe_bucketed([1, 2])
        with pytest.raises(ValueError):
            m.TimeSeries("x", "summary", 1.0, 4)
    a = telemetry.TimeSeries("h", "histogram", 1.0, 8, bounds=(1.0, 10.0), clock=Clock())
    b = jtelemetry.TimeSeries("h", "histogram", 1.0, 8, bounds=(1.0, 10.0), clock=Clock())
    for s in (a, b):
        s.observe_bucketed([2, 0, 3], delta_sum=40.0)
    assert a.dump((5.0,)) == b.dump((5.0,))


def test_slo_burn_rates_and_states_equal_jax():
    (m, clock, store, engine), (jm, jclock, jstore, jengine) = _engines()
    seen = set()
    for _ in range(30):  # recovery: the page clears, the ticket drains
        got, want = engine.report(), jengine.report()
        assert got == want
        seen |= {r["state"] for r in got}
        clock.t += 2.0
        jclock.t += 2.0
        for s_ in (store, jstore):
            s_.series("ttft_ms", model="a").observe(50.0)
            s_.series("requests_total", model="a").inc()
    assert {"alert", "ok"} <= seen
    assert store.dump() == jstore.dump()


ENV_TABLE = [
    {}, {"DYN_TPU_SLO": "0"}, {"DYN_TPU_SLO": "no"}, {"DYN_TPU_SLO": "1"},
    {"DYN_TPU_SLO_FAST_S": "5", "DYN_TPU_SLO_MID_S": "2", "DYN_TPU_SLO_SLOW_S": "1"},
    {"DYN_TPU_SLO_FAST_S": "0", "DYN_TPU_SLO_MID_S": "-3", "DYN_TPU_SLO_SLOW_S": "junk"},
    {"DYN_TPU_SLO_BURN_FAST": "3.5", "DYN_TPU_SLO_BURN_SLOW": "0",
     "DYN_TPU_SLO_TTFT_MS": "1e3", "DYN_TPU_SLO_ITL_MS": "-5"},
    {"DYN_TPU_SLO_FAST_S": "0.0001", "DYN_TPU_SLO_SLOW_S": "1e9"},
]


@pytest.mark.parametrize("env", ENV_TABLE, ids=range(len(ENV_TABLE)))
def test_policy_clamping_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = telemetry.TelemetryPolicy.from_env(), jtelemetry.TelemetryPolicy.from_env()
    assert [getattr(got, a) for a in want.__slots__] == [getattr(want, a) for a in want.__slots__]
    assert got.ring_spec() == want.ring_spec()


def _global_store(m, clock):
    """The module's process-global store and SLO engine, on ``clock``."""
    m.configure(m.TelemetryPolicy(**POLICY))
    m._STORE = m.declare_standard_series(m.MetricStore(m.policy(), clock=clock))
    return m.slo_engine()


def test_dump_state_equal_jax_but_build_info():
    for m in (telemetry, jtelemetry):
        clock = Clock()
        _global_store(m, clock)
        for i in range(20):
            clock.t += 0.25
            m.observe_latency("ttft_ms", 40.0 + 30 * i, model="tiny")
            m.observe_latency("itl_ms", 3.0 + i % 4, model="tiny", tenant="gold")
            m.count_request(("success", "error", "overloaded")[i % 3], model="tiny")
    got, want = telemetry.dump_state(), jtelemetry.dump_state()
    assert got.pop("build") != want.pop("build")
    for d in (got, want):
        assert d.pop("uptime_s") >= 0
    assert got == want and got["series"] and got["slo"]
    build = telemetry.build_info()
    assert set(build) == {"version", "python", "torch", "cuda"}
    assert set(jtelemetry.build_info()) == {"version", "python", "jax"}
    assert build["python"] == jtelemetry.build_info()["python"]
    text = telemetry.render_process_info()
    assert "dynamo_uptime_seconds " in text and 'dynamo_build_info{cuda="' in text
    assert telemetry.render_cluster_metrics() == jtelemetry.render_cluster_metrics() == ""


def test_slo_off_samples_nothing(monkeypatch):
    monkeypatch.setenv("DYN_TPU_SLO", "0")
    telemetry.configure()

    def boom(*a, **kw):
        raise AssertionError("a series was built with the SLO plane off")

    monkeypatch.setattr(telemetry.MetricStore, "__init__", boom)
    telemetry.observe_latency("ttft_ms", 5.0, model="m")
    telemetry.count_request("error", model="m")
    assert telemetry.dump_state()["enabled"] is False and "series" not in telemetry.dump_state()


def _traffic(mod):
    """The same requests through an InflightGuard of ``mod``'s metrics."""
    sm = mod.ServiceMetrics()
    with sm.inflight_guard("tiny", "chat/completions", "stream") as g:
        for _ in range(5):
            g.mark_chunk()
            g.count_tokens()
        g.mark_ok()
    with sm.inflight_guard("tiny", "completions", "unary") as g:
        g.mark_first_token()
        g.count_tokens(3)
        g.mark_ok()
    with sm.inflight_guard("tiny", "completions", "stream") as g:
        g.mark_shed()
    with pytest.raises(RuntimeError):
        with sm.inflight_guard("other", "chat/completions", "stream"):
            raise RuntimeError("boom")
    return sm


def _structure(text: str) -> list:
    """Exposition lines with timing-dependent values masked (histogram sums
    and bucket counts of the duration histograms), without the uptime and
    build lines and without the control-plane section, which comes with
    the port's RPC runtime."""
    out = []
    for ln in text.splitlines():
        if (ln.startswith("dynamo_uptime_seconds ") or ln.startswith("dynamo_build_info")
                or "dynamo_control_plane" in ln):
            continue
        name = ln.split("{")[0].split(" ")[0]
        if not ln.startswith("#") and ("_seconds" in name and not name.endswith("_count")):
            ln = ln.rsplit(" ", 1)[0]  # a time: its value masked
        out.append(ln)
    return out


def test_service_metrics_exposition_equal_jax():
    got, want = _traffic(metrics).render(), _traffic(jmetrics).render()
    assert _structure(got) == _structure(want)
    assert metrics.fmt_labels({"b": 'x"y\nz\\', "a": 1}) == jmetrics.fmt_labels(
        {"b": 'x"y\nz\\', "a": 1})
    assert 'dynamo_frontend_requests_total{endpoint="completions",model="tiny",' \
           'request_type="stream",status="overloaded"} 1' in got
    assert 'dynamo_frontend_inflight_requests{model="other"} 0' in got
    # the SLO store saw the same requests
    assert telemetry.dump_state()["series"].keys() == jtelemetry.dump_state()["series"].keys()
    assert math.isclose(telemetry.store().series("requests_total", model="tiny").window_sum(1e9),
                        3.0)


# each parser of the port's envknobs with the arguments it is called with
PARSERS = [("env_raw", ("fallback",)), ("env_flag", (True,)), ("env_flag", (False,)),
           ("env_pos_int", (7,)), ("env_nonneg_int", (7,)), ("env_pos_float", (2.5,)),
           ("env_clamped_int", (64, 2, 100)), ("env_clamped_float", (30.0, 0.2, 3600.0))]
RAW = [None, "", "0", "-3", "5", "2.5", "1e9", "abc", "off", " 12 "]


@pytest.mark.parametrize("raw", RAW, ids=range(len(RAW)))
def test_env_parsers_equal_jax(monkeypatch, raw):
    """Every parser of the port's envknobs degrades, clamps and parses a
    raw value as the JAX module's parser of the same name."""
    name = "DYN_TPU_TEST_KNOB"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert {n for n in dir(envknobs) if n.startswith("env_")} == {n for n, _ in PARSERS}
    for fn, args in PARSERS:
        assert getattr(envknobs, fn)(name, *args) == getattr(jenvknobs, fn)(name, *args), fn
