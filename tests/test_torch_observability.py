"""The port's engine and HTTP edge with the observability planes on, against
the JAX package's on the tiny preset in fp32 (the weights carried across
with ``params_from_numpy``):

- engine: the same requests, each under its own wire trace context, give
  the same spans per request (names, phases, parentage, attributes; with
  ``spec_k`` 2 the speculation counts on the decode span); with
  ``DYN_TPU_PROFILE=1`` and ``DYN_TPU_PROFILE_SAMPLE=1`` every dispatch has
  a timeline record and the chunk records' token totals are equal; and
  ``metrics_snapshot()`` grows every key the JAX engine's grows when the
  planes are on;
- edge: the port's ``HttpService`` and the JAX package's (aiohttp) over the
  engine pair answer the same streamed and unary requests, each with its
  own ``traceparent``: ``/live``, the metric names, labels and counts of
  ``/metrics``, the trace structure of ``/debug/traces`` and the keys of
  ``/debug/slo`` and ``/debug/profile`` (and its Chrome-trace tracks)."""

import asyncio
import dataclasses
import http.client
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.cli.run import _token_pipelines as jax_token_pipelines
from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.http.service import ModelManager as JaxModelManager
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models.llama import LLAMA_PRESETS, init_params
from dynamo_tpu.runtime import profiling as jprofiling
from dynamo_tpu.runtime import straggler as jstraggler
from dynamo_tpu.runtime import telemetry as jtelemetry
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.cli.run import make_pipelines
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.llm.http.service import HttpService, ModelManager
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.runtime import profiling, straggler, telemetry, tracing
from dynamo_tpu_torch.runtime.engine import Context

PLANES = {"DYN_TPU_PROFILE": "1", "DYN_TPU_PROFILE_SAMPLE": "1", "DYN_TPU_STRAGGLER": "1"}
OFF = {"DYN_TPU_TRACE": "0", "DYN_TPU_SLO": "0"}
ENGINE = dict(max_slots=2, kv_block_size=8, max_model_len=64, prefill_chunk=16, decode_steps=2)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8], [2, 7, 1, 8, 2, 8]]
REP_PROMPT = ([3, 1, 4, 1, 5, 9, 2, 6] * 4)[:24]


def _configs(**changes):
    jcfg = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=jnp.float32, **changes)
    tcfg = LlamaConfig(dtype=torch.float32, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LlamaConfig) if f.name != "dtype"})
    return jcfg, tcfg


def _reset_planes():
    for m in (tracing, jtracing, telemetry, jtelemetry):
        m.configure()
    for m in (profiling, jprofiling, straggler, jstraggler):
        m.reset_for_tests()


@pytest.fixture
def planes(monkeypatch):
    for k in list(PLANES) + list(OFF):
        monkeypatch.delenv(k, raising=False)
    _reset_planes()

    def arm(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        _reset_planes()

    yield arm
    monkeypatch.undo()
    _reset_planes()


# the fixture model directory's widths (tests/fixtures.py): its tokenizer
# serves the edge pair
WIDTHS = dict(vocab_size=436, intermediate_size=256)


def _engines(spec_k=0, seed=0, **cfg_changes):
    jcfg, tcfg = _configs(**cfg_changes)
    jparams = init_params(jax.random.PRNGKey(seed), jcfg)
    jeng = JaxServingEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, spec_k=spec_k))
    teng = TorchServingEngine(tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg),
                              EngineConfig(**ENGINE, spec_k=spec_k), device="cpu")
    return jeng, teng


def _wave(engine, common, ctx_cls, prompts, max_tokens):
    """The prompts at once, request i as ``req{i}`` under the wire trace
    context (``{i+1:02x}`` x 16, ``{i+1:02x}`` x 8)."""

    async def one(i, prompt):
        req = common.PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=common.StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=common.SamplingOptions(temperature=0.0))
        ctx = ctx_cls(req, request_id=f"req{i}")
        ctx.context.trace = (f"{i + 1:02x}" * 16, f"{i + 1:02x}" * 8)
        toks = []
        async for item in engine.generate(ctx):
            toks.extend((item.data or {}).get("token_ids", []))
        return toks

    async def all_():
        return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])

    return asyncio.run(all_())


def _spans(recorder, trace_id):
    """One trace's spans as (name, phase, parent's name or the wire span
    id, status, attributes), sorted by name."""
    (entry,) = recorder.traces(trace_id=trace_id)
    by_id = {s["span_id"]: s["name"] for s in entry["spans"]}
    return sorted((s["name"], s.get("phase"), by_id.get(s.get("parent_id"), s.get("parent_id")),
                   s["status"], s.get("attributes")) for s in entry["spans"])


def test_engine_and_edge_equal_jax(planes, model_dir):
    """One engine pair at ``spec_k`` 2 with every plane armed (tracing and
    SLO telemetry by default, the timeline timing every dispatch, the
    straggler feed; the seed's weights make the repeating prompt draft),
    first driven directly, then behind both HTTP services. (One test: the
    suite resets the JAX package's process-global planes between tests,
    under an engine that holds them.)"""
    planes(PLANES)
    jeng, teng = _engines(spec_k=2, seed=3, **WIDTHS)
    try:
        _engine_checks(jeng, teng)
        _edge_checks(jeng, teng, model_dir)
    finally:
        jeng.close()
        teng.close()


def _engine_checks(jeng, teng):
    """Two lanes: a repeating prompt (it drafts) and one that does not,
    through prefill chunks, decode and verify dispatches."""
    prompts = [REP_PROMPT, PROMPTS[0]]
    want = _wave(jeng, jcommon, JaxContext, prompts, 12)
    got = _wave(teng, tcommon, Context, prompts, 12)
    assert got == want
    drafted = 0
    for i in range(len(prompts)):
        tid = f"{i + 1:02x}" * 16
        spans = _spans(tracing.recorder(), tid)
        assert spans == _spans(jtracing.recorder(), tid)
        names = {s[0]: s for s in spans}
        assert set(names) == {"engine.request", "engine.queue_wait", "engine.prefill",
                              "engine.decode"}
        assert names["engine.request"][2] == f"{i + 1:02x}" * 8
        assert names["engine.request"][4]["output_tokens"] == 12
        assert names["engine.decode"][4]["tokens"] == 12
        drafted += names["engine.decode"][4].get("spec_drafted", 0)
    assert drafted > 0
    assert tracing.phase_summary().keys() == jtracing.phase_summary().keys()
    # every dispatch timed (DYN_TPU_PROFILE_SAMPLE=1): one record each, and
    # the prefill chunks advance the same tokens. A dispatch's record is
    # written after its tokens went out: wait for the engine threads' last
    tl, jtl = profiling.timeline(), jprofiling.timeline()
    deadline = time.monotonic() + 30
    while (tl.sampled_total, jtl.sampled_total) != (tl.dispatches_total, jtl.dispatches_total):
        assert time.monotonic() < deadline, "the engines never recorded their last dispatch"
        time.sleep(0.001)
    trecs, jrecs = tl.records(), jtl.records()
    jm, tm = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert tl.dispatches_total == tl.sampled_total == len(trecs)
    assert len(trecs) == teng.chunk_dispatches + teng.decode_dispatches + teng.verify_dispatches
    assert jtl.dispatches_total == jtl.sampled_total == len(jrecs)

    def chunk_tokens(recs):
        return sum(r["tokens"] for r in recs if r["phase"] == "chunk")

    assert chunk_tokens(trecs) == chunk_tokens(jrecs) > 0
    assert all(r["device_us"] > 0 and r["host_us"] >= r["device_us"] for r in trecs)
    assert {r["reqs"][0] for r in trecs if r.get("reqs")} <= {f"req{i}" for i in range(2)}
    assert teng.verify_dispatches > 0 and {"chunk", "decode", "verify"} == {
        r["phase"] for r in trecs}
    # a dispatch that advances no token (a verify whose lanes all finished)
    # carries no per-token sample
    assert 0 < tm["straggler_samples_total"] <= len(trecs) and tm["straggler_state"] == "ok"
    assert tm["spec_accept_rate"] == jm["spec_accept_rate"]


class _Served:
    """An asyncio server (started by ``start()``) on its own loop thread."""

    def __init__(self, service):
        self.loop = asyncio.new_event_loop()
        self.service = service
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.port = asyncio.run_coroutine_threadsafe(service.start(), self.loop).result(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.service.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body), headers or {})
    resp = conn.getresponse()
    out = resp.status, resp.read().decode()
    conn.close()
    return out


REQUESTS = [  # (path, body, traceparent)
    ("/v1/chat/completions", {"stream": True, "messages": [{"role": "user", "content": "hi"}]},
     "00-" + "a1" * 16 + "-" + "b1" * 8 + "-01"),
    ("/v1/completions", {"stream": True, "prompt": "the quick brown"},
     "00-" + "a2" * 16 + "-" + "b2" * 8 + "-01"),
    ("/v1/completions", {"stream": False, "prompt": "hello world"},
     "00-" + "a3" * 16 + "-" + "b3" * 8 + "-01"),
]
FAMILIES = ("dynamo_frontend_requests_total", "dynamo_frontend_inflight_requests",
            "dynamo_frontend_output_tokens_total",
            "dynamo_frontend_time_to_first_token_seconds_count",
            "dynamo_frontend_request_duration_seconds_count",
            "dynamo_frontend_inter_token_latency_seconds_count",
            "dynamo_phase_latency_seconds_count")


def _samples(text):
    """{(family, labels): value} of the families whose counts must agree."""
    out = {}
    for ln in text.splitlines():
        m = re.match(r"^([a-z_]+)(\{[^}]*\})? (\S+)$", ln)
        if m and m.group(1) in FAMILIES:
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _edge_checks(jeng, teng, model_dir):
    """The port's HttpService and the JAX package's over the engine pair,
    the same requests with their own traceparents, then the five routes."""
    name = "tiny"
    jchat, jcomp = jax_token_pipelines(JaxCard.from_local_path(model_dir), lambda: jeng)
    jman = JaxModelManager()
    jman.add_chat_model(name, jchat)
    jman.add_completions_model(name, jcomp)
    tchat, tcomp = make_pipelines(ModelDeploymentCard.from_local_path(model_dir), teng)
    tman = ModelManager()
    tman.add_chat_model(name, tchat)
    tman.add_completions_model(name, tcomp)
    served = [_Served(HttpService(tman, host="127.0.0.1", port=0)),
              _Served(JaxHttpService(jman, host="127.0.0.1", port=0))]
    try:
        _compare_routes(name, served[0].port, served[1].port)
    finally:
        for srv in served:
            srv.close()


def _compare_routes(name, port, jport):
    for p in (port, jport):
        for path, body, tp in REQUESTS:
            st, _ = _call(p, "POST", path, dict(body, model=name, max_tokens=6,
                                                nvext={"ignore_eos": True}),
                          {"traceparent": tp, "Content-Type": "application/json"})
            assert st == 200
    got = {path: _call(port, "GET", path) for path in ("/live", "/metrics", "/debug/traces",
                                                       "/debug/slo", "/debug/profile",
                                                       "/debug/profile?trace=1")}
    want = {path: _call(jport, "GET", path) for path in got}
    assert {p: s for p, (s, _) in got.items()} == {p: s for p, (s, _) in want.items()} == {
        p: 200 for p in got}
    assert json.loads(got["/live"][1]) == json.loads(want["/live"][1]) == {"live": True}
    samples = _samples(got["/metrics"][1])
    assert samples == _samples(want["/metrics"][1])
    assert samples[("dynamo_frontend_requests_total",
                    '{endpoint="completions",model="tiny",request_type="unary",status="success"}')] == 1
    assert samples[("dynamo_frontend_time_to_first_token_seconds_count", '{model="tiny"}')] == 3
    ids = [tp.split("-")[1] for _, _, tp in REQUESTS]
    # the flight recorders also hold the engine test's traces
    traces = [t for t in map(json.loads, got["/debug/traces"][1].splitlines())
              if t["trace_id"] in ids]
    jtraces = [t for t in map(json.loads, want["/debug/traces"][1].splitlines())
               if t["trace_id"] in ids]
    assert sorted(t["trace_id"] for t in traces) == sorted(t["trace_id"] for t in jtraces) == [
        "a1" * 16, "a2" * 16, "a3" * 16]
    for t, jt in zip(sorted(traces, key=lambda t: t["trace_id"]),
                     sorted(jtraces, key=lambda t: t["trace_id"])):
        shape = [(n, ph, parent, st, sorted(a)) for n, ph, parent, st, a in
                 ((n, ph, parent, st, attrs or {}) for n, ph, parent, st, attrs in
                  _spans_of(t))]
        assert shape == [(n, ph, parent, st, sorted(a)) for n, ph, parent, st, a in
                         ((n, ph, parent, st, attrs or {}) for n, ph, parent, st, attrs in
                          _spans_of(jt))]
        assert dict((s[0], s[2]) for s in shape)["http.edge"] == "b" + t["trace_id"][1] + (
            "b" + t["trace_id"][1]) * 7
    slo, jslo = json.loads(got["/debug/slo"][1]), json.loads(want["/debug/slo"][1])
    assert slo.keys() == jslo.keys() and slo["series"].keys() == jslo["series"].keys()
    assert ({(r["slo"], json.dumps(r["labels"])) for r in slo["slo"]}
            == {(r["slo"], json.dumps(r["labels"])) for r in jslo["slo"]})
    prof, jprof = json.loads(got["/debug/profile"][1]), json.loads(want["/debug/profile"][1])
    assert prof.keys() == jprof.keys() and prof["summary"].keys() == jprof["summary"].keys()
    assert prof["summary"]["phases"].keys() == jprof["summary"]["phases"].keys()
    assert prof["frontend_cpu_us_per_token"]["tokens"] == jprof["frontend_cpu_us_per_token"]["tokens"]

    def tracks(body):
        return sorted(e["args"]["name"] for e in json.loads(body)["traceEvents"]
                      if e.get("name") == "thread_name")

    assert tracks(got["/debug/profile?trace=1"][1]) == tracks(want["/debug/profile?trace=1"][1])


def _spans_of(entry):
    by_id = {s["span_id"]: s["name"] for s in entry["spans"]}
    return sorted((s["name"], s.get("phase"), by_id.get(s.get("parent_id"), s.get("parent_id")),
                   s["status"], s.get("attributes")) for s in entry["spans"])


def test_snapshot_keys_cover_jax_planes(planes):
    """The keys the planes add to the JAX engine's snapshot are in the
    port's, and the port's planes add exactly those and its gate-timeout
    count. (Keys of planes this slice does not port stay out of both
    sides: live migration, resume and the jit recompile counter.)"""
    planes(OFF)
    jeng, teng = _engines()
    off, toff = set(jeng.metrics_snapshot()), set(teng.metrics_snapshot())
    jeng.close()
    teng.close()
    planes(dict({k: "1" for k in OFF}, **PLANES))
    jeng, teng = _engines()
    on, ton = set(jeng.metrics_snapshot()), set(teng.metrics_snapshot())
    jeng.close()
    teng.close()
    added = on - off
    assert added and added <= ton
    assert ton - toff == added | {"dispatch_gate_timeouts"}
    assert {"decode_tokens_per_s", "step_time_ms", "batch_slot_util", "spec_accept_rate",
            "device_idle_frac", "straggler_state"} <= added
