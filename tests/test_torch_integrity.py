"""The port's integrity plane against the JAX package's, on the tiny preset
in fp32: the knob tables, the block checksums (bf16 and int8 pages, and the
engine's seal checksums), ``verify_pages``, the trip tracker's window and
latch, the ``DYN_TPU_KV_INTEGRITY=0`` zero-overhead gate, a corrupted
host-tier entry (a prefix miss, with streams equal to the JAX engine's
under the same ``FaultRule``), and the poison drill (the same tokens,
marker and trip counts as the JAX engine, at the engine and through the
in-process HTTP frontend)."""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine_jax.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine_jax.engine import JaxServingEngine
from dynamo_tpu.models.llama import LLAMA_PRESETS, init_params
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import integrity as jintegrity
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine_torch.engine import EngineConfig, TorchServingEngine
from dynamo_tpu_torch.engine_torch.weights import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.runtime import faults, integrity
from dynamo_tpu_torch.runtime.engine import Context

JCFG = dataclasses.replace(LLAMA_PRESETS["tiny"], dtype=jnp.float32)
TCFG = LlamaConfig(dtype=torch.float32, **{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(LlamaConfig) if f.name != "dtype"
})
# the JAX package's own integrity drills' engine shapes (tests/test_integrity.py)
HOST_TIER = dict(max_slots=2, kv_block_size=8, num_kv_blocks=12, host_cache_blocks=16,
                 max_model_len=128, prefill_chunk=16, decode_steps=2)
POISON = dict(max_slots=2, kv_block_size=8, max_model_len=256, prefill_chunk=16,
              decode_steps=2)
PROMPT_A = [(3 * i + 1) % 97 for i in range(48)]
PROMPT_B = [(5 * i + 2) % 97 for i in range(48)]


@pytest.fixture(autouse=True)
def _reset_trackers():
    integrity.reset_for_tests()
    jintegrity.reset_for_tests()
    yield
    integrity.reset_for_tests()
    jintegrity.reset_for_tests()
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(scope="module")
def weights():
    jparams = init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _payload(toks, max_tokens):
    return {"token_ids": list(toks),
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
            "sampling_options": {"temperature": 0.0}}


async def _drive(engine, ctx_cls, prompt, max_tokens):
    """(tokens, the migrating marker or None, finish reason or None)."""
    toks, marker, finish = [], None, None
    async for item in engine.generate(ctx_cls(_payload(prompt, max_tokens))):
        assert not item.is_error, item.error_message()
        d = item.data or {}
        if "migrating" in d:
            marker = d["migrating"]
            continue
        toks.extend(d.get("token_ids", []))
        finish = d.get("finish_reason") or finish
    return toks, marker, finish


def _run(engine, ctx_cls, prompt, max_tokens):
    return asyncio.run(_drive(engine, ctx_cls, prompt, max_tokens))


def _engines(weights, cfg, kv_dtype=None):
    jparams, tparams = weights
    jeng = JaxServingEngine(JCFG, jparams, JaxEngineConfig(**cfg, kv_dtype=kv_dtype))
    teng = TorchServingEngine(TCFG, tparams, EngineConfig(**cfg, kv_dtype=kv_dtype),
                              device="cpu")
    return jeng, teng


# -- knobs and checksums -------------------------------------------------------


ENV_CASES = [
    {}, {"DYN_TPU_KV_INTEGRITY": "0"}, {"DYN_TPU_KV_INTEGRITY": "off"},
    {"DYN_TPU_KV_INTEGRITY": "1"}, {"DYN_TPU_INTEGRITY_TRIPS": "junk"},
    {"DYN_TPU_INTEGRITY_TRIPS": "-2"}, {"DYN_TPU_INTEGRITY_TRIPS": "9999"},
    {"DYN_TPU_INTEGRITY_TRIPS": "5"}, {"DYN_TPU_INTEGRITY_WINDOW": "0"},
    {"DYN_TPU_INTEGRITY_WINDOW": "99999"}, {"DYN_TPU_INTEGRITY_LOGIT_LIMIT": "1"},
    {"DYN_TPU_INTEGRITY_LOGIT_LIMIT": "2e12"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items())
                         or "unset")
def test_policy_env_table_equals_jax(monkeypatch, env):
    for name in (integrity.ENV_KV_INTEGRITY, integrity.ENV_TRIPS, integrity.ENV_WINDOW,
                 integrity.ENV_LOGIT_LIMIT):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(integrity.IntegrityPolicy.from_env()) == \
        dataclasses.asdict(jintegrity.IntegrityPolicy.from_env())
    got, want = integrity.maybe_from_env(), jintegrity.maybe_from_env()
    assert (got is None) == (want is None)
    assert integrity.enabled() == jintegrity.enabled()
    assert integrity.WATCHDOG_TOKEN == jintegrity.WATCHDOG_TOKEN


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_page_checksums_equal_jax(kind):
    rng = np.random.default_rng(3)
    shape = (2, 5, 8, 2, 16)  # [L, n, bs, KVH, D]
    if kind == "bf16":
        vals = [rng.standard_normal(shape, dtype=np.float32) for _ in range(2)]
        tk, tv = (torch.from_numpy(x).bfloat16() for x in vals)
        jk, jv = (x.astype(ml_dtypes.bfloat16) for x in vals)
        tks = tvs = jks = jvs = None
    else:
        jk, jv = (rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2))
        jks, jvs = (rng.random(shape[:3], dtype=np.float32) for _ in range(2))
        tk, tv, tks, tvs = (torch.from_numpy(x) for x in (jk, jv, jks, jvs))
    got = integrity.page_checksums(tk, tv, tks, tvs)
    assert got == jintegrity.page_checksums(jk, jv, jks, jvs)
    assert len(set(got)) == shape[1]
    one = (tks[:, 2], tvs[:, 2]) if tks is not None else ()
    assert integrity.entry_checksum(tk[:, 2], tv[:, 2], *one) == got[2]


def test_verify_pages_semantics_match_jax():
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 3, 4, 1, 8), dtype=np.float32)
    v = rng.standard_normal((2, 3, 4, 1, 8), dtype=np.float32)
    crcs = integrity.page_checksums(torch.from_numpy(k), torch.from_numpy(v))
    cases = [None, crcs, [None, -1, crcs[2]], crcs[:2], [crcs[0], crcs[1] ^ 1, crcs[2]]]
    for mod in (integrity, jintegrity):
        outcomes = []
        for c in cases:
            try:
                mod.verify_pages(k, v, None, c, where="test")
                outcomes.append("ok")
            except mod.KvIntegrityError as e:
                outcomes.append(str(e).split(":")[0])
        assert outcomes == ["ok", "ok", "ok", "ok", "KV block 1 failed its content checksum (test)"]


def test_tracker_window_and_latch_match_jax():
    def drive(mod):
        now = [0.0]
        t = mod.IntegrityTracker(mod.IntegrityPolicy(trip_threshold=3, trip_window=10.0),
                                 clock=lambda: now[0])
        out = []
        for dt, kind in [(0, "kv"), (20, "watchdog"), (1, "kv"), (1, "watchdog"),
                         (0, "kv")]:
            now[0] += dt
            out.append((t.note_trip(kind, where="x"), t.quarantined))
        out.append(t.counters())
        t.clear_quarantine("trips")
        out.append((t.quarantined, t.quarantine_reason))
        t.quarantine("store", reason="operator")
        t.clear_quarantine()
        out.append((t.quarantined, t.note_trip("kv"), t.quarantines_total))
        return out

    got = drive(integrity)
    assert got == drive(jintegrity)
    # the third trip within 10 s latches; the first fell out of the window
    assert [q for _, q in got[:5]] == [False, False, False, True, True]
    assert got[5] == {"kv_integrity_failures_total": 3, "watchdog_trips_total": 2,
                      "kv_integrity_remote_failures_total": 0, "quarantined": 1}
    assert integrity.counters() == jintegrity.counters()  # constructor-free zeros


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_seal_checksums_equal_jax_page_checksums(weights, kv_dtype):
    """Every block the port engine sealed carries the crc that the JAX
    package's ``page_checksums`` gives for the same pages of the pool."""
    eng = TorchServingEngine(TCFG, weights[1], EngineConfig(**POISON, kv_dtype=kv_dtype),
                             device="cpu")
    try:
        toks, _, _ = _run(eng, Context, list(range(3, 27)), 12)
        assert len(toks) == 12
        bids = sorted(eng.allocator._crc_of)
        # 24 prompt + 12 generated = 36 tokens: 4 sealed 8-blocks
        assert len(bids) >= 4 and eng.crc_blocks >= 4
        got = [eng.allocator.crc_of_block(b) for b in bids]
        names = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" else ("k", "v")
        pages = [eng.cache[n][:, bids].numpy() for n in names]
        assert got == jintegrity.page_checksums(*pages)
    finally:
        eng.close()


def test_integrity_off_constructs_and_computes_nothing(weights, monkeypatch):
    """DYN_TPU_KV_INTEGRITY=0: no policy, tracker, checksum callback or crc
    thread; the step functions take no watchdog argument; the streams are
    those of the default engine, which runs the plane."""
    on = TorchServingEngine(TCFG, weights[1], EngineConfig(**HOST_TIER), device="cpu")
    try:
        assert on._integrity is not None and on._wd_args() and on._wd_steady()
        want = _run(on, Context, PROMPT_A, 8)
        assert on.watchdog_trips == 0
    finally:
        on.close()

    monkeypatch.setenv("DYN_TPU_KV_INTEGRITY", "0")

    def _boom(*a, **kw):
        raise AssertionError("constructed or computed with integrity off")

    for name in ("IntegrityPolicy", "IntegrityTracker", "page_checksums", "entry_checksum"):
        monkeypatch.setattr(integrity, name, _boom)
    off = TorchServingEngine(TCFG, weights[1], EngineConfig(**HOST_TIER), device="cpu")
    try:
        assert off._integrity is None and off._wd_steady() == ()
        assert off.allocator._checksum is None and off._wd_args() == ()
        assert _run(off, Context, PROMPT_A, 8) == want
        _run(off, Context, PROMPT_B, 4)  # spills A's blocks to the host tier
        assert off.host_pool.offloaded > 0
        assert off._crc_pool is None and off.allocator._crc_of == {}
        assert all(e[4] is None for e in off.host_pool._data.values())
    finally:
        off.close()


def _host_tier_drill(engine, ctx_cls):
    first = _run(engine, ctx_cls, PROMPT_A, 4)
    _run(engine, ctx_cls, PROMPT_B, 4)  # evicts A's blocks to the host tier
    deadline = time.monotonic() + 30
    while not len(engine.host_pool) and time.monotonic() < deadline:
        time.sleep(0.01)
    hits = engine.host_pool.hits
    again = _run(engine, ctx_cls, PROMPT_A, 4)
    return first, again, engine.host_pool.hits - hits


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
def test_host_rehit_verification_equals_jax(weights, corrupt):
    """The ``corrupt`` drill flips one byte of the first spill in host RAM
    (same seeded offset in both engines): the rehit probe drops that entry
    and counts one ``kv`` trip, the prompt recomputes from there, and the
    streams equal the JAX engine's and the first run's. Without the drill
    the rehit verifies and hits."""
    rule = dict(plane="engine", point="pages", action="corrupt", max_fires=1)
    jeng, teng = _engines(weights, HOST_TIER)
    out = {}
    try:
        for name, eng, ctx, mod, tr in (("jax", jeng, JaxContext, jfaults, jintegrity),
                                        ("port", teng, Context, faults, integrity)):
            inj = mod.FaultInjector([mod.FaultRule(**rule)] if corrupt else [], seed=7)
            with mod.active(inj):
                first, again, hits = _host_tier_drill(eng, ctx)
            out[name] = (first, again, tr.counters()["kv_integrity_failures_total"],
                         [(d.op_index, d.detail) for d in inj.log])
            assert again == first
            if corrupt:
                assert hits <= 1, "the corrupt chain head must not be served"
            else:
                assert hits > 0
    finally:
        jeng.close()
        teng.close()
    assert out["port"] == out["jax"]
    assert out["port"][2] == int(corrupt)


@pytest.fixture(scope="module")
def jax_poison(weights):
    """The JAX engine's poison drill and its clean control, once."""
    jintegrity.reset_for_tests()
    eng = JaxServingEngine(JCFG, weights[0], JaxEngineConfig(**POISON))
    eng._fault_addr = "victim-e"
    try:
        inj = jfaults.FaultInjector([POISON_RULE(jfaults)])
        with jfaults.active(inj):
            got = _run(eng, JaxContext, list(range(3, 19)), 32)
        control = _run(eng, JaxContext, list(range(3, 19)), 32)
        return got, control, eng.watchdog_trips, jintegrity.counters()
    finally:
        eng.close()
        jintegrity.reset_for_tests()


def POISON_RULE(mod):  # noqa: N802 - the rule of the JAX drill
    return mod.FaultRule(plane="engine", point="dispatch", action="poison",
                         match_addr="victim-e", after_ops=3, max_fires=1)


def test_poison_drill_equals_jax(weights, jax_poison):
    """One poisoned dispatch (NaN logits on the device): the lane ends with
    the resume directive, no token of that dispatch escapes, the tokens
    before it equal a clean run's, and the tokens, marker and trip counts
    equal the JAX engine's."""
    eng = TorchServingEngine(TCFG, weights[1], EngineConfig(**POISON), device="cpu")
    eng._fault_addr = "victim-e"
    try:
        with faults.active(faults.FaultInjector([POISON_RULE(faults)])):
            got = _run(eng, Context, list(range(3, 19)), 32)
        control = _run(eng, Context, list(range(3, 19)), 32)
        trips, counters = eng.watchdog_trips, integrity.counters()
    finally:
        eng.close()
    toks, marker, finish = got
    assert marker == {"resume": True,
                      "error": "output watchdog: non-finite or exploding logits"}
    assert finish is None and all(t >= 0 for t in toks) and 0 < len(toks) < 32
    assert toks == control[0][: len(toks)] and control[2] == "length"
    assert trips == 1 and counters["watchdog_trips_total"] == 1
    assert (got, control, trips, counters) == jax_poison


def test_poison_drill_through_http_frontend(model_dir):
    """``in=http out=torch`` with one poisoned dispatch: the SSE stream ends
    as the JAX package's in-process frontend ends it for the same engine
    items (fed from the port's engine), never with a finish reason."""
    from dynamo_tpu.cli.run import _token_pipelines as jax_token_pipelines
    from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
    from dynamo_tpu.llm.http.service import ModelManager as JaxModelManager
    from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
    from dynamo_tpu_torch.cli.run import build_engine, build_parser, make_service
    from tests.test_torch_http import _JaxWire, _Served, _shape, _sse

    flags = build_parser().parse_args(
        ["--model-path", model_dir, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--decode-steps", "2"])
    chat, comp, name, core = build_engine("torch", flags)
    core._fault_addr = "victim-e"
    port_srv = _Served(make_service(chat, comp, name, flags))
    jchat, jcomp = jax_token_pipelines(JaxCard.from_local_path(model_dir), lambda: _JaxWire(core))
    manager = JaxModelManager()
    manager.add_chat_model(name, jchat)
    manager.add_completions_model(name, jcomp)
    jax_srv = _Served(JaxHttpService(manager, host="127.0.0.1", port=0))
    body = {"model": name, "stream": True, "max_tokens": 24, "nvext": {"ignore_eos": True},
            "messages": [{"role": "user", "content": "hello world"}]}
    # the fifth dispatch is poisoned, after a few tokens have streamed
    rule = dict(plane="engine", point="dispatch", action="poison", after_ops=9, max_fires=1)
    try:
        runs = []
        for srv in (port_srv, jax_srv):
            with faults.active(faults.FaultInjector([faults.FaultRule(**rule)])):
                runs.append(_sse(srv.port, "/v1/chat/completions", body))
        clean = _sse(port_srv.port, "/v1/chat/completions", body)
    finally:
        port_srv.close()
        jax_srv.close()
        core.close()
    chunks, jax_chunks = runs
    assert [_shape(c) for c in chunks] == [_shape(c) for c in jax_chunks]
    text = [[(c["choices"][0].get("delta") or {}).get("content") for c in cs]
            for cs in runs + [clean]]
    assert text[0] == text[1] == text[2][: len(text[0])] and 0 < len(text[0]) < len(text[2])
    assert not any(ch.get("finish_reason") for c in chunks for ch in c["choices"])
    assert clean[-1]["choices"][0]["finish_reason"] == "length"
    assert core.watchdog_trips == 2
