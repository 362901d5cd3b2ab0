"""Performance attribution plane: where the microseconds go.

The port's copy of the JAX package's ``runtime/profiling.py``, whole. The
flight recorder and the SLO engine can say *that* a request was slow; this
module says *where* inside a dispatch or an event-loop tick the time went:

- **ProfilePolicy** — the ``DYN_TPU_PROFILE*`` knob bundle (malformed or
  non-positive values fall back to the defaults). ``DYN_TPU_PROFILE``
  defaults OFF and is THE zero-overhead gate: with it unset, no timeline
  ring, no frontend CPU accumulator and no event-loop lag sampler is ever
  constructed, and the engine step loop pays one attribute check per
  dispatch.
- **StepTimeline** — a process-global, thread-safe ring of per-dispatch
  records fed by the engine step loop: phase (prefill ``chunk`` /
  ``decode`` / ``verify``), batch shape, the *device's execution time* vs
  the *host's build and enqueue time* (and the host's post-fetch emit
  work), allocator time (alloc/grow/seal ride one accumulator), per-step
  queue depths and the request/trace ids riding the batch, plus events
  with a detail string.
- **FrontendCpu / EventLoopLagSampler** — the frontend hot path's
  equivalents: per-token CPU split across detokenize / serialize /
  transport-write, and an event-loop lag sampler.
- **Chrome-trace export** — :func:`to_chrome_trace` renders any record set
  as a Perfetto-loadable Chrome trace JSON (one track per engine phase, one
  for the event loop, slice args carrying the request and trace ids),
  served by the edge's ``GET /debug/profile?trace=1``.

Sampling: timing a dispatch serializes it (the engine waits for the
device to finish it; on CUDA it also gates its launches segment by
segment, ``engine_torch/device_timer.py``). ``sample_every`` bounds the
tax — only every Nth dispatch is timed; untimed dispatches still count
into ``dispatches_total`` so ``device_idle_frac`` stays honest about
coverage.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

ENV_PROFILE = "DYN_TPU_PROFILE"
ENV_SAMPLE = "DYN_TPU_PROFILE_SAMPLE"
ENV_RING = "DYN_TPU_PROFILE_RING"
ENV_LAG_MS = "DYN_TPU_PROFILE_LAG_MS"

# engine dispatch phases a timeline record may carry (the chrome-trace
# track names); free-form phases still record — these are the documented set
PHASES = ("chunk", "decode", "verify", "loop_lag")

from .envknobs import (  # noqa: E402
    env_clamped_float as _env_clamped_float,
    env_clamped_int as _env_clamped_int,
    env_flag as _env_flag,
)


@dataclass(frozen=True)
class ProfilePolicy:
    """Knob bundle for the profiling plane (the clamping contract:
    malformed / non-positive values fall back to defaults, in-range
    values clamp into the documented bounds).

    ``enabled``       DYN_TPU_PROFILE (default OFF — 1 arms the plane;
                      0/unset is the zero-overhead gate: nothing is ever
                      constructed).
    ``sample_every``  time every Nth engine dispatch (clamped to
                      [1, 1_000_000]; 1 = every dispatch — exact but
                      timing serializes pipelined decode, so production
                      captures want the default 8).
    ``ring_size``     dispatch/event records retained (clamped to
                      [256, 262_144]).
    ``lag_ms``        event-loop lag sampler interval in ms (clamped to
                      [5, 10_000]).
    """

    enabled: bool = False
    sample_every: int = 8
    ring_size: int = 4096
    lag_ms: float = 100.0

    @classmethod
    def from_env(cls) -> "ProfilePolicy":
        d = cls()
        return cls(
            enabled=_env_flag(ENV_PROFILE, d.enabled),
            sample_every=_env_clamped_int(
                ENV_SAMPLE, d.sample_every, 1, 1_000_000
            ),
            ring_size=_env_clamped_int(ENV_RING, d.ring_size, 256, 262_144),
            lag_ms=_env_clamped_float(ENV_LAG_MS, d.lag_ms, 5.0, 10_000.0),
        )


def maybe_from_env() -> Optional[ProfilePolicy]:
    """The gate every integration point None-checks: ``None`` unless the
    profiling plane is armed — with ``DYN_TPU_PROFILE`` unset/0 no policy
    object is ever constructed."""
    if not _env_flag(ENV_PROFILE, False):
        return None
    return ProfilePolicy.from_env()


def enabled() -> bool:
    """Cheap boolean form of the gate (one env read, no object)."""
    return _env_flag(ENV_PROFILE, False)


def _pctl(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# the engine-side dispatch timeline
# ---------------------------------------------------------------------------


class StepTimeline:
    """Process-global ring of per-dispatch timing records + events.

    Constructed lazily behind the :func:`maybe_from_env` gate — with
    profiling off nothing ever constructs it (the zero-overhead guard
    monkeypatches this constructor to prove it). Thread-safe: the engine
    step thread appends, the HTTP thread snapshots.

    A dispatch record is a plain dict (the JAX package's field names):

    ``ts``         epoch seconds of the dispatch's host-build start
                   (wall-clock so captures from different processes align
                   on one Perfetto timeline)
    ``phase``      "chunk" | "decode" | "verify"
    ``step``       the engine's step counter
    ``batch``      active lanes in the dispatch
    ``tokens``     tokens this dispatch advances (prefill feed or
                   batch × decode_steps)
    ``host_us``    the host's build of the dispatch and the enqueue of all
                   its work (eager PyTorch enqueues kernel by kernel;
                   allocator time included)
    ``device_us``  the time the device spent executing the dispatch: on
                   CUDA the sum of its segments' event-timed durations,
                   each segment gated until the host had enqueued it whole
                   (``engine_torch/device_timer.py``), so neither the
                   enqueue nor the wait for it is counted; on the CPU the
                   forward's own time
    ``post_us``    host-side fetch/emit work after the device finished
                   (still dispatch overhead, but attributable to token
                   processing, not building)
    ``alloc_us``   allocator share of host_us (alloc/grow/seal-checksum
                   accumulated since the last record)
    ``queue``      pending requests at dispatch
    ``reqs``       up to 8 request ids riding the batch
    ``traces``     their trace ids when tracing is on
    """

    def __init__(self, policy: Optional[ProfilePolicy] = None):
        self._policy = policy or ProfilePolicy.from_env()
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self._policy.ring_size)
        # event-loop lag samples ride their OWN ring: a frontend's ~10
        # samples/s must not evict engine dispatch records or count into
        # sampled_total (a co-hosted engine+frontend shares this object)
        self._lag_records: deque = deque(
            maxlen=min(self._policy.ring_size, 4096)
        )
        self._events: deque = deque(maxlen=min(self._policy.ring_size, 1024))
        self._sample_ctr = 0
        self.dispatches_total = 0
        self.sampled_total = 0
        self.jit_compiles_total = 0

    @property
    def policy(self) -> ProfilePolicy:
        return self._policy

    def should_sample(self) -> bool:
        """One call per dispatch: counts it and decides whether this one
        pays the timing tax (every ``sample_every``-th does)."""
        with self._lock:
            self.dispatches_total += 1
            self._sample_ctr += 1
            if self._sample_ctr >= self._policy.sample_every:
                self._sample_ctr = 0
                return True
            return False

    def note_dispatch(
        self,
        phase: str,
        *,
        step: int = 0,
        batch: int = 0,
        tokens: int = 0,
        host_us: float = 0.0,
        device_us: float = 0.0,
        post_us: float = 0.0,
        alloc_us: float = 0.0,
        queue: int = 0,
        reqs: Sequence[str] = (),
        traces: Sequence[str] = (),
        ts: Optional[float] = None,
    ) -> None:
        rec = {
            # epoch-aligned so multi-process captures merge onto one
            # Perfetto timeline
            "ts": float(ts) if ts is not None else time.time(),
            "phase": str(phase),
            "step": int(step),
            "batch": int(batch),
            "tokens": int(tokens),
            "host_us": round(float(host_us), 1),
            "device_us": round(float(device_us), 1),
            "post_us": round(float(post_us), 1),
            "alloc_us": round(float(alloc_us), 1),
            "queue": int(queue),
        }
        if reqs:
            rec["reqs"] = list(reqs)[:8]
        if traces:
            rec["traces"] = list(traces)[:8]
        with self._lock:
            if phase == "loop_lag":
                self._lag_records.append(rec)
            else:
                self._records.append(rec)
                self.sampled_total += 1

    def note_event(self, kind: str, detail: str = "", phase: str = "") -> None:
        ev = {
            "ts": time.time(),
            "kind": str(kind),
            "detail": str(detail),
        }
        if phase:
            ev["phase"] = phase
        with self._lock:
            self._events.append(ev)
            if kind == "jit_compile":
                self.jit_compiles_total += 1

    # -- reads --------------------------------------------------------------

    def records(self, since_s: Optional[float] = None) -> List[dict]:
        with self._lock:
            out = list(self._records) + list(self._lag_records)
        out.sort(key=lambda r: r["ts"])
        if since_s is not None and since_s > 0:
            cutoff = time.time() - since_s
            out = [r for r in out if r["ts"] >= cutoff]
        return out

    def events(self, since_s: Optional[float] = None) -> List[dict]:
        with self._lock:
            out = list(self._events)
        if since_s is not None and since_s > 0:
            cutoff = time.time() - since_s
            out = [e for e in out if e["ts"] >= cutoff]
        return out

    def summary(self, since_s: Optional[float] = None) -> Dict[str, Any]:
        """Per-phase device/host quantiles + the idle fraction — the
        "read device_idle_frac first" number of the runbook."""
        recs = self.records(since_s)
        phases: Dict[str, Dict[str, List[float]]] = {}
        for r in recs:
            p = phases.setdefault(
                r["phase"],
                {"device": [], "host": [], "alloc": [], "tokens": []},
            )
            p["device"].append(r["device_us"])
            p["host"].append(r["host_us"] + r["post_us"])
            p["alloc"].append(r["alloc_us"])
            p["tokens"].append(r["tokens"])
        out: Dict[str, Any] = {
            "dispatches_total": self.dispatches_total,
            "sampled_total": self.sampled_total,
            "jit_compiles_total": self.jit_compiles_total,
            "phases": {},
        }
        for name, p in phases.items():
            dev = sorted(p["device"])
            host = sorted(p["host"])
            out["phases"][name] = {
                "count": len(dev),
                "device_us_p50": round(_pctl(dev, 0.50), 1),
                "device_us_p95": round(_pctl(dev, 0.95), 1),
                "host_us_p50": round(_pctl(host, 0.50), 1),
                "host_us_p95": round(_pctl(host, 0.95), 1),
                "alloc_us_p95": round(_pctl(sorted(p["alloc"]), 0.95), 1),
                "tokens": int(sum(p["tokens"])),
            }
        out["device_idle_frac"] = self.device_idle_frac(recs)
        return out

    @staticmethod
    def device_idle_frac(recs: List[dict]) -> float:
        """Fraction of the sampled wall span the device spent NOT
        executing a dispatch. Computed over consecutive *sampled*
        engine-phase records (loop_lag and events excluded): each pair's
        busy time is the earlier record's device time scaled by the step
        delta between them — at a sampling stride of N, the N-1 unsampled
        dispatches in the gap are assumed device-shaped like the sampled
        one (capped at the gap), so the default stride doesn't read a
        fully-busy device as mostly idle."""
        eng = [r for r in recs if r["phase"] in ("chunk", "decode", "verify")]
        if len(eng) < 2:
            return 0.0
        eng.sort(key=lambda r: r["ts"])
        busy = 0.0
        span = 0.0
        for a, b in zip(eng, eng[1:]):
            stride = b["step"] - a["step"]
            gap = b["ts"] - a["ts"]
            if stride <= 0 or gap <= 0:
                continue  # step-counter reset (engine restart) or clock skew
            span += gap
            busy += min(a["device_us"] * stride / 1e6, gap)
        if span <= 0:
            return 0.0
        return round(min(max(1.0 - busy / span, 0.0), 1.0), 4)

    # recent-tail bound for the per-tick gauge computation: plenty of
    # samples for a p95, and the cost stays flat at the max ring size
    GAUGE_WINDOW = 2048

    def gauges(self) -> Dict[str, float]:
        """The gauge view merged into the engine's ``metrics_snapshot()``:
        decode-phase p95 split + idle fraction. A poller may call it every
        second, so it
        reads only the most recent :data:`GAUGE_WINDOW` engine records —
        a max-size ring (262k records) must not cost a full copy + sort
        per tick inside the plane whose own overhead budget is <2%."""
        with self._lock:
            n = len(self._records)
            recs = list(
                self._records
            ) if n <= self.GAUGE_WINDOW else [
                self._records[i] for i in range(n - self.GAUGE_WINDOW, n)
            ]
        dev: List[float] = []
        host: List[float] = []
        for r in recs:
            if r["phase"] == "decode":
                dev.append(r["device_us"])
                host.append(r["host_us"] + r["post_us"])
        dev.sort()
        host.sort()
        return {
            "dispatch_device_us_p95": round(_pctl(dev, 0.95), 1),
            "dispatch_host_overhead_us_p95": round(_pctl(host, 0.95), 1),
            "device_idle_frac": self.device_idle_frac(recs),
        }


# ---------------------------------------------------------------------------
# the frontend-side hot-path accounting
# ---------------------------------------------------------------------------


class FrontendCpu:
    """Per-token CPU attribution for the frontend hot path: detokenize /
    serialize / transport-write, cumulative per part with each part's own
    token count (the stages live in different pipeline layers — a
    detokenizer-only process must not divide by the SSE writer's count).
    Constructed lazily behind the gate (zero-overhead guard monkeypatches
    the constructor); the lock only serializes the cross-thread
    ``/metrics`` read against the event-loop writers."""

    PARTS = ("detokenize", "serialize", "transport_write")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._us: Dict[str, float] = {p: 0.0 for p in self.PARTS}
        self._tokens: Dict[str, int] = {p: 0 for p in self.PARTS}

    def note(self, part: str, us: float, tokens: int = 0) -> None:
        with self._lock:
            self._us[part] = self._us.get(part, 0.0) + us
            self._tokens[part] = self._tokens.get(part, 0) + tokens

    def per_token(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for part in self._us:
                n = self._tokens.get(part, 0)
                out[part] = round(self._us[part] / max(n, 1), 3)
            out["tokens"] = dict(self._tokens)
            return out


class EventLoopLagSampler:
    """Measures how late ``asyncio.sleep(interval)`` wakes on this event
    loop — the direct signal of a saturated frontend process (it shows up
    here before it shows up in ITL). Keeps an EMA and the peak; samples
    also land in the timeline (phase ``loop_lag``) so Chrome-trace
    captures render the event loop as its own track."""

    def __init__(self, interval_s: float = 0.1,
                 timeline: Optional[StepTimeline] = None):
        self.interval_s = max(float(interval_s), 0.005)
        self.lag_ema_ms = 0.0
        self.lag_max_ms = 0.0
        self.samples = 0
        self._timeline = timeline
        self._task = None
        # start/stop are refcounted: the sampler is process-global and
        # co-hosted services share it — one service stopping must not
        # kill the lag gauges of the others still running
        self._starts = 0

    async def _run(self) -> None:
        import asyncio

        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(self.interval_s)
            lag_ms = max(
                (time.perf_counter() - t0 - self.interval_s) * 1e3, 0.0
            )
            self.samples += 1
            self.lag_ema_ms = (
                lag_ms if self.samples == 1
                else self.lag_ema_ms + 0.2 * (lag_ms - self.lag_ema_ms)
            )
            if lag_ms > self.lag_max_ms:
                self.lag_max_ms = lag_ms
            if self._timeline is not None:
                self._timeline.note_dispatch(
                    "loop_lag", host_us=lag_ms * 1e3,
                )

    def start(self):
        import asyncio

        self._starts += 1
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())
        return self._task

    def stop(self) -> None:
        self._starts = max(self._starts - 1, 0)
        if self._starts == 0 and self._task is not None:
            self._task.cancel()
            self._task = None

    def gauges(self) -> Dict[str, float]:
        return {
            "ema_ms": round(self.lag_ema_ms, 3),
            "max_ms": round(self.lag_max_ms, 3),
            "samples": self.samples,
        }


# ---------------------------------------------------------------------------
# process-global accessors (constructor-free reads, lazy writes)
# ---------------------------------------------------------------------------

_TIMELINE: Optional[StepTimeline] = None
_FRONTEND: Optional[FrontendCpu] = None
_LAG: Optional[EventLoopLagSampler] = None
_LOCK = threading.Lock()


def timeline() -> StepTimeline:
    """The process-global timeline, constructed on first use — callers
    sit behind the :func:`maybe_from_env` gate, so with profiling off
    nothing ever calls this."""
    global _TIMELINE
    if _TIMELINE is None:
        with _LOCK:
            if _TIMELINE is None:
                _TIMELINE = StepTimeline()
    return _TIMELINE


def maybe_timeline() -> Optional[StepTimeline]:
    """Constructor-free read: None until something armed the plane."""
    return _TIMELINE


def frontend_cpu() -> FrontendCpu:
    global _FRONTEND
    if _FRONTEND is None:
        with _LOCK:
            if _FRONTEND is None:
                _FRONTEND = FrontendCpu()
    return _FRONTEND


def maybe_frontend_cpu() -> Optional[FrontendCpu]:
    return _FRONTEND


def lag_sampler(interval_s: Optional[float] = None) -> EventLoopLagSampler:
    """The process's event-loop lag sampler (one per process: co-hosted
    services share the loop, so they share the lag)."""
    global _LAG
    if _LAG is None:
        # resolve the timeline BEFORE taking the module lock: timeline()
        # takes the same non-reentrant lock
        tl = timeline()
        with _LOCK:
            if _LAG is None:
                pol = ProfilePolicy.from_env()
                _LAG = EventLoopLagSampler(
                    interval_s if interval_s is not None
                    else pol.lag_ms / 1e3,
                    timeline=tl,
                )
    return _LAG


def maybe_lag_sampler() -> Optional[EventLoopLagSampler]:
    return _LAG


def note_event(kind: str, detail: str = "", phase: str = "") -> None:
    """Constructor-free event feed: a no-op until something armed the
    timeline."""
    t = _TIMELINE
    if t is not None:
        t.note_event(kind, detail, phase)


def gauges() -> Dict[str, float]:
    """Constructor-free gauge read:
    empty dict until the plane was ever armed in this process."""
    t = _TIMELINE
    if t is None:
        return {}
    return t.gauges()


def dump_state(since_s: Optional[float] = None) -> Dict[str, Any]:
    """The ``GET /debug/profile`` payload —
    constructor-free; a process that never armed profiling answers with
    ``enabled: false`` and empty sections."""
    t = _TIMELINE
    out: Dict[str, Any] = {"enabled": enabled()}
    if t is not None:
        out["summary"] = t.summary(since_s)
        out["records"] = t.records(since_s)
        out["events"] = t.events(since_s)
    else:
        out["summary"] = {}
        out["records"] = []
        out["events"] = []
    fc = _FRONTEND
    if fc is not None:
        out["frontend_cpu_us_per_token"] = fc.per_token()
    lag = _LAG
    if lag is not None:
        out["event_loop_lag_ms"] = lag.gauges()
    return out


def render_frontend_prometheus(prefix: str = "dynamo_frontend") -> str:
    """Frontend hot-path gauges for the /metrics exposition —
    constructor-free, empty string until anything was recorded."""
    lines: List[str] = []
    fc = _FRONTEND
    if fc is not None:
        per = fc.per_token()
        full = f"{prefix}_cpu_us_per_token"
        lines.append(
            f"# HELP {full} Frontend hot-path CPU microseconds per "
            f"streamed token, by pipeline part"
        )
        lines.append(f"# TYPE {full} gauge")
        for part in FrontendCpu.PARTS:
            lines.append(f'{full}{{part="{part}"}} {per[part]}')
    lag = _LAG
    if lag is not None:
        g = lag.gauges()
        full = f"{prefix}_event_loop_lag_ms"
        lines.append(
            f"# HELP {full} Event-loop wakeup lag (scheduling delay) in ms"
        )
        lines.append(f"# TYPE {full} gauge")
        lines.append(f'{full}{{stat="ema"}} {g["ema_ms"]}')
        lines.append(f'{full}{{stat="max"}} {g["max_ms"]}')
    return "\n".join(lines) + ("\n" if lines else "")


def reset_for_tests() -> None:
    """Drop the process-global state (a test autouse reset: one test's
    records/lag samples must not bleed into another's assertions)."""
    global _TIMELINE, _FRONTEND, _LAG
    with _LOCK:
        if _LAG is not None:
            _LAG._starts = 0  # force past the refcount: tests must not leak
            if _LAG._task is not None:
                _LAG._task.cancel()
                _LAG._task = None
        _TIMELINE = None
        _FRONTEND = None
        _LAG = None


# ---------------------------------------------------------------------------
# Chrome-trace (Perfetto-loadable) export
# ---------------------------------------------------------------------------

# stable track ids per phase so multi-capture merges stay aligned
_TRACK_IDS = {"chunk": 1, "decode": 2, "verify": 3, "loop_lag": 8}
_HOST_TRACK = 6
_EVENT_TRACK = 7


def to_chrome_trace(
    captures: Iterable[Tuple[str, List[dict], List[dict]]],
) -> Dict[str, Any]:
    """Render captures as a Chrome-trace JSON object (Perfetto loads it
    directly; ``chrome://tracing`` too).

    ``captures`` is an iterable of ``(process_name, records, events)`` —
    one entry per process. Layout: one *process* per capture, one
    *track* (tid) per engine phase plus a ``host`` track (pre-build and
    post-emit slices), an ``events`` track (events as instant markers) and an ``event_loop`` track for lag samples. ``ts``/``dur``
    are microseconds since the earliest record across all captures.

    Slices on a track are emitted sorted and non-overlapping: a slice
    whose start precedes the previous slice's end is clamped forward (in
    pipelined decode the next dispatch is *queued* while the previous
    executes — the clamped start is when the device actually got to it).
    """
    caps = [
        (name, list(records), list(events)) for name, records, events in captures
    ]
    t0 = min(
        (
            r["ts"]
            for _, records, events in caps
            for r in list(records) + list(events)
        ),
        default=0.0,
    )

    trace_events: List[dict] = []
    for pid, (name, records, events) in enumerate(caps, start=1):
        trace_events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name},
        })
        named_tracks = dict(_TRACK_IDS)
        for phase, tid in sorted(named_tracks.items()):
            label = "event_loop" if phase == "loop_lag" else f"engine/{phase}"
            trace_events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": label},
            })
        trace_events.append({
            "ph": "M", "pid": pid, "tid": _HOST_TRACK, "name": "thread_name",
            "args": {"name": "engine/host"},
        })
        trace_events.append({
            "ph": "M", "pid": pid, "tid": _EVENT_TRACK, "name": "thread_name",
            "args": {"name": "engine/events"},
        })

        # bucket slices per track, then clamp each track independently
        per_track: Dict[int, List[dict]] = {}
        for r in sorted(records, key=lambda r: r["ts"]):
            base_us = (r["ts"] - t0) * 1e6
            phase = r["phase"]
            tid = named_tracks.get(phase)
            if tid is None:
                tid = named_tracks[phase] = 16 + len(named_tracks)
                trace_events.append({
                    "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": f"engine/{phase}"},
                })
            args = {
                k: r[k]
                for k in ("step", "batch", "tokens", "queue", "alloc_us",
                          "reqs", "traces")
                if k in r and r[k]
            }
            if phase == "loop_lag":
                # lag sample: one slice whose duration IS the lag
                per_track.setdefault(tid, []).append({
                    "ph": "X", "pid": pid, "tid": tid, "name": "loop_lag",
                    "ts": base_us, "dur": max(r["host_us"], 1.0),
                    "args": args,
                })
                continue
            host_end = base_us + r["host_us"]
            dev_end = host_end + r["device_us"]
            if r["host_us"] > 0:
                per_track.setdefault(_HOST_TRACK, []).append({
                    "ph": "X", "pid": pid, "tid": _HOST_TRACK,
                    "name": f"{phase}.build", "ts": base_us,
                    "dur": r["host_us"], "args": args,
                })
            per_track.setdefault(tid, []).append({
                "ph": "X", "pid": pid, "tid": tid, "name": phase,
                "ts": host_end, "dur": max(r["device_us"], 1.0),
                "args": args,
            })
            if r.get("post_us", 0) > 0:
                per_track.setdefault(_HOST_TRACK, []).append({
                    "ph": "X", "pid": pid, "tid": _HOST_TRACK,
                    "name": f"{phase}.emit", "ts": dev_end,
                    "dur": r["post_us"], "args": args,
                })
        for tid, slices in per_track.items():
            slices.sort(key=lambda s: s["ts"])
            prev_end = -1.0
            for s in slices:
                if s["ts"] < prev_end:
                    # queued behind the previous slice on this track
                    shift = prev_end - s["ts"]
                    s["ts"] = prev_end
                    s["dur"] = max(s["dur"] - shift, 1.0)
                s["ts"] = round(s["ts"], 1)
                s["dur"] = round(s["dur"], 1)
                prev_end = s["ts"] + s["dur"]
                trace_events.append(s)
        for e in sorted(events, key=lambda e: e["ts"]):
            trace_events.append({
                "ph": "i", "pid": pid, "tid": _EVENT_TRACK,
                "name": e["kind"], "ts": round((e["ts"] - t0) * 1e6, 1),
                "s": "t", "args": {"detail": e.get("detail", "")},
            })
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "dynamo_tpu_torch profiling plane (GET /debug/profile?trace=1)",
            "epoch_t0": t0,
        },
    }


def chrome_trace_json(
    captures: Iterable[Tuple[str, List[dict], List[dict]]],
) -> str:
    return json.dumps(to_chrome_trace(captures))
