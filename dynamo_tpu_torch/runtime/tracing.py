"""Request tracing: spans, ``traceparent`` propagation, the flight recorder.

The port's copy of the JAX package's ``runtime/tracing.py``, whole and with
the same behaviour; it answers "where did THIS request's time go":

- **Span model** — zero-dependency: ``trace_id``/``span_id``/``parent_id``,
  monotonic start/end, typed phase names (:data:`PHASES`), attributes, and
  timestamped events.
- **Propagation** — a W3C-``traceparent``-compatible wire form
  (``00-<32hex>-<16hex>-<flags>``): the HTTP edge (``llm/http/service.py``)
  accepts it from incoming requests and parents its ``http.edge`` span
  under it; the span rides ``EngineContext.trace`` into the engine, whose
  ``engine.request`` span and phase spans hang below it.
- **Flight recorder** — a bounded per-process ring of completed traces
  (``DYN_TPU_TRACE_*``; malformed or non-positive values fall back to the
  defaults). Slow, errored, reaped, deadline-expired and failed-over traces
  are *pinned* in a separate bounded store so a burst of ordinary traffic
  cannot evict the trace a postmortem needs (shed traces are recorded but
  unpinned: sheds arrive in storms). Exported as JSONL by the edge's
  ``GET /debug/traces``; :func:`render_trace` draws one trace as a tree.
- **Phase histograms** — every ended span with a ``phase`` feeds a shared
  latency histogram (the primitives of ``llm/http/metrics.py``), rendered
  on the edge's ``/metrics`` and summarized (p50/p95/p99) by
  :func:`phase_summary`.

Hot-path contract: with ``DYN_TPU_TRACE=0`` (or ``false``) every
``start_span``/``record_span`` call returns ``None`` before allocating
anything, so the request path makes zero tracing allocations per token.
Spans are per *phase*, never per token, so even enabled tracing costs a
handful of objects per request.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

# typed phase names: span durations land in the phase-latency histogram
# under exactly these labels (docs/observability.md has the catalog)
PHASES = (
    "ttft",
    "queue_wait",
    "prefill",
    "decode",
    "inter_token",
    "kv_transfer",
    # frontend hot-path decomposition (docs/observability.md §Profiling):
    # incremental detokenization and SSE-chunk JSON serialization — the
    # two host-CPU parts of the per-token residue the PR5 histograms
    # couldn't see
    "detokenize",
    "serialize",
)

# span terminal statuses (free-form strings are allowed; these are the ones
# the recorder treats as "interesting" and pins). "overloaded" is
# deliberately NOT here: sheds arrive in storms, and a storm pinning
# thousands of shed traces would cycle the bounded pinned store and evict
# exactly the rare error/reaped traces pinning exists to protect — shed
# traces stay in the ordinary ring (and sheds are counted in metrics).
STATUS_OK = "ok"
PIN_STATUSES = frozenset(
    {"error", "deadline", "reaped", "cancelled", "failed_over"}
)

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)

# finer-than-default buckets: phase latencies span sub-ms (inter-token on a
# warm engine) to tens of seconds (long prefill)
PHASE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


from .envknobs import env_flag as _env_flag  # noqa: E402
from .envknobs import env_pos_float, env_pos_int  # noqa: E402


class TracePolicy:
    """The ``DYN_TPU_TRACE_*`` knob bundle (PR3-style clamping: malformed,
    zero, or negative values fall back to the defaults — a bad knob must
    degrade to sane behavior, never to an unbounded recorder or a disabled
    one the operator didn't ask for)."""

    __slots__ = ("enabled", "ring_size", "pinned_size", "slow_ms")

    def __init__(
        self,
        enabled: bool = True,
        ring_size: int = 256,
        pinned_size: int = 64,
        slow_ms: float = 2000.0,
    ):
        self.enabled = bool(enabled)
        self.ring_size = max(int(ring_size), 1)
        self.pinned_size = max(int(pinned_size), 1)
        self.slow_ms = float(slow_ms)

    @classmethod
    def from_env(cls) -> "TracePolicy":
        d = cls()
        return cls(
            enabled=_env_flag("DYN_TPU_TRACE", d.enabled),
            ring_size=env_pos_int("DYN_TPU_TRACE_RING", d.ring_size),
            pinned_size=env_pos_int("DYN_TPU_TRACE_PINNED", d.pinned_size),
            slow_ms=env_pos_float("DYN_TPU_TRACE_SLOW_MS", d.slow_ms),
        )


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed operation in a trace.

    ``start``/``_t0`` pair wall clock (for cross-process ordering in dumps)
    with ``time.perf_counter`` (for durations — hosts don't share clocks,
    monotonic deltas are the only honest latency). ``end()`` is idempotent
    and hands the finished span to the flight recorder + phase histogram.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "phase", "start",
        "_t0", "duration_s", "status", "attributes", "events", "_ended",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        phase: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.phase = phase
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.status = STATUS_OK
        self.attributes: Dict[str, Any] = dict(attributes) if attributes else {}
        self.events: List[Dict[str, Any]] = []
        self._ended = False

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        ev: Dict[str, Any] = {
            "name": name,
            "t_ms": round((time.perf_counter() - self._t0) * 1e3, 3),
        }
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def end(self, status: Optional[str] = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.duration_s = time.perf_counter() - self._t0
        if status is not None:
            self.status = status
        _finish(self)

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "name": self.name,
            "start": round(self.start, 6),
            "status": self.status,
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.phase:
            d["phase"] = self.phase
        if self.duration_s is not None:
            d["duration_ms"] = round(self.duration_s * 1e3, 3)
        if self.attributes:
            d["attributes"] = dict(self.attributes)
        if self.events:
            d["events"] = list(self.events)
        return d


ParentLike = Union[Span, Tuple[str, str], None]


def _resolve_parent(parent: ParentLike) -> Tuple[str, Optional[str]]:
    """(trace_id, parent_span_id) for a new span: inherit from a local Span,
    a (trace_id, span_id) wire context, or start a fresh root trace."""
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id
    if isinstance(parent, tuple) and len(parent) == 2:
        return parent[0], parent[1]
    return _new_trace_id(), None


class FlightRecorder:
    """Bounded in-process store of completed traces.

    Two tiers, both FIFO-bounded: the *ring* holds the most recent traces;
    traces containing a slow span (``>= slow_ms``) or any non-``ok``
    terminal status are promoted to the *pinned* store, which ordinary
    traffic never evicts — exactly the traces a postmortem needs. Spans
    arrive from multiple threads (the engine step thread records
    retroactive phase spans); a plain lock serializes them.
    """

    def __init__(self, policy: TracePolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._ring: Dict[str, dict] = {}    # insertion-ordered (py3.7+)
        self._pinned: Dict[str, dict] = {}
        self.dropped = 0  # traces evicted unpinned (observability of loss)

    def record(self, span: Span) -> None:
        entry_span = span.to_dict()
        slow = (
            span.duration_s is not None
            and span.duration_s * 1e3 >= self.policy.slow_ms
        )
        interesting = slow or span.status in PIN_STATUSES
        with self._lock:
            entry = self._pinned.get(span.trace_id)
            if entry is None:
                entry = self._ring.get(span.trace_id)
            if entry is None:
                entry = {"trace_id": span.trace_id, "spans": [], "pinned": False}
                self._ring[span.trace_id] = entry
            entry["spans"].append(entry_span)
            if interesting and not entry["pinned"]:
                entry["pinned"] = True
                self._ring.pop(span.trace_id, None)
                self._pinned[span.trace_id] = entry
            # FIFO eviction, each tier bounded independently
            while len(self._ring) > self.policy.ring_size:
                self._ring.pop(next(iter(self._ring)))
                self.dropped += 1
            while len(self._pinned) > self.policy.pinned_size:
                self._pinned.pop(next(iter(self._pinned)))
                self.dropped += 1

    def traces(
        self,
        limit: int = 0,
        trace_id: Optional[str] = None,
        errored: bool = False,
    ) -> List[dict]:
        """Most-recent-last list of trace entries (copies). ``trace_id``
        filters to one trace; ``limit`` keeps only the newest N;
        ``errored`` keeps only traces containing a non-``ok`` span (the
        ``GET /debug/traces?errored=1`` filter — slow-but-successful pinned
        traces are deliberately NOT matched)."""
        with self._lock:
            if trace_id is not None:
                entry = self._pinned.get(trace_id) or self._ring.get(trace_id)
                return [json.loads(json.dumps(entry))] if entry else []
            out = list(self._ring.values()) + list(self._pinned.values())
        if errored:
            out = [
                e for e in out
                if any(s.get("status", STATUS_OK) != STATUS_OK
                       for s in e["spans"])
            ]
        out.sort(key=lambda e: min(
            (s.get("start", 0.0) for s in e["spans"]), default=0.0
        ))
        if limit > 0:
            out = out[-limit:]
        return json.loads(json.dumps(out))

    def dump_jsonl(
        self,
        limit: int = 0,
        trace_id: Optional[str] = None,
        errored: bool = False,
    ) -> str:
        """One JSON object per line per trace — the export format of the
        ``/debug/traces`` endpoint."""
        return "\n".join(
            json.dumps(t, sort_keys=True)
            for t in self.traces(limit, trace_id, errored=errored)
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring) + len(self._pinned)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pinned.clear()
            self.dropped = 0


# ---------------------------------------------------------------------------
# module-global state (per-process: policy, recorder, phase histogram)
# ---------------------------------------------------------------------------

_POLICY = TracePolicy.from_env()
_RECORDER = FlightRecorder(_POLICY)
_PHASE_HIST = None  # lazy: llm.http.metrics.Histogram labeled by phase
_PHASE_HIST_LOCK = threading.Lock()

_CURRENT_SPAN: ContextVar[Optional[Span]] = ContextVar(
    "dyn_tpu_current_span", default=None
)
_REQUEST_ID: ContextVar[Optional[str]] = ContextVar(
    "dyn_tpu_request_id", default=None
)


def configure(policy: Optional[TracePolicy] = None) -> TracePolicy:
    """(Re)build the global policy + recorder — tests call this after
    monkeypatching ``DYN_TPU_TRACE_*``; the histogram is reset too so
    phase summaries are scoped to the configuration."""
    global _POLICY, _RECORDER, _PHASE_HIST
    _POLICY = policy or TracePolicy.from_env()
    _RECORDER = FlightRecorder(_POLICY)
    with _PHASE_HIST_LOCK:
        _PHASE_HIST = None
    return _POLICY


def enabled() -> bool:
    return _POLICY.enabled


def recorder() -> FlightRecorder:
    return _RECORDER


def policy() -> TracePolicy:
    return _POLICY


def _phase_hist():
    global _PHASE_HIST
    if _PHASE_HIST is None:
        # the no-dep metrics primitive; imported here because the metrics
        # module imports this one. The lock makes the check-then-set atomic:
        # the engine step thread and the asyncio thread can race the first
        # observation, and the loser's orphan Histogram would silently drop
        # its samples.
        from ..llm.http.metrics import Histogram

        with _PHASE_HIST_LOCK:
            if _PHASE_HIST is None:
                _PHASE_HIST = Histogram(
                    "dynamo_phase_latency_seconds",
                    "Per-request phase latency from trace spans",
                    ("phase",),
                    buckets=PHASE_BUCKETS,
                )
    return _PHASE_HIST


def observe_phase(phase: str, seconds: float) -> None:
    """Feed one phase-latency sample (span end does this automatically for
    spans carrying a ``phase``)."""
    _phase_hist().observe(seconds, phase=phase)


def render_phase_metrics() -> str:
    """Prometheus text exposition of the phase-latency histogram (appended
    to the frontend ``/metrics`` by ``ServiceMetrics.render``)."""
    return "\n".join(_phase_hist().render()) + "\n"


def phase_summary() -> Dict[str, dict]:
    """Compact per-phase stats {count, sum_s, p50_ms, p95_ms, p99_ms,
    buckets}. Quantiles are bucket-interpolated (the usual Prometheus
    histogram_quantile estimate). ``buckets`` is the raw cumulative
    bucket-count vector (aligned with :data:`PHASE_BUCKETS` + Inf): a
    consumer diffs successive snapshots to rebuild windowed distributions,
    which quantiles alone cannot give."""
    hist = _phase_hist()
    out: Dict[str, dict] = {}
    for labels, (counts, total, sum_) in hist.snapshot().items():
        if total == 0:
            continue
        phase = labels[0] if labels else ""
        out[phase] = {
            "count": total,
            "sum_s": round(sum_, 6),
            "p50_ms": _bucket_quantile(hist.buckets, counts, total, 0.50),
            "p95_ms": _bucket_quantile(hist.buckets, counts, total, 0.95),
            "p99_ms": _bucket_quantile(hist.buckets, counts, total, 0.99),
            "buckets": list(counts),
        }
    return out


def _bucket_quantile(
    buckets: Tuple[float, ...], cumulative: List[int], total: int, q: float
) -> float:
    """Histogram-quantile estimate in ms from cumulative bucket counts."""
    rank = q * total
    prev_bound = 0.0
    prev_count = 0
    for bound, count in zip(buckets, cumulative):
        if count >= rank:
            if bound == float("inf"):
                return round(prev_bound * 1e3, 3)  # clamp to last finite bound
            span_count = count - prev_count
            frac = (rank - prev_count) / span_count if span_count else 1.0
            return round((prev_bound + (bound - prev_bound) * frac) * 1e3, 3)
        prev_bound = bound if bound != float("inf") else prev_bound
        prev_count = count
    return round(prev_bound * 1e3, 3)


# ---------------------------------------------------------------------------
# span creation / context propagation
# ---------------------------------------------------------------------------


def start_span(
    name: str,
    parent: ParentLike = None,
    phase: Optional[str] = None,
    attributes: Optional[Dict[str, Any]] = None,
) -> Optional[Span]:
    """Begin a span (None when tracing is disabled — callers guard with
    ``if span is not None``, which is the whole disabled-mode cost)."""
    if not _POLICY.enabled:
        return None
    trace_id, parent_id = _resolve_parent(parent)
    return Span(name, trace_id, _new_span_id(), parent_id, phase, attributes)


def record_span(
    name: str,
    start_perf: float,
    end_perf: float,
    parent: ParentLike = None,
    phase: Optional[str] = None,
    attributes: Optional[Dict[str, Any]] = None,
    status: str = STATUS_OK,
) -> Optional[Span]:
    """Record a span retroactively from two ``perf_counter`` readings — the
    engine step thread stamps timestamps on its hot path and builds the
    spans once, at request finish (keeping dispatch loops allocation-free)."""
    if not _POLICY.enabled:
        return None
    span = start_span(name, parent=parent, phase=phase, attributes=attributes)
    now = time.perf_counter()
    span.start = time.time() - (now - start_perf)
    span._t0 = start_perf
    span._ended = True
    span.duration_s = max(end_perf - start_perf, 0.0)
    span.status = status
    _finish(span)
    return span


def record_event_span(
    name: str,
    parent: ParentLike = None,
    status: str = STATUS_OK,
    attributes: Optional[Dict[str, Any]] = None,
) -> Optional[Span]:
    """A zero-duration marker span — how shed (429) and malformed requests
    still leave a trace without ever being served."""
    if not _POLICY.enabled:
        return None
    now = time.perf_counter()
    return record_span(
        name, now, now, parent=parent, attributes=attributes, status=status
    )


def _finish(span: Span) -> None:
    _RECORDER.record(span)
    if span.phase and span.duration_s is not None:
        try:
            observe_phase(span.phase, span.duration_s)
        except Exception:  # a metrics hiccup must never fail the request
            logger.debug("phase observe failed", exc_info=True)


@contextlib.contextmanager
def span(
    name: str,
    parent: ParentLike = None,
    phase: Optional[str] = None,
    attributes: Optional[Dict[str, Any]] = None,
    set_current: bool = False,
):
    """Scoped span: ends (status ``error`` on exception) when the block
    exits. With ``set_current`` the span becomes the contextvar current
    span for the block (log correlation + child parenting)."""
    s = start_span(name, parent=parent, phase=phase, attributes=attributes)
    token = _CURRENT_SPAN.set(s) if (s is not None and set_current) else None
    try:
        yield s
    except BaseException as e:
        if s is not None:
            s.set_attribute("error", f"{type(e).__name__}: {e}")
            s.end(status="error")
        raise
    else:
        if s is not None:
            s.end()
    finally:
        if token is not None:
            _CURRENT_SPAN.reset(token)


def current_span() -> Optional[Span]:
    return _CURRENT_SPAN.get()


def set_current(span_: Optional[Span]):
    """Install ``span_`` as the contextvar current span; returns the reset
    token. Callers (one coroutine = one request) reset in ``finally``."""
    return _CURRENT_SPAN.set(span_)


def reset_current(token) -> None:
    _CURRENT_SPAN.reset(token)


def set_request_id(request_id: Optional[str]):
    return _REQUEST_ID.set(request_id)


def reset_request_id(token) -> None:
    _REQUEST_ID.reset(token)


def current_ids() -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, request_id) of the calling context — the logging filter
    (``logging_util.TraceContextFilter``) stamps these onto every record."""
    s = _CURRENT_SPAN.get()
    return (s.trace_id if s is not None else None), _REQUEST_ID.get()


# ---------------------------------------------------------------------------
# W3C traceparent wire form
# ---------------------------------------------------------------------------


def format_traceparent(ctx: ParentLike) -> Optional[str]:
    """``00-<trace_id>-<span_id>-01`` for a Span or (trace_id, span_id)
    context; None when there is nothing to propagate."""
    if isinstance(ctx, Span):
        return f"00-{ctx.trace_id}-{ctx.span_id}-01"
    if isinstance(ctx, tuple) and len(ctx) == 2:
        return f"00-{ctx[0]}-{ctx[1]}-01"
    return None


def parse_traceparent(value: Any) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from a traceparent header — None for absent or
    malformed input (the caller then starts a fresh root trace; a bad
    header from an old binary or a foreign proxy must never 500)."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # all-zero ids are invalid per the W3C spec
    return trace_id, span_id


# ---------------------------------------------------------------------------
# trace tree rendering
# ---------------------------------------------------------------------------


def render_trace(entry: dict) -> str:
    """Indented span tree of one recorder entry — parentage by span ids,
    cross-process orphans (parent recorded elsewhere) rendered as roots."""
    spans = sorted(entry.get("spans", []), key=lambda s: s.get("start", 0.0))
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[Optional[str], List[dict]] = {}
    for s in spans:
        parent = s.get("parent_id")
        key = parent if parent in by_id else None
        children.setdefault(key, []).append(s)

    lines = [f"trace {entry.get('trace_id', '?')}"
             f"{'  [pinned]' if entry.get('pinned') else ''}"]

    def walk(span_d: dict, depth: int) -> None:
        dur = span_d.get("duration_ms")
        dur_s = f"{dur:.1f}ms" if isinstance(dur, (int, float)) else "?"
        status = span_d.get("status", STATUS_OK)
        flag = "" if status == STATUS_OK else f"  !{status}"
        phase = span_d.get("phase")
        ph = f" [{phase}]" if phase else ""
        lines.append(f"{'  ' * (depth + 1)}{span_d['name']}{ph}  {dur_s}{flag}")
        for ev in span_d.get("events", []):
            extra = {k: v for k, v in ev.items() if k not in ("name", "t_ms")}
            suffix = f" {extra}" if extra else ""
            lines.append(
                f"{'  ' * (depth + 2)}@{ev.get('t_ms', 0):.1f}ms "
                f"{ev.get('name', '?')}{suffix}"
            )
        for child in children.get(span_d["span_id"], []):
            walk(child, depth + 1)

    for root in children.get(None, []):
        walk(root, 0)
    return "\n".join(lines)
