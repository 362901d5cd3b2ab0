"""Prometheus-format HTTP service metrics (no external deps).

Counters by model/endpoint/type/status, an inflight gauge, request-duration
+ TTFT + inter-token-latency histograms, with an RAII-style InflightGuard.
This module also owns the ONE label-escaping/formatting helper pair
(:func:`escape_label`, :func:`fmt_labels`) every Prometheus renderer of the
port shares.

The port's copy of the JAX package's ``llm/http/metrics.py``, whole, with
one difference: the tracing, telemetry and profiling planes are the port's
own modules, imported directly, so a broken plane fails its tests instead
of vanishing from ``/metrics``. The control-plane section of the JAX
exposition comes with the port's RPC runtime.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Iterable, Optional

from ...runtime import profiling, telemetry, tracing

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# inter-token gaps sit well under the request-duration buckets: a healthy
# decode emits every few ms, and the interesting tail is 100 ms-ish stalls
ITL_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def escape_label(v: str) -> str:
    """Escape a Prometheus text-format label value (backslash, quote,
    newline) — an id containing any of these would otherwise corrupt the
    whole /metrics exposition."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def fmt_labels(labels: dict[str, str]) -> str:
    """``{a="x",b="y"}`` with values escaped; empty string for no labels."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _observe_trace_phase(phase: str, seconds: float) -> None:
    """Feed an edge-measured phase sample into the tracing plane's shared
    phase histogram; with tracing disabled the streaming hot path pays one
    boolean check."""
    if tracing.enabled():
        tracing.observe_phase(phase, seconds)


def _observe_slo_latency(
    series: str, model: str, seconds: float, tenant: Optional[str] = None
) -> None:
    """Feed an edge latency sample (TTFT / inter-token) into the telemetry
    plane's SLO store (``DYN_TPU_SLO=0`` costs one boolean check inside).
    With a tenant class attached a SECOND, tenant-labeled series gets the
    sample: the SLO engine fans out over every label set it has seen, so
    per-tenant-class ``ttft_p95``/``itl_p95`` rows appear on ``/debug/slo``
    without touching the model-level objective."""
    telemetry.observe_latency(series, seconds * 1e3, model=model)
    if tenant:
        telemetry.observe_latency(
            series, seconds * 1e3, model=model, tenant=tenant
        )


def _count_slo_request(outcome: str, model: str) -> None:
    """One finished edge request into the SLO store (error-rate and
    overload-share objectives)."""
    telemetry.count_request(outcome, model=model)


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] += amount

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            items = list(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, val in items:
            labels = dict(zip(self.label_names, key))
            yield f"{self.name}{fmt_labels(labels)} {val:g}"


class Gauge:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] = value

    def add(self, amount: float, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] += amount

    def get(self, **labels: str) -> float:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            items = list(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, val in items:
            labels = dict(zip(self.label_names, key))
            yield f"{self.name}{fmt_labels(labels)} {val:g}"


class Histogram:
    def __init__(
        self,
        name: str,
        help_: str,
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = tuple(buckets) + (math.inf,)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            keys = list(self._counts.keys())
            for key in keys:
                labels = dict(zip(self.label_names, key))
                for i, b in enumerate(self.buckets):
                    le = "+Inf" if math.isinf(b) else f"{b:g}"
                    bl = dict(labels, le=le)
                    yield f"{self.name}_bucket{fmt_labels(bl)} {self._counts[key][i]}"
                yield f"{self.name}_sum{fmt_labels(labels)} {self._sums[key]:g}"
                yield f"{self.name}_count{fmt_labels(labels)} {self._totals[key]}"

    def snapshot(self) -> dict[tuple, tuple[list[int], int, float]]:
        """{label_values: (cumulative_bucket_counts, total, sum)} — the raw
        state quantile estimators (tracing.phase_summary, bench.py) read."""
        with self._lock:
            return {
                key: (list(counts), self._totals[key], self._sums[key])
                for key, counts in self._counts.items()
            }


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class ServiceMetrics:
    """The HTTP service metric set."""

    LABELS = ("model", "endpoint", "request_type", "status")

    def __init__(self, prefix: str = "dynamo_frontend"):
        self.registry = Registry()
        self.requests = self.registry.register(
            Counter(f"{prefix}_requests_total", "Total LLM requests", self.LABELS)
        )
        self.inflight = self.registry.register(
            Gauge(f"{prefix}_inflight_requests", "Concurrent in-flight requests", ("model",))
        )
        self.duration = self.registry.register(
            Histogram(f"{prefix}_request_duration_seconds", "Request duration", ("model",))
        )
        self.output_tokens = self.registry.register(
            Counter(f"{prefix}_output_tokens_total", "Streamed output tokens", ("model",))
        )
        self.ttft = self.registry.register(
            Histogram(
                f"{prefix}_time_to_first_token_seconds",
                "Time to first streamed SSE chunk with content",
                ("model",),
            )
        )
        self.itl = self.registry.register(
            Histogram(
                f"{prefix}_inter_token_latency_seconds",
                "Gap between consecutive streamed content chunks",
                ("model",),
                buckets=ITL_BUCKETS,
            )
        )
        self.overloaded = self.registry.register(
            Counter(
                f"{prefix}_overloaded_total",
                "Requests shed with 429 + Retry-After (upstream overload)",
                ("model",),
            )
        )
        self.resumed = self.registry.register(
            Counter(
                f"{prefix}_resume_total",
                "Streams resumed on another worker after a mid-decode death",
                ("model",),
            )
        )
        self.migrated = self.registry.register(
            Counter(
                f"{prefix}_migrations_total",
                "Streams live-migrated off a draining worker mid-decode",
                ("model",),
            )
        )

    def inflight_guard(
        self, model: str, endpoint: str, request_type: str,
        tenant_class: Optional[str] = None,
    ) -> "InflightGuard":
        return InflightGuard(self, model, endpoint, request_type,
                             tenant_class=tenant_class)

    def render(self) -> str:
        # one scrape: the edge metrics, the phase-latency histogram of the
        # spans this process recorded, process identity and uptime (plus
        # the cluster section when an aggregator is registered here), and
        # the frontend hot-path gauges (empty until profiling recorded any)
        return (
            self.registry.render()
            + tracing.render_phase_metrics()
            + telemetry.render_process_info()
            + telemetry.render_cluster_metrics()
            + profiling.render_frontend_prometheus()
        )


class InflightGuard:
    """Context manager: inflight gauge up/down + request counter + duration."""

    def __init__(self, metrics: ServiceMetrics, model: str, endpoint: str,
                 request_type: str, tenant_class: Optional[str] = None):
        self._m = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_type = request_type
        # tenant CLASS (bounded cardinality — never the raw tenant id) for
        # per-class SLO rows; None on single-tenant edges = zero extra work
        self.tenant_class = tenant_class
        self.status = "error"
        self._start: Optional[float] = None
        self._first_token_at: Optional[float] = None
        self._last_chunk_at: Optional[float] = None
        self._resumed = False
        # per-kind watermarks for sync_resumes (resume vs live migration)
        self._seen_resumes = 0
        self._seen_migrations = 0

    def __enter__(self) -> "InflightGuard":
        self._start = time.perf_counter()
        self._m.inflight.add(1, model=self.model)
        return self

    def mark_ok(self) -> None:
        self.status = "success"

    def mark_shed(self) -> None:
        """Request answered 429 (overload shed): its own status label + a
        dedicated counter, so dashboards can tell deliberate load shedding
        from actual failures."""
        self.status = "overloaded"
        self._m.overloaded.inc(1, model=self.model)

    def sync_resumes(self, journal, seen: int) -> int:
        """Fold any NEW recoveries recorded on the request's resume journal
        (``EngineContext.journal``) into this guard: one :meth:`mark_resume`
        per resume — and one :meth:`mark_migration` per live migration —
        since ``seen``. Both re-home kinds attribute the next first-chunk
        wait to ITL, never TTFT. Returns the new watermark (resumes +
        migrations); None journal (non-resumable request) is a no-op.
        Shared by the streaming and unary HTTP loops so the two can't
        drift."""
        if journal is None:
            return seen
        resumes = journal.resumes
        migrations = getattr(journal, "migrations", 0)
        # the guard is per-request: each kind keeps its own internal
        # watermark, so interleaved resume/migration sequences attribute
        # every event to the right counter
        while self._seen_resumes < resumes:
            self._seen_resumes += 1
            self.mark_resume()
        while self._seen_migrations < migrations:
            self._seen_migrations += 1
            self.mark_migration()
        return resumes + migrations

    def mark_migration(self) -> None:
        """The upstream stream was live-migrated off a draining worker
        (``EngineContext.journal`` grew its migration count). Same ITL
        attribution as :meth:`mark_resume` — the gap is a planned re-home,
        not an admission wait — with its own frontend counter."""
        self._resumed = True
        self._m.migrated.inc(1, model=self.model)

    def mark_resume(self) -> None:
        """The upstream stream was resumed on another worker
        (``EngineContext.journal`` grew its resume count). Counts once per
        resume into the frontend resume counter; if no content chunk has
        been delivered yet, the eventual first-chunk latency is attributed
        to ``inter_token``/``itl_ms`` instead of TTFT — the wait was a
        mid-decode recovery gap, not an admission wait, and letting it into
        ``ttft_p95`` would page admission capacity alarms for worker
        deaths that were fully absorbed."""
        self._resumed = True
        self._m.resumed.inc(1, model=self.model)

    def mark_first_token(self) -> None:
        if self._first_token_at is None and self._start is not None:
            self._first_token_at = time.perf_counter()
            if not self._resumed:
                self._m.ttft.observe(
                    self._first_token_at - self._start, model=self.model
                )

    def mark_chunk(self) -> None:
        """Streaming path: called once per content-bearing SSE chunk.
        First chunk observes TTFT; every later one observes the gap since
        the previous chunk (the frontend's inter-token latency). Both also
        feed the shared phase-latency histogram (``ttft``/``inter_token``
        phases) when tracing is enabled. A first chunk that arrived after
        a mid-stream resume is an inter-token gap, not a TTFT (see
        :meth:`mark_resume`) — the pause stays visible, in the right
        series."""
        now = time.perf_counter()
        if self._first_token_at is None:
            self.mark_first_token()
            if self._first_token_at is not None and self._start is not None:
                ttft = self._first_token_at - self._start
                if self._resumed:
                    self._m.itl.observe(ttft, model=self.model)
                    _observe_trace_phase("inter_token", ttft)
                    _observe_slo_latency("itl_ms", self.model, ttft,
                                         tenant=self.tenant_class)
                else:
                    _observe_trace_phase("ttft", ttft)
                    _observe_slo_latency("ttft_ms", self.model, ttft,
                                         tenant=self.tenant_class)
        elif self._last_chunk_at is not None:
            gap = now - self._last_chunk_at
            self._m.itl.observe(gap, model=self.model)
            _observe_trace_phase("inter_token", gap)
            _observe_slo_latency("itl_ms", self.model, gap,
                                 tenant=self.tenant_class)
        self._last_chunk_at = now

    def count_tokens(self, n: int = 1) -> None:
        self._m.output_tokens.inc(n, model=self.model)

    def __exit__(self, exc_type, exc, tb) -> None:
        self._m.inflight.add(-1, model=self.model)
        if self._start is not None:
            self._m.duration.observe(time.perf_counter() - self._start, model=self.model)
        status = self.status if exc_type is None else "error"
        self._m.requests.inc(
            1,
            model=self.model,
            endpoint=self.endpoint,
            request_type=self.request_type,
            status=status,
        )
        _count_slo_request(status, self.model)
