"""Telemetry core: bounded time-series store + SLO burn-rate engine.

The port's copy of the JAX package's ``runtime/telemetry.py``, whole. The
tracing plane answers "where did THIS request's time go"; this module
answers "is the service meeting its objectives, and if not, how fast is it
failing?", with zero dependencies and bounded memory:

- :class:`TimeSeries` — a fixed-interval ring of buckets per series
  (counter / gauge / histogram kinds). Writes are O(1); reads answer
  *windowed* queries (sum, rate, average, percentile, fraction-below-
  threshold) over any horizon the ring covers. Old buckets are reclaimed
  lazily in place — a series never grows past its ring.
- :class:`MetricStore` — named, labeled series with declared kinds, plus a
  JSON-able dump (the edge's ``GET /debug/slo`` reads it).
- :class:`Slo` / :class:`SloEngine` — declarative objectives ("95% of
  requests see TTFT ≤ 2 s over the slow window") evaluated with
  Google-SRE-style **multi-window burn rates**: the *page* signal needs the
  fast (5 m) AND mid (1 h) windows both burning ≥ ``burn_fast``×budget; the
  *ticket* signal is the slow (6 h) window alone ≥ ``burn_slow``× —
  deliberately single-window: budget spent is budget spent, so after
  recovery the page clears within the fast window while ``burning``
  persists until the slow window drains.

Windows and thresholds are env-tunable (``DYN_TPU_SLO_*``); malformed, zero
or negative values fall back to the defaults, so tests scale hours down to
seconds without code changes.

The one intended difference from the JAX module: :func:`build_info` names
torch's and CUDA's versions where the JAX module names ``jax``'s. A cluster
aggregator registered with :func:`set_cluster` comes with the port's RPC
runtime; until then the cluster sections stay empty.

Hot-path contract: with ``DYN_TPU_SLO=0`` every sampling helper returns
before allocating anything, as with ``DYN_TPU_TRACE=0``. Clocks are
injectable (``clock=``) so the SLO math is deterministic under test.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .envknobs import env_flag, env_pos_float

# process birth, for dynamo_uptime_seconds on every exposition surface
PROCESS_START_MONOTONIC = time.monotonic()
PROCESS_START_WALL = time.time()

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# latency histogram bounds in MILLISECONDS (the SLO engine's native unit;
# sub-ms decode gaps up to multi-minute pathologies)
DEFAULT_LATENCY_BOUNDS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


def uptime_seconds() -> float:
    return time.monotonic() - PROCESS_START_MONOTONIC


def build_info() -> Dict[str, str]:
    """Stable identity labels for ``dynamo_build_info`` (version skew across
    a fleet is the first thing to rule out in any incident): the package
    version, python, and the torch and CUDA versions this process runs."""
    import torch

    from .. import __version__

    return {
        "version": __version__,
        "python": "%d.%d.%d" % sys.version_info[:3],
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
    }


@dataclass
class TelemetryDump:
    """Wire type of the telemetry plane's poll surfaces (the JAX package's
    aggregator ``status`` endpoint and ``telemetry_dump`` RPC verb reply
    with it; the port's come with its RPC runtime)."""

    uptime_s: float = 0.0
    build: Dict[str, str] = field(default_factory=dict)
    enabled: bool = True
    series: Optional[dict] = None
    slo: Optional[list] = None
    cluster: Optional[dict] = None

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {
            "uptime_s": self.uptime_s,
            "build": dict(self.build),
            "enabled": self.enabled,
        }
        if self.series is not None:
            out["series"] = self.series
        if self.slo is not None:
            out["slo"] = self.slo
        if self.cluster is not None:
            out["cluster"] = self.cluster
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryDump":
        return cls(
            uptime_s=float(d.get("uptime_s", 0.0) or 0.0),
            build=dict(d.get("build") or {}),
            enabled=bool(d.get("enabled", True)),
            series=d.get("series"),
            slo=d.get("slo"),
            cluster=d.get("cluster"),
        )


class TelemetryPolicy:
    """The ``DYN_TPU_SLO_*`` knob bundle (PR3-style clamping).

    Window defaults follow the SRE-workbook sizes: page on 5 m + 1 h at
    14.4× budget burn; ticket on the 6 h window alone at 6× (single-window
    by design — see the module docstring). ``*_S`` knobs scale the windows
    (tests run the whole lifecycle in ~2 s); ``DYN_TPU_SLO_TTFT_MS`` /
    ``_ITL_MS`` move the latency objectives without redeploying.
    """

    __slots__ = (
        "enabled", "fast_window", "mid_window", "slow_window",
        "burn_fast", "burn_slow", "ttft_target_ms", "itl_target_ms",
    )

    def __init__(
        self,
        enabled: bool = True,
        fast_window: float = 300.0,
        mid_window: float = 3600.0,
        slow_window: float = 21600.0,
        burn_fast: float = 14.4,
        burn_slow: float = 6.0,
        ttft_target_ms: float = 2000.0,
        itl_target_ms: float = 100.0,
    ):
        self.enabled = bool(enabled)
        self.fast_window = max(float(fast_window), 1e-3)
        # windows must nest: a mid shorter than fast (or slow shorter than
        # mid) would make the confirmation window *less* data than the
        # signal it confirms
        self.mid_window = max(float(mid_window), self.fast_window)
        self.slow_window = max(float(slow_window), self.mid_window)
        self.burn_fast = float(burn_fast)
        self.burn_slow = float(burn_slow)
        self.ttft_target_ms = float(ttft_target_ms)
        self.itl_target_ms = float(itl_target_ms)

    @classmethod
    def from_env(cls, prefix: str = "DYN_TPU_SLO") -> "TelemetryPolicy":
        d = cls()
        return cls(
            enabled=env_flag(prefix, d.enabled),
            fast_window=env_pos_float(prefix + "_FAST_S", d.fast_window),
            mid_window=env_pos_float(prefix + "_MID_S", d.mid_window),
            slow_window=env_pos_float(prefix + "_SLOW_S", d.slow_window),
            burn_fast=env_pos_float(prefix + "_BURN_FAST", d.burn_fast),
            burn_slow=env_pos_float(prefix + "_BURN_SLOW", d.burn_slow),
            ttft_target_ms=env_pos_float(prefix + "_TTFT_MS", d.ttft_target_ms),
            itl_target_ms=env_pos_float(prefix + "_ITL_MS", d.itl_target_ms),
        )

    def ring_spec(self) -> Tuple[float, int]:
        """(bucket interval, bucket count) sized so the fast window has
        ~30 buckets of resolution and the ring still covers the slow
        window (plus one spare bucket for the in-progress edge)."""
        interval = self.fast_window / 30.0
        capacity = int(math.ceil(self.slow_window / interval)) + 2
        # bound the ring even under adversarial window ratios: 1 B users
        # don't need minute-resolution over a month in process memory
        return interval, min(capacity, 8192)


class TimeSeries:
    """One named series: a ring of fixed-interval buckets.

    Each slot stores ``(epoch, payload)`` where epoch identifies the
    absolute interval the slot currently represents; stale slots (lapped by
    the ring) are reinitialized on first touch — no background sweeper.

    Payloads by kind:
      counter    float sum of increments in the interval
      gauge      (count, sum, last) of samples in the interval
      histogram  (list[int] per-bound cumulative-style counts, count, sum)
                 — counts are per *series bounds*, NOT cumulative across
                 buckets; merging windows is element-wise addition.
    """

    __slots__ = (
        "name", "kind", "interval", "capacity", "bounds",
        "_epochs", "_data", "_lock", "clock",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        interval: float,
        capacity: int,
        bounds: Optional[Sequence[float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if kind not in (COUNTER, GAUGE, HISTOGRAM):
            raise ValueError(f"unknown series kind {kind!r}")
        self.name = name
        self.kind = kind
        self.interval = max(float(interval), 1e-6)
        self.capacity = max(int(capacity), 2)
        self.bounds: Tuple[float, ...] = tuple(bounds or ()) + (math.inf,)
        self._epochs = [-1] * self.capacity
        self._data: List[Any] = [None] * self.capacity
        self._lock = threading.Lock()
        self.clock = clock

    # -- write side ---------------------------------------------------------

    def _slot(self, t: Optional[float]) -> int:
        """Slot index for time ``t``, (re)initialized for this epoch."""
        now = self.clock() if t is None else t
        epoch = int(now // self.interval)
        i = epoch % self.capacity
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            if self.kind == COUNTER:
                self._data[i] = 0.0
            elif self.kind == GAUGE:
                self._data[i] = [0, 0.0, 0.0]  # count, sum, last
            else:
                self._data[i] = [[0] * len(self.bounds), 0, 0.0]
        return i

    def inc(self, amount: float = 1.0, t: Optional[float] = None) -> None:
        with self._lock:
            i = self._slot(t)
            self._data[i] += amount

    def set(self, value: float, t: Optional[float] = None) -> None:
        with self._lock:
            i = self._slot(t)
            cell = self._data[i]
            cell[0] += 1
            cell[1] += value
            cell[2] = value

    def observe(self, value: float, t: Optional[float] = None) -> None:
        with self._lock:
            i = self._slot(t)
            counts, _, _ = self._data[i]
            for j, b in enumerate(self.bounds):
                if value <= b:
                    counts[j] += 1
                    break
            cell = self._data[i]
            cell[1] += 1
            cell[2] += value

    def observe_bucketed(
        self,
        delta_counts: Sequence[int],
        delta_sum: float = 0.0,
        t: Optional[float] = None,
    ) -> None:
        """Ingest pre-bucketed *per-bound* (non-cumulative) count deltas —
        how the cluster aggregator folds a worker's histogram snapshot diff
        into its own windowed series. Length mismatches are rejected
        (bounds drift between versions must not silently corrupt)."""
        if len(delta_counts) != len(self.bounds):
            raise ValueError(
                f"{self.name}: got {len(delta_counts)} bucket deltas for "
                f"{len(self.bounds)} bounds"
            )
        with self._lock:
            i = self._slot(t)
            counts, _, _ = self._data[i]
            total = 0
            for j, d in enumerate(delta_counts):
                d = int(d)
                if d > 0:
                    counts[j] += d
                    total += d
            cell = self._data[i]
            cell[1] += total
            cell[2] += float(delta_sum)

    # -- read side ----------------------------------------------------------

    def _live_cells(self, window: float, now: Optional[float]) -> List[Any]:
        now = self.clock() if now is None else now
        first_epoch = int((now - window) // self.interval)
        last_epoch = int(now // self.interval)
        first_epoch = max(first_epoch, last_epoch - self.capacity + 1)
        out = []
        with self._lock:
            for epoch in range(first_epoch, last_epoch + 1):
                i = epoch % self.capacity
                if self._epochs[i] == epoch and self._data[i] is not None:
                    out.append(self._data[i])
        return out

    def window_sum(self, window: float, now: Optional[float] = None) -> float:
        cells = self._live_cells(window, now)
        if self.kind == COUNTER:
            return float(sum(cells))
        if self.kind == GAUGE:
            return float(sum(c[1] for c in cells))
        return float(sum(c[2] for c in cells))

    def window_count(self, window: float, now: Optional[float] = None) -> int:
        cells = self._live_cells(window, now)
        if self.kind == COUNTER:
            return len(cells)
        return int(sum(c[0] if self.kind == GAUGE else c[1] for c in cells))

    def window_rate(self, window: float, now: Optional[float] = None) -> float:
        """Counter increments per second over the window."""
        return self.window_sum(window, now) / max(window, 1e-9)

    def window_avg(self, window: float, now: Optional[float] = None) -> float:
        """Mean of gauge samples (or histogram observations) in the window;
        0.0 when empty."""
        cells = self._live_cells(window, now)
        if self.kind == GAUGE:
            n = sum(c[0] for c in cells)
            return (sum(c[1] for c in cells) / n) if n else 0.0
        if self.kind == HISTOGRAM:
            n = sum(c[1] for c in cells)
            return (sum(c[2] for c in cells) / n) if n else 0.0
        return self.window_rate(window, now)

    def last(self) -> Optional[float]:
        """Most recent gauge sample, regardless of age (dashboards)."""
        with self._lock:
            newest, value = -1, None
            for epoch, cell in zip(self._epochs, self._data):
                if cell is not None and epoch > newest:
                    if self.kind == GAUGE:
                        if cell[0]:
                            newest, value = epoch, cell[2]
                    elif self.kind == COUNTER:
                        newest, value = epoch, float(cell)
        return value

    def _merged_counts(self, window: float, now: Optional[float]) -> Tuple[List[int], int]:
        merged = [0] * len(self.bounds)
        total = 0
        for counts, n, _ in self._live_cells(window, now):
            total += n
            for j, c in enumerate(counts):
                merged[j] += c
        return merged, total

    def window_percentile(
        self, q: float, window: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Bucket-interpolated quantile over the window (None when empty)."""
        if self.kind != HISTOGRAM:
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        merged, total = self._merged_counts(window, now)
        if total == 0:
            return None
        rank = q * total
        prev_bound = 0.0
        cum = 0
        for bound, c in zip(self.bounds, merged):
            cum += c
            if cum >= rank:
                if math.isinf(bound):
                    return prev_bound  # clamp to last finite bound
                frac = (rank - (cum - c)) / c if c else 1.0
                return prev_bound + (bound - prev_bound) * frac
            if not math.isinf(bound):
                prev_bound = bound
        return prev_bound

    def window_fraction_le(
        self, threshold: float, window: float, now: Optional[float] = None
    ) -> Optional[float]:
        """Fraction of windowed samples ≤ threshold (the "good events" ratio
        of a latency SLO), interpolating within the straddling bucket.
        None when the window is empty — the caller decides what no data
        means (the SLO engine treats it as compliant: no traffic burns no
        budget)."""
        if self.kind != HISTOGRAM:
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        merged, total = self._merged_counts(window, now)
        if total == 0:
            return None
        good = 0.0
        prev_bound = 0.0
        for bound, c in zip(self.bounds, merged):
            if threshold >= bound:
                good += c
            else:
                if not math.isinf(bound) and threshold > prev_bound:
                    good += c * (threshold - prev_bound) / (bound - prev_bound)
                break
            if not math.isinf(bound):
                prev_bound = bound
        return min(good / total, 1.0)

    def dump(self, windows: Sequence[float]) -> dict:
        out: Dict[str, Any] = {"kind": self.kind}
        for w in windows:
            key = f"{w:g}s"
            if self.kind == COUNTER:
                out[key] = {"sum": self.window_sum(w), "rate": self.window_rate(w)}
            elif self.kind == GAUGE:
                out[key] = {"avg": self.window_avg(w), "last": self.last()}
            else:
                out[key] = {
                    "count": self.window_count(w),
                    "p50": self.window_percentile(0.50, w),
                    "p95": self.window_percentile(0.95, w),
                    "p99": self.window_percentile(0.99, w),
                }
        return out


class MetricStore:
    """Labeled series registry. ``series(name, **labels)`` creates on first
    use with the declared kind/bounds (default: gauge). One store per
    concern — the process-global edge store, one per cluster aggregator."""

    def __init__(
        self,
        policy: Optional[TelemetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or TelemetryPolicy.from_env()
        self.clock = clock
        self.interval, self.capacity = self.policy.ring_spec()
        self._declared: Dict[str, Tuple[str, Optional[Tuple[float, ...]]]] = {}
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], TimeSeries] = {}
        self._lock = threading.Lock()

    def declare(
        self, name: str, kind: str, bounds: Optional[Sequence[float]] = None
    ) -> None:
        self._declared[name] = (kind, tuple(bounds) if bounds else None)

    def series(self, name: str, **labels: str) -> TimeSeries:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    kind, bounds = self._declared.get(name, (GAUGE, None))
                    if kind == HISTOGRAM and bounds is None:
                        bounds = DEFAULT_LATENCY_BOUNDS_MS
                    s = TimeSeries(
                        name, kind, self.interval, self.capacity,
                        bounds=bounds, clock=self.clock,
                    )
                    self._series[key] = s
        return s

    def labels_of(self, name: str) -> List[Dict[str, str]]:
        """Every label set seen for a series name (SLO fan-out per model)."""
        return [
            dict(lbls) for (n, lbls) in self._series.keys() if n == name
        ]

    def dump(self, windows: Optional[Sequence[float]] = None) -> dict:
        p = self.policy
        windows = windows or (p.fast_window, p.mid_window, p.slow_window)
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._series.items())
        for (name, lbls), s in items:
            label_str = ",".join(f"{k}={v}" for k, v in lbls)
            out[f"{name}{{{label_str}}}" if label_str else name] = s.dump(windows)
        return out


# ---------------------------------------------------------------------------
# SLO model
# ---------------------------------------------------------------------------

# evaluation modes
LATENCY = "latency"        # histogram series + threshold: good = sample ≤ t
RATIO = "ratio"            # counter pair: good = 1 - bad/total
AVAILABILITY = "availability"  # gauge of 0/1 samples: good ratio = window avg


@dataclass(frozen=True)
class Slo:
    """One declarative objective.

    ``target`` is the good-event ratio (0.95 ⇒ "95% of events are good");
    the error budget is ``1 - target``. ``metric`` is the series holding
    the events; for :data:`RATIO` mode ``bad_metric`` holds the bad-event
    counter and ``metric`` the total. ``threshold`` (latency mode) is in
    the series' own unit (ms here).
    """

    name: str
    metric: str
    mode: str = LATENCY
    target: float = 0.95
    threshold: Optional[float] = None
    bad_metric: Optional[str] = None
    description: str = ""

    def good_ratio(
        self, store: MetricStore, window: float, labels: Dict[str, str],
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Good-event fraction over the window; None = no data."""
        if self.mode == LATENCY:
            return store.series(self.metric, **labels).window_fraction_le(
                float(self.threshold or 0.0), window, now
            )
        if self.mode == RATIO:
            total = store.series(self.metric, **labels).window_sum(window, now)
            if total <= 0:
                return None
            bad = store.series(self.bad_metric or "", **labels).window_sum(
                window, now
            )
            return max(0.0, 1.0 - bad / total)
        if self.mode == AVAILABILITY:
            s = store.series(self.metric, **labels)
            if s.window_count(window, now) == 0:
                return None
            return s.window_avg(window, now)
        raise ValueError(f"unknown SLO mode {self.mode!r}")


def declare_standard_series(
    store_: MetricStore,
    latency_bounds: Optional[Sequence[float]] = None,
) -> MetricStore:
    """Declare the series the default SLO catalog reads. Every store that
    feeds a :class:`SloEngine` must run this (the global store and the
    cluster aggregator both do) — an undeclared series defaults to a gauge
    and a latency SLO would then query the wrong kind."""
    bounds = tuple(latency_bounds or DEFAULT_LATENCY_BOUNDS_MS)
    store_.declare("ttft_ms", HISTOGRAM, bounds=bounds)
    store_.declare("itl_ms", HISTOGRAM, bounds=bounds)
    store_.declare("requests_total", COUNTER)
    store_.declare("requests_errored", COUNTER)
    store_.declare("requests_shed", COUNTER)
    store_.declare("worker_available", GAUGE)
    return store_


def default_slos(policy: TelemetryPolicy) -> List[Slo]:
    """The serving SLO catalog (docs/observability.md §Cluster telemetry)."""
    return [
        Slo("ttft_p95", metric="ttft_ms", mode=LATENCY, target=0.95,
            threshold=policy.ttft_target_ms,
            description="95% of requests see first token within target"),
        Slo("itl_p95", metric="itl_ms", mode=LATENCY, target=0.95,
            threshold=policy.itl_target_ms,
            description="95% of inter-token gaps within target"),
        Slo("error_rate", metric="requests_total", mode=RATIO, target=0.999,
            bad_metric="requests_errored",
            description="99.9% of requests finish without error"),
        Slo("overload_share", metric="requests_total", mode=RATIO,
            target=0.99, bad_metric="requests_shed",
            description="≤1% of requests shed by admission control"),
        Slo("availability", metric="worker_available", mode=AVAILABILITY,
            target=0.99,
            description="99% of worker heartbeats healthy and serving"),
    ]


@dataclass
class SloStatus:
    """One SLO's evaluated state for one label set."""

    slo: str
    labels: Dict[str, str]
    target: float
    threshold: Optional[float]
    ratio_fast: Optional[float]
    ratio_slow: Optional[float]
    burn_fast: float
    burn_mid: float
    burn_slow: float
    # "ok" | "burning" (ticket: slow budget burning) | "alert" (page)
    state: str = "ok"
    compliant: bool = True

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["labels"] = dict(self.labels)
        return d


class SloEngine:
    """Evaluates a catalog of :class:`Slo` against a :class:`MetricStore`.

    Burn rate over a window W = (bad fraction over W) / error budget: 1.0
    means the budget is being spent exactly at the sustainable pace, 14.4
    means a 30-day budget dies in 2 days. Evaluation is pure (no background
    task): callers evaluate on render/dump, so a test with an injected
    clock is fully deterministic.
    """

    def __init__(
        self,
        store: MetricStore,
        policy: Optional[TelemetryPolicy] = None,
        slos: Optional[List[Slo]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.store = store
        self.policy = policy or store.policy
        self.slos = list(slos) if slos is not None else default_slos(self.policy)
        self.clock = clock or store.clock

    def add(self, slo: Slo) -> None:
        self.slos.append(slo)

    def _burn(self, ratio: Optional[float], budget: float) -> float:
        if ratio is None:  # no traffic burns no budget
            return 0.0
        return (1.0 - ratio) / max(budget, 1e-9)

    def evaluate_one(self, slo: Slo, labels: Dict[str, str]) -> SloStatus:
        p = self.policy
        now = self.clock()
        budget = 1.0 - slo.target
        r_fast = slo.good_ratio(self.store, p.fast_window, labels, now)
        r_mid = slo.good_ratio(self.store, p.mid_window, labels, now)
        r_slow = slo.good_ratio(self.store, p.slow_window, labels, now)
        b_fast = self._burn(r_fast, budget)
        b_mid = self._burn(r_mid, budget)
        b_slow = self._burn(r_slow, budget)
        # multi-window: the page needs fast AND mid burning hot (the mid
        # confirmation keeps one bad sample after a quiet night from
        # paging). The ticket rides the slow window alone: budget spent is
        # budget spent, so after recovery the page clears within the fast
        # window but "burning" persists until the slow window drains —
        # the clear-after-slow-window semantics the e2e test asserts.
        if b_fast >= p.burn_fast and b_mid >= p.burn_fast:
            state = "alert"
        elif b_slow >= p.burn_slow:
            state = "burning"
        else:
            state = "ok"
        compliant = r_slow is None or r_slow >= slo.target
        return SloStatus(
            slo=slo.name,
            labels=dict(labels),
            target=slo.target,
            threshold=slo.threshold,
            ratio_fast=r_fast,
            ratio_slow=r_slow,
            burn_fast=round(b_fast, 3),
            burn_mid=round(b_mid, 3),
            burn_slow=round(b_slow, 3),
            state=state,
            compliant=compliant,
        )

    def evaluate(self) -> List[SloStatus]:
        out: List[SloStatus] = []
        for slo in self.slos:
            label_sets = self.store.labels_of(slo.metric) or [{}]
            for labels in label_sets:
                out.append(self.evaluate_one(slo, labels))
        return out

    def report(self) -> List[dict]:
        return [s.to_dict() for s in self.evaluate()]


# ---------------------------------------------------------------------------
# module-global state (per-process edge store + optional cluster aggregator)
# ---------------------------------------------------------------------------

_POLICY = TelemetryPolicy.from_env()
_STORE: Optional[MetricStore] = None
_ENGINE: Optional[SloEngine] = None
_CLUSTER: Optional[Any] = None  # ClusterTelemetry when an aggregator runs here
_LOCK = threading.Lock()


def configure(policy: Optional[TelemetryPolicy] = None) -> TelemetryPolicy:
    """(Re)build the global policy + store — tests call this after
    monkeypatching ``DYN_TPU_SLO_*``."""
    global _POLICY, _STORE, _ENGINE, _CLUSTER
    with _LOCK:
        _POLICY = policy or TelemetryPolicy.from_env()
        _STORE = None
        _ENGINE = None
        _CLUSTER = None
    return _POLICY


def enabled() -> bool:
    return _POLICY.enabled


def policy() -> TelemetryPolicy:
    return _POLICY


def store() -> MetricStore:
    global _STORE
    if _STORE is None:
        with _LOCK:
            if _STORE is None:
                _STORE = declare_standard_series(MetricStore(_POLICY))
    return _STORE


def slo_engine() -> SloEngine:
    global _ENGINE
    if _ENGINE is None:
        # resolve the store BEFORE taking the module lock: store() takes
        # the same non-reentrant lock, so calling it under _LOCK deadlocks
        # on the first slo_engine() call of a process that never touched
        # the store (the profiling lag_sampler/timeline shape)
        s = store()
        with _LOCK:
            if _ENGINE is None:
                _ENGINE = SloEngine(s, _POLICY)
    return _ENGINE


def set_cluster(cluster: Optional[Any]) -> None:
    """Register this process's cluster aggregator so the edge surfaces
    (``/debug/slo``, ``/metrics`` cluster section, ``telemetry_dump``)
    include the cluster view."""
    global _CLUSTER
    _CLUSTER = cluster


def cluster() -> Optional[Any]:
    return _CLUSTER


# -- sampling helpers (the only calls on hot-ish paths; all gated) ----------


def observe_latency(name: str, ms: float, **labels: str) -> None:
    """One latency sample into the process-global store (edge TTFT/ITL).
    Returns before allocating when sampling is disabled."""
    if not _POLICY.enabled:
        return
    store().series(name, **labels).observe(ms)


def count_request(outcome: str, **labels: str) -> None:
    """One finished edge request: outcome ``success`` | ``error`` |
    ``overloaded`` (matches the InflightGuard status labels)."""
    if not _POLICY.enabled:
        return
    store().series("requests_total", **labels).inc()
    if outcome == "overloaded":
        store().series("requests_shed", **labels).inc()
    elif outcome != "success":
        store().series("requests_errored", **labels).inc()


# -- exposition -------------------------------------------------------------


def render_process_info(extra_labels: Optional[Dict[str, str]] = None) -> str:
    """``dynamo_uptime_seconds`` + ``dynamo_build_info`` exposition lines
    (appended to every /metrics this process serves)."""
    # imported here: the metrics module imports this one
    from ..llm.http.metrics import fmt_labels

    info = dict(build_info())
    if extra_labels:
        info.update(extra_labels)
    lines = [
        "# HELP dynamo_uptime_seconds Seconds since this process started",
        "# TYPE dynamo_uptime_seconds gauge",
        f"dynamo_uptime_seconds {uptime_seconds():.3f}",
        "# HELP dynamo_build_info Build/runtime identity (constant 1)",
        "# TYPE dynamo_build_info gauge",
        f"dynamo_build_info{fmt_labels(info)} 1",
    ]
    return "\n".join(lines) + "\n"


def render_cluster_metrics() -> str:
    """The cluster section for /metrics — empty when no aggregator is
    registered in this process."""
    c = _CLUSTER
    if c is None:
        return ""
    try:
        return c.render_prometheus()
    except Exception:  # cluster hiccups must never break /metrics
        return ""


def dump_state() -> dict:
    """Everything ``GET /debug/slo`` returns: process identity, the local
    store, the local SLO report, and — when an aggregator is registered
    here — the cluster rollup + cluster SLOs."""
    out: Dict[str, Any] = {
        "uptime_s": round(uptime_seconds(), 3),
        "build": build_info(),
        "enabled": _POLICY.enabled,
    }
    if _POLICY.enabled:
        out["series"] = store().dump()
        out["slo"] = slo_engine().report()
    c = _CLUSTER
    if c is not None:
        try:
            out["cluster"] = c.dump()
        except Exception:
            out["cluster"] = {"error": "cluster dump failed"}
    return json.loads(json.dumps(out))  # ensure wire-safe plain types
