"""Fail-slow defense: differential straggler detection.

The port's copy of the JAX package's ``runtime/straggler.py``, whole. A
worker that is merely *slow* (thermal throttle, a failing NIC, a noisy
co-tenant) passes every liveness and integrity check and silently drags
every stream routed to it ("Gray Failure", HotOS'17; "Fail-Slow at Scale",
FAST'18). The fix is *differential* observability: judge each worker
against its live peers, never against an absolute threshold.

Here is the worker's half of the plane, the part the engine runs:

- the gate: ``DYN_TPU_STRAGGLER`` defaults OFF and is THE zero-overhead
  gate (:func:`enabled`): with it unset no detector is ever constructed and
  the engine step loop pays one attribute None-check per dispatch.
- :class:`StragglerDetector` — a process-global, thread-safe EWMA of
  wall-microseconds-per-token over the engine's per-dispatch timings
  (ring-buffered for debug dumps). It produces the
  ``dispatch_us_per_token_ewma`` gauge of ``metrics_snapshot()`` — the
  detector never judges; normalized latency means nothing without peers.
- the worker's verdict latch (:func:`set_verdict`, :func:`verdict`),
  echoed as ``straggler_state`` in the engine's ``metrics_snapshot()``.

Not here yet: the JAX module's aggregator half, ``StragglerPolicy``'s
judging knobs (``DYN_TPU_STRAGGLER_FACTOR``, ``_WINDOW``, ``_MIN_PEERS``,
``_TRIPS``) and the ``StragglerArbiter`` that reads them to turn the fleet's
gauges into verdicts, with the control-key channel that carries verdicts
back to the latch. They run at the telemetry aggregator and come with the
port's RPC runtime.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Dict, Optional

from .envknobs import env_flag as _env_flag

logger = logging.getLogger(__name__)

ENV_STRAGGLER = "DYN_TPU_STRAGGLER"

# verdict states, in severity order. Plain strings: they cross the wire in
# metrics snapshots and control keys, and read well in logs.
OK = "ok"
SUSPECT = "suspect"
CONFIRMED = "confirmed"
STATES = (OK, SUSPECT, CONFIRMED)


def enabled() -> bool:
    """Cheap boolean form of the gate (one env read, no object)."""
    return _env_flag(ENV_STRAGGLER, False)


# ---------------------------------------------------------------------------
# worker side: the per-dispatch timing feed
# ---------------------------------------------------------------------------


class StragglerDetector:
    """Process-global EWMA of wall-us-per-token over engine dispatches.

    Constructed lazily behind :func:`maybe_detector` — with the plane off
    nothing ever constructs it (the zero-overhead guard monkeypatches this
    constructor to prove it). Thread-safe: the engine step thread feeds,
    the metrics/RPC threads read.

    Wall time (not device time) on purpose: the failure modes this plane
    exists for — thermal throttle, a failing NIC stretching host fetches,
    a noisy co-tenant stealing the host CPU — can land on either side of
    the device/host split, and a victim stream experiences their SUM. The
    per-phase EWMAs are kept for debug dumps; the published gauge is the
    all-phase blend, which is what peers are compared on.
    """

    # ring of recent (phase, us_per_token) samples for debug dumps — a
    # window, never a leak (the decision-log bound pattern)
    RING = 512
    # EWMA smoothing: ~weighting the last ~20 dispatches. Fast enough to
    # cross a detection window, slow enough that one hiccup dispatch
    # cannot impersonate a sick worker.
    ALPHA = 0.1

    def __init__(self, alpha: float = ALPHA):
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma = 0.0
        self._phase_ewma: Dict[str, float] = {}
        self._ring: deque = deque(maxlen=self.RING)
        self.samples_total = 0

    def note_dispatch(self, phase: str, wall_us: float, tokens: int) -> None:
        """One dispatch: ``wall_us`` of step-loop wall time advancing
        ``tokens`` tokens. Token-free dispatches (a cancelled-lane sweep)
        carry no per-token signal and are skipped."""
        if tokens <= 0 or wall_us < 0.0:
            return
        upt = wall_us / tokens
        with self._lock:
            self.samples_total += 1
            self._ewma = (
                upt if self.samples_total == 1
                else self._ewma + self._alpha * (upt - self._ewma)
            )
            prev = self._phase_ewma.get(phase)
            self._phase_ewma[phase] = (
                upt if prev is None else prev + self._alpha * (upt - prev)
            )
            self._ring.append((phase, round(upt, 1)))

    def us_per_token(self) -> float:
        with self._lock:
            return self._ewma

    def gauges(self) -> Dict[str, Any]:
        """The worker-gauge view, merged into
        the engine's metrics snapshot: the normalized latency the
        aggregator's arbiter compares across peers, plus the cumulative
        sample counter it uses for freshness (a stale EWMA from a paused worker must
        not be judged — see the drain-composition defense)."""
        with self._lock:
            return {
                "dispatch_us_per_token_ewma": round(self._ewma, 1),
                "straggler_samples_total": self.samples_total,
            }

    def debug_dump(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "us_per_token_ewma": round(self._ewma, 1),
                "samples_total": self.samples_total,
                "phase_ewma": {
                    k: round(v, 1) for k, v in self._phase_ewma.items()
                },
                "recent": list(self._ring)[-32:],
            }


# ---------------------------------------------------------------------------
# process-global accessors (constructor-free reads, lazy gated writes)
# ---------------------------------------------------------------------------

_DETECTOR: Optional[StragglerDetector] = None
_LOCK = threading.Lock()

# the worker's latched fleet-relative verdict, pushed back from the
# aggregator over the control-key channel. Module-global and independent
# of the detector ON PURPOSE: the health plane reads it constructor-free
# every check tick, and a drill that writes the control key by hand must
# work with the sampling plane off.
_VERDICT = OK


def maybe_detector() -> Optional[StragglerDetector]:
    """The engine's init-time hook: the process-global detector when the
    plane is armed, else ``None`` — nothing is ever constructed with
    ``DYN_TPU_STRAGGLER`` unset (the zero-overhead contract)."""
    global _DETECTOR
    if not enabled():
        return None
    if _DETECTOR is None:
        with _LOCK:
            if _DETECTOR is None:
                _DETECTOR = StragglerDetector()
    return _DETECTOR


def detector_gauges() -> Dict[str, Any]:
    """Constructor-free gauge read for the metrics publisher: empty dict
    until anything armed the plane in this process."""
    det = _DETECTOR
    if det is None:
        return {}
    return det.gauges()


def verdict() -> str:
    """The worker's current fleet-relative verdict ("ok" | "suspect" |
    "confirmed"). Constructor-free, one module-global read — the health
    monitor calls this every check tick with the plane off too."""
    return _VERDICT


def set_verdict(state: str) -> None:
    """Latch a verdict pushed from the aggregator (control-key loop) or a
    drill. Unknown states are dropped with a warning rather than raised —
    a newer aggregator must not crash an older worker's control loop."""
    global _VERDICT
    if state not in STATES:
        logger.warning("ignoring unknown straggler verdict %r", state)
        return
    if state != _VERDICT:
        log = logger.warning if state != OK else logger.info
        log("straggler verdict: %s -> %s", _VERDICT, state)
    _VERDICT = state


def clear_verdict() -> None:
    set_verdict(OK)


def reset_for_tests() -> None:
    """Drop the process-global detector and verdict latch (a test
    autouse reset: one test's samples or latched verdict must not bleed
    into another's health checks)."""
    global _DETECTOR, _VERDICT
    with _LOCK:
        _DETECTOR = None
        _VERDICT = OK
