"""Worker health plane: the engine heartbeat.

The port's copy of :class:`EngineHeartbeat` from the JAX package's
``runtime/health.py``: a monotonic progress counter the ``engine_torch``
step loop bumps every iteration. A busy engine that stops beating is a
wedged engine thread.

Not here yet: the JAX module's ``HealthMonitor`` (the per-worker self-check
loop that turns a stalled heartbeat into an ``unhealthy`` self-drain, the
event-loop lag probe and the stuck-request reaper) and ``HealthPolicy``,
the ``DYN_TPU_HEALTH_*`` knobs that only the monitor reads. They drive the
RPC runtime's drain and load reports, and come with the port's RPC runtime.
"""

from __future__ import annotations

import time


class EngineHeartbeat:
    """Monotonic progress signal bumped by the engine's step loop.

    ``beat(busy=...)`` is called once per loop iteration from the engine
    thread; a monitor reads ``age()``/``busy`` from another thread.
    Single-word reads/writes only (GIL-atomic) — deliberately no lock, so a
    wedged engine thread can never wedge the monitor through it. ``busy``
    records whether the engine had work at the LAST beat: an idle engine
    parks in its condition wait (no beats, busy False — not a stall); a
    busy one that stops beating is exactly the zombie signature.
    """

    __slots__ = ("_last", "_busy", "beats")

    def __init__(self) -> None:
        self._last = time.monotonic()
        self._busy = False
        self.beats = 0

    def beat(self, busy: bool) -> None:
        self._busy = bool(busy)
        self.beats += 1
        # written last: a reader seeing the fresh timestamp sees fresh state
        self._last = time.monotonic()

    @property
    def busy(self) -> bool:
        return self._busy

    def age(self) -> float:
        return time.monotonic() - self._last
