"""The device time of a sampled dispatch, for the profiling plane.

The JAX engine times a sampled dispatch from just before its asynchronous
jit call to ``block_until_ready``: the call costs microseconds, so that is
the device's half. The port's eager forward is its own enqueue: the host
issues every kernel (thousands per decode step) and takes longer to issue
them than the card takes to run them. An event pair around the dispatch
would time the enqueue, and one taken after the call returns only the tail.

:class:`DeviceTimer` times what the card spends executing the dispatch. On
CUDA it cuts the dispatch into segments at marks the forward sets (one per
model layer, and one per layer of the window flush): in front of each
segment it enqueues the dispatch gate (``ops/dispatch_gate.py``), which
holds the stream until the host has enqueued the whole segment, and an
event; after the segment another event, then it releases the gate. The
segment's kernels then run back to back, so each event pair times the
card's execution of the segment and neither the host's enqueue nor the
card's wait for it; ``device_us()`` is their sum. A segment holds some
tens to a few hundred kernels, well under the stream's launch queue, so
the host never blocks in a launch while a gate holds the stream, and the
wait is on the engine's stream's own event, never on
``torch.cuda.synchronize()`` (which would wait for the host tier's and the
checksums' copies too). Nothing in a segment may wait for the card (a
blocking upload, ``.item()``): the engine makes its uploads before
:meth:`begin` and its fetches after :meth:`end`.

Whatever waits for the card while a segment is gated stalls the card and
the waiting thread until the gate gives up (``GATE_TIMEOUT_S``, 5 s): a
wait on the engine thread inside a segment, or one on another thread
that holds what the engine thread's next launch needs
(``torch.profiler``'s start and stop, a device-wide synchronize, the
caching allocator returning memory to the driver). The gate then lets the
stream go, the dispatch's measurement is void, the timeout is logged and
counted (``timeouts``), and the timer runs the next dispatches untimed
before it times again (``RESUME_AFTER`` of them, doubling with each
timeout, at most 64 times that), so a cause that persists costs one stall
per such run of dispatches. Code that knows it will wait for the card from
another thread enters :meth:`quiesce` around the wait: no dispatch is
timed inside it, and on entry the one in flight has released its gates.

CUDA loads a kernel's module at its first launch (PyTorch sets
``CUDA_MODULE_LOADING=LAZY``), and that load waits for the card: a first
launch behind a closed gate would block the host until the gate timed
out. :meth:`ready` therefore lets a step function be timed only once it
has run untimed: the same function at the same shapes launches the same,
loaded kernels.

On the CPU the forward runs as it is called: ``device_us()`` is the time
from :meth:`begin` to :meth:`end`.

A timed dispatch is serialized: the engine waits for its last event, as
the JAX engine's ``block_until_ready`` serializes its sampled dispatch;
``DYN_TPU_PROFILE_SAMPLE`` bounds how often.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional, Tuple

import torch

from ..ops import dispatch_gate
from ..ops.dispatch_gate import dispatch_gate_wait

logger = logging.getLogger(__name__)

# seconds a gate waits for the host before it gives up (and the dispatch's
# measurement is void)
GATE_TIMEOUT_S = 5.0
# dispatches run untimed after a gate timeout (doubling with each further
# timeout, up to 64 times this) before the timer times again
RESUME_AFTER = 64
# seconds a quiesce waits for the timed dispatch in flight to end
QUIESCE_TIMEOUT_S = 60.0


class DeviceTimer:
    """Segment-gated device timing of one dispatch at a time (engine thread):
    ``ready(fn, sampled)``, and when it says yes ``begin()``, ``mark()`` at
    each segment boundary, ``end()`` (always, in a ``finally``: it releases
    the last gate), then ``device_us()``. :meth:`quiesce` may be entered from
    any thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self._cuda = device.type == "cuda"
        self._ticket = 0
        self._segments: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._start: Optional[torch.cuda.Event] = None
        self._spare: List[torch.cuda.Event] = []
        self._t0 = self._t1 = 0.0
        self._ran: set = set()  # step functions that have run (CUDA)
        self.timeouts = 0  # dispatches whose measurement a gate timeout voided
        self._skip = 0  # dispatches still to run untimed after a timeout
        # a timed dispatch in flight (ready said yes, end not yet called),
        # and the quiescers holding timing off
        self._cond = threading.Condition()
        self._busy = False
        self._paused = 0
        if self._cuda:
            # [release counter, timeout flag]; the card reads them through
            # their unified address
            self._flags = torch.zeros(2, dtype=torch.int32, pin_memory=True)
            self._counter = self._flags.numpy().view("uint32")

    def ready(self, fn, sampled: bool = True) -> bool:
        """Whether this dispatch of step function ``fn`` is timed: it is
        ``sampled``, no :meth:`quiesce` holds timing off, it is not within
        the untimed run after a gate timeout, and on CUDA ``fn`` has run
        before (its kernels may still be loading). Every dispatch calls it:
        it counts ``fn`` as run and the dispatch into that untimed run. A
        yes must be followed by :meth:`begin` and :meth:`end`. On CUDA it
        builds the gate's library first if need be (never inside a
        segment)."""
        first = False
        if self._cuda:
            dispatch_gate.LIBRARY.load()
            first = fn not in self._ran
            self._ran.add(fn)
        with self._cond:
            if self._skip:
                self._skip -= 1
                return False
            if first or not sampled or self._paused:
                return False
            self._busy = True
            return True

    @contextmanager
    def quiesce(self) -> Iterator[None]:
        """Hold timing off: no dispatch is timed inside, and on entry the
        one in flight has released its last gate (waits up to
        ``QUIESCE_TIMEOUT_S`` for it, else raises ``TimeoutError``). For a
        thread about to wait for the card, such as one starting or
        stopping ``torch.profiler``; never for the engine thread itself."""
        with self._cond:
            self._paused += 1
            if not self._cond.wait_for(lambda: not self._busy, QUIESCE_TIMEOUT_S):
                self._paused -= 1
                raise TimeoutError("a timed dispatch did not release its gates")
        try:
            yield
        finally:
            with self._cond:
                self._paused -= 1

    def begin(self) -> None:
        self._segments.clear()
        self._t0 = time.perf_counter()
        if self._cuda:
            self._open()

    def mark(self) -> None:
        """A segment boundary: close the open segment (releasing its gate)
        and open the next."""
        if self._start is not None:
            self._close()
            self._open()

    def end(self) -> None:
        self._t1 = time.perf_counter()
        if self._start is not None:
            self._close()
        with self._cond:
            self._busy = False
            self._cond.notify_all()

    def device_us(self) -> Optional[float]:
        """Microseconds the device spent executing the dispatch; waits for
        its last event. None when a gate timed out."""
        if not self._cuda:
            return (self._t1 - self._t0) * 1e6
        if not self._segments:
            return 0.0
        self._segments[-1][1].synchronize()
        total = sum(s.elapsed_time(e) for s, e in self._segments) * 1e3
        for s, e in self._segments:
            self._spare += (s, e)
        self._segments.clear()
        if self._counter[1]:
            self._counter[1] = 0
            self._timed_out()
            return None
        return total

    def _timed_out(self) -> None:
        """A gate gave up: count it and run the next dispatches untimed."""
        self.timeouts += 1
        skip = RESUME_AFTER << min(self.timeouts - 1, 6)
        with self._cond:
            self._skip = skip
        logger.error("dispatch gate timed out (%d so far): something waited for the card "
                     "while a segment was gated; this dispatch's device time is not "
                     "recorded, and the next %d dispatches run untimed", self.timeouts, skip)

    def _event(self) -> torch.cuda.Event:
        return self._spare.pop() if self._spare else torch.cuda.Event(enable_timing=True)

    def _open(self) -> None:
        self._ticket = (self._ticket + 1) & 0xFFFFFFFF
        dispatch_gate_wait(self._flags, self._ticket, self.device, GATE_TIMEOUT_S)
        self._start = self._event()
        self._start.record()

    def _close(self) -> None:
        end = self._event()
        end.record()
        self._segments.append((self._start, end))
        self._start = None
        # the whole segment is enqueued: let the card run it
        self._counter[0] = self._ticket
