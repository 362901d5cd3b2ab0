"""End-to-end KV/output integrity: silent-corruption defense.

The port's copy of the JAX package's ``runtime/integrity.py``, with the
same knobs, defaults, clamps, checksums and trip accounting:

- **Block content checksums**: a per-KV-block crc32 computed when the block
  is sealed (``allocator.note_tokens_computed``) that travels *with* the
  block into the host-RAM tier and is verified when the block is hit
  there again. A mismatch drops the block as a prefix miss and the prompt
  recomputes: corrupt bytes are never injected into the device pool.
- **The output watchdog**: the engine's step functions substitute
  :data:`WATCHDOG_TOKEN` for a lane whose logits are non-finite or larger
  than ``logit_limit``; the engine ends that stream in-band.
- **Trip accounting + quarantine**: every verification failure and every
  watchdog trip is a *trip* against this worker. ``trip_threshold`` trips
  within ``trip_window`` seconds latch the process into **quarantine**
  (the latch and counters are here; the health plane and router exclusion
  that act on it wait for the port's distributed runtime).

``DYN_TPU_KV_INTEGRITY=0`` is the zero-overhead gate: no checksum is ever
computed, no tracker or policy object is ever constructed, and the
engine's step functions are exactly the ones without the plane.

Checksums are computed at seal by the worker that computed the KV, so they
catch corruption that happens after the seal (in device memory between
seal and reuse, in host RAM in the spill tier). A core that computes wrong
values before the seal produces a self-consistent checksum; the output
watchdog covers that case.

Bytes: a page's checksum is zlib's crc32 over its raw bytes in row-major
order, so a bf16 tensor is read through ``.view(torch.int16)``: the same
bytes ``ml_dtypes`` gives the JAX package for the same values, and the
same checksums.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .envknobs import env_clamped_float, env_clamped_int, env_flag

logger = logging.getLogger(__name__)

ENV_KV_INTEGRITY = "DYN_TPU_KV_INTEGRITY"
ENV_TRIPS = "DYN_TPU_INTEGRITY_TRIPS"
ENV_WINDOW = "DYN_TPU_INTEGRITY_WINDOW"
ENV_LOGIT_LIMIT = "DYN_TPU_INTEGRITY_LOGIT_LIMIT"

# the sampled token the step functions substitute for a lane whose logits
# trip the output watchdog: real token ids are >= 0, so the host finds a
# tripped lane from the tokens it fetches anyway (no extra output or copy)
WATCHDOG_TOKEN = -2


class KvIntegrityError(ValueError):
    """KV page bytes failed their content checksum: the page was corrupted
    after it was sealed. Raised instead of serving or injecting the bytes;
    the caller drops the block as a prefix miss and recomputes."""


@dataclass(frozen=True)
class IntegrityPolicy:
    """Knob bundle of the integrity plane (malformed or non-positive values
    fall back to the defaults, in-range values clamp into the bounds).

    ``enabled``         DYN_TPU_KV_INTEGRITY (0 = the zero-overhead gate).
    ``trip_threshold``  trips within the window that latch quarantine
                        (clamped to [1, 1000]).
    ``trip_window``     seconds the trip window spans (clamped to
                        [1, 3600]).
    ``logit_limit``     |logit| above this marks a lane's output as
                        exploding even when finite (clamped to [10, 1e9]).
    """

    enabled: bool = True
    trip_threshold: int = 3
    trip_window: float = 60.0
    logit_limit: float = 1e4

    @classmethod
    def from_env(cls) -> "IntegrityPolicy":
        d = cls()
        return cls(
            enabled=env_flag(ENV_KV_INTEGRITY, d.enabled),
            trip_threshold=env_clamped_int(ENV_TRIPS, d.trip_threshold, 1, 1000),
            trip_window=env_clamped_float(ENV_WINDOW, d.trip_window, 1.0, 3600.0),
            logit_limit=env_clamped_float(ENV_LOGIT_LIMIT, d.logit_limit, 10.0, 1e9),
        )


def maybe_from_env() -> Optional[IntegrityPolicy]:
    """The gate every integration point None-checks: ``None`` unless the
    integrity plane is enabled; with ``DYN_TPU_KV_INTEGRITY=0`` no policy
    object is ever constructed."""
    if not env_flag(ENV_KV_INTEGRITY, True):
        return None
    return IntegrityPolicy.from_env()


def enabled() -> bool:
    """Cheap boolean form of the gate (one env read, no object)."""
    return env_flag(ENV_KV_INTEGRITY, True)


# ---------------------------------------------------------------------------
# block content checksums
# ---------------------------------------------------------------------------


def host_bytes(arr: Any) -> np.ndarray:
    """A C-contiguous numpy array over ``arr``'s raw bytes: a torch tensor
    is brought to the host, and a 16-bit float one is read as int16 (numpy
    has no bfloat16)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        return np.ascontiguousarray(t.numpy())
    return np.ascontiguousarray(arr)


def _arr_crc(crc: int, arr: Any) -> int:
    return zlib.crc32(host_bytes(arr), crc)


def entry_checksum(k, v, k_scale=None, v_scale=None) -> int:
    """crc32 over ONE block's page bytes ([L, bs, KVH, D] ×2, plus the
    [L, bs] scale tables of an int8 pool), chained k | v | k_scale |
    v_scale, matching :func:`page_checksums` per block."""
    crc = _arr_crc(0, k)
    crc = _arr_crc(crc, v)
    if k_scale is not None:
        crc = _arr_crc(crc, k_scale)
        crc = _arr_crc(crc, v_scale)
    return crc


def page_checksums(k, v, k_scale=None, v_scale=None) -> List[int]:
    """Per-block crc32 over a stacked page set ([L, n, bs, KVH, D] ×2 and,
    for int8 pools, [L, n, bs] scale tables ×2)."""
    n = k.shape[1]
    out: List[int] = []
    for i in range(n):
        out.append(entry_checksum(
            k[:, i], v[:, i],
            k_scale[:, i] if k_scale is not None else None,
            v_scale[:, i] if v_scale is not None else None,
        ))
    return out


def verify_pages(k, v, scales, crcs: Optional[Sequence[Optional[int]]],
                 where: str = "") -> None:
    """Verify a page set against its travelling checksums.

    ``crcs`` entries of ``None``/negative mean "the sender had no checksum
    for this block" and are skipped. Raises :class:`KvIntegrityError` at
    the first mismatching block, before any byte can land in a pool."""
    if crcs is None:
        return
    ks, vs = (scales if scales is not None else (None, None))
    n = min(len(crcs), k.shape[1])
    for i in range(n):
        want = crcs[i]
        if want is None or (isinstance(want, int) and want < 0):
            continue
        got = entry_checksum(
            k[:, i], v[:, i],
            ks[:, i] if ks is not None else None,
            vs[:, i] if vs is not None else None,
        )
        if got != int(want):
            raise KvIntegrityError(
                f"KV block {i} failed its content checksum"
                f"{' (' + where + ')' if where else ''}: "
                f"expected {int(want):#010x}, bytes hash to {got:#010x}"
            )


# ---------------------------------------------------------------------------
# trip accounting + quarantine (process-global, thread-safe)
# ---------------------------------------------------------------------------


class IntegrityTracker:
    """Process-global integrity outcome accounting + the quarantine latch.

    Constructed lazily on the first trip/quarantine operation; with the
    integrity plane disabled nothing ever constructs it. Quarantine is a
    source set: ``trips`` (self-detected corruption crossed the threshold)
    and ``store`` (an operator's order) latch independently; an operator
    unquarantine clears both and resets the trip window."""

    def __init__(self, policy: Optional[IntegrityPolicy] = None,
                 clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._policy = policy
        # "kv" = checksum mismatches of THIS process's pages, "watchdog" =
        # output-watchdog lane trips, "remote" = a peer's corrupt pages
        self.kv_failures_total = 0
        self.watchdog_trips_total = 0
        self.remote_failures_total = 0
        self._trips: deque = deque(maxlen=1024)  # (monotonic t, kind, where)
        self._quarantine_sources: set = set()
        self.quarantine_reason = ""
        self.quarantines_total = 0

    def _pol(self) -> IntegrityPolicy:
        # env read per trip, not per token: trips are failure events
        return self._policy or IntegrityPolicy.from_env()

    # -- trips -------------------------------------------------------------

    def note_trip(self, kind: str, where: str = "") -> bool:
        """Record one self-attributable trip ("kv" | "watchdog"). Returns
        True when this trip crossed the threshold and latched quarantine."""
        pol = self._pol()
        now = self._clock()
        with self._lock:
            if kind == "watchdog":
                self.watchdog_trips_total += 1
            else:
                self.kv_failures_total += 1
            self._trips.append((now, kind, where))
            in_window = sum(1 for t, _, _ in self._trips if now - t <= pol.trip_window)
            if in_window >= pol.trip_threshold and "trips" not in self._quarantine_sources:
                self._quarantine_sources.add("trips")
                self.quarantine_reason = (
                    f"{in_window} integrity trips within "
                    f"{pol.trip_window:.0f}s (last: {kind}"
                    f"{' @' + where if where else ''})"
                )
                self.quarantines_total += 1
                logger.error("worker QUARANTINED: %s; its pages are untrusted",
                             self.quarantine_reason)
                return True
        logger.error(
            "integrity trip (%s%s): %d/%d within the window", kind,
            " @" + where if where else "", in_window, pol.trip_threshold,
        )
        return False

    def note_remote_failure(self, where: str = "") -> None:
        """A peer's pages failed verification here: counted, not blamed on
        this worker."""
        with self._lock:
            self.remote_failures_total += 1
        logger.warning("rejected corrupt KV pages from a peer (%s)", where)

    # -- quarantine latch --------------------------------------------------

    @property
    def quarantined(self) -> bool:
        with self._lock:
            return bool(self._quarantine_sources)

    def quarantine(self, source: str = "store", reason: str = "") -> None:
        with self._lock:
            fresh = not self._quarantine_sources
            self._quarantine_sources.add(source)
            if reason or fresh:
                self.quarantine_reason = reason or f"ordered via {source}"
            if fresh:
                self.quarantines_total += 1

    def clear_quarantine(self, source: Optional[str] = None) -> None:
        """``source=None`` is the operator unquarantine: every source is
        cleared and the trip window reset (else the next check would
        re-latch off the old trips)."""
        with self._lock:
            if source is None:
                self._quarantine_sources.clear()
                self._trips.clear()
                self.quarantine_reason = ""
            else:
                self._quarantine_sources.discard(source)
                if not self._quarantine_sources:
                    self.quarantine_reason = ""

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "kv_integrity_failures_total": self.kv_failures_total,
                "watchdog_trips_total": self.watchdog_trips_total,
                "kv_integrity_remote_failures_total": self.remote_failures_total,
                "quarantined": int(bool(self._quarantine_sources)),
            }


_TRACKER: Optional[IntegrityTracker] = None
_TRACKER_LOCK = threading.Lock()


def tracker() -> IntegrityTracker:
    """The process-global tracker, constructed on first use (never with the
    plane disabled: callers sit behind the :func:`maybe_from_env` gate)."""
    global _TRACKER
    if _TRACKER is None:
        with _TRACKER_LOCK:
            if _TRACKER is None:
                _TRACKER = IntegrityTracker()
    return _TRACKER


def note_trip(kind: str, where: str = "") -> bool:
    return tracker().note_trip(kind, where)


def note_remote_failure(where: str = "") -> None:
    tracker().note_remote_failure(where)


def clear_quarantine(source: Optional[str] = None) -> None:
    """Constructor-free clear: a no-op until something latched."""
    t = _TRACKER
    if t is not None:
        t.clear_quarantine(source)


def quarantined() -> bool:
    """Constructor-free read: False until something built the tracker."""
    t = _TRACKER
    return t is not None and t.quarantined


def quarantine_reason() -> str:
    t = _TRACKER
    return t.quarantine_reason if t is not None else ""


def counters() -> Dict[str, int]:
    """Constructor-free counters: zeros until a trip or quarantine happened
    in this process."""
    t = _TRACKER
    if t is None:
        return {
            "kv_integrity_failures_total": 0,
            "watchdog_trips_total": 0,
            "kv_integrity_remote_failures_total": 0,
            "quarantined": 0,
        }
    return t.counters()


def reset_for_tests() -> None:
    """Drop the process-global tracker, so that one test's trips do not
    bleed into another's."""
    global _TRACKER
    with _TRACKER_LOCK:
        _TRACKER = None
