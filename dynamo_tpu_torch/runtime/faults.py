"""Deterministic fault injection: the engine plane.

The port's copy of the engine plane of the JAX package's
``runtime/faults.py``, so that the port's chaos drills are the JAX drills:
the same rules, the same seeded RNG, the same per-(plane, addr, point)
op counters and the same decision log. The engine consults it at three
points, each one None-check when no injector is installed:

- ``poison`` at ``dispatch`` (:func:`poison_gate`): the dispatch's logits
  become NaN on the device, and the output watchdog must end every lane
  before a token of it escapes;
- ``corrupt`` at ``pages`` (:func:`corrupt_array`): one byte of a host-tier
  spill is flipped (bad host RAM), and the seal checksum must catch it at
  the rehit;
- ``slow`` at ``dispatch`` (:func:`slow_gate`): seconds of host-side delay.

Activation: ``with faults.active(FaultInjector(rules, seed=42)): ...`` (or
``install()``/``uninstall()``), or ``DYN_TPU_FAULTS='[{"plane": "engine",
"point": "dispatch", "action": "poison"}]'`` plus an optional
``DYN_TPU_FAULT_SEED``, read once on the first consultation.

The connection planes of the JAX module (statestore, bus, RPC, transfer:
refuse, reset, stall, wedge, cut, blackout) wait for the port's
distributed runtime; their rules parse here but never fire.
"""

from __future__ import annotations

import contextlib
import json
import logging
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .envknobs import env_nonneg_int, env_raw

logger = logging.getLogger(__name__)

# the decision log is bounded: a soak run with a high-frequency rule fires
# millions of decisions, and the replay log must stay a window
FAULT_LOG_MAX = 256


class _BoundedLog(deque):
    """Bounded decision log that still answers ``log[-10:]``."""

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self)[i]
        return deque.__getitem__(self, i)


@dataclass
class FaultRule:
    """One fault to inject. Matching is AND across the fields:

    ``plane``       "engine" here ("*" = any plane).
    ``point``       "dispatch" (once per engine dispatch) or "pages" (once
                    per host-tier spill).
    ``action``      poison | slow (at dispatch), corrupt (at pages).
    ``match_addr``  exact address (the engine's ``_fault_addr``; None =
                    any).
    ``after_ops``   skip the first N matching ops (per plane, addr and
                    point).
    ``max_fires``   total firings across the injector (None = unlimited).
    ``probability`` chance to fire when otherwise matching; drawn from the
                    injector's seeded RNG (1.0 = always).
    ``delay``       seconds: the fixed part of a ``slow`` dispatch delay.
    ``jitter``      seconds: a ``slow`` dispatch's uniform random extra
                    delay, drawn from the seeded RNG.
    """

    plane: str = "*"
    point: str = "connect"
    action: str = "refuse"
    match_addr: Optional[str] = None
    after_ops: int = 0
    max_fires: Optional[int] = None
    probability: float = 1.0
    delay: float = 0.0
    jitter: float = 0.0
    fired: int = field(default=0, compare=False)

    def matches(self, plane: str, addr: str, point: str, op_index: int) -> bool:
        if self.point != point:
            return False
        if self.plane != "*" and self.plane != plane:
            return False
        if self.match_addr is not None and self.match_addr != addr:
            return False
        if op_index < self.after_ops:
            return False
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        return True

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        known = {k: d[k] for k in (
            "plane", "point", "action", "match_addr", "after_ops",
            "max_fires", "probability", "delay", "jitter",
        ) if k in d}
        return cls(**known)


@dataclass
class FaultDecision:
    plane: str
    addr: str
    point: str
    op_index: int
    action: str
    # global draw-order stamp: two same-seed runs produce identical logs
    seq: int = 0
    # the RNG draw the action consumed (corrupt's byte offset, slow's jitter)
    detail: str = ""


class FaultInjector:
    """The rule set, the seeded RNG, and the decision log (every fired
    fault in order: printed with the seed, it replays the schedule)."""

    def __init__(self, rules: Optional[List[FaultRule]] = None, seed: int = 0):
        self.rules: List[FaultRule] = list(rules or [])
        self.seed = seed
        self.rng = random.Random(seed)
        self.log: "deque[FaultDecision]" = _BoundedLog(maxlen=FAULT_LOG_MAX)
        self._seq = 0
        self._sync_ops: Dict[Tuple[str, str, str], int] = {}

    def note_draw(self, detail: str) -> None:
        """Annotate the newest logged decision with the RNG draw its action
        consumed, so two same-seed runs can be diffed entry for entry."""
        if self.log:
            self.log[-1].detail = detail

    def decide_sync(self, plane: str, addr: str, point: str, action: str) -> bool:
        """Synchronous decision for data-mutating faults (``corrupt`` /
        ``poison``): True when a matching rule of exactly that action
        fired. Matching filters on the action before consuming the rule,
        so a rule of another action neither burns its budget nor logs a
        decision it never applied. Counted per (plane, addr, point), so
        ``after_ops`` reads "let N spills / dispatches through"."""
        return self.decide_sync_rule(plane, addr, point, action) is not None

    def decide_sync_rule(self, plane: str, addr: str, point: str,
                         action: str) -> Optional[FaultRule]:
        """:meth:`decide_sync` returning the fired rule itself (``slow``
        reads its ``delay``/``jitter``)."""
        key = (plane, addr, point)
        op = self._sync_ops.get(key, 0)
        self._sync_ops[key] = op + 1
        for rule in self.rules:
            if rule.action != action:
                continue
            if not rule.matches(plane, addr, point, op):
                continue
            if rule.probability < 1.0 and self.rng.random() >= rule.probability:
                continue
            rule.fired += 1
            self._seq += 1
            self.log.append(FaultDecision(plane, addr, point, op, rule.action, seq=self._seq))
            return rule
        return None


# =========================================================================
# activation
# =========================================================================

_active: Optional[FaultInjector] = None
_env_checked = False


def install(injector: FaultInjector) -> None:
    global _active
    _active = injector


def uninstall() -> None:
    global _active
    _active = None


@contextlib.contextmanager
def active(injector: FaultInjector) -> Iterator[FaultInjector]:
    """Scope an injector over a block; always uninstalled on exit."""
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def current() -> Optional[FaultInjector]:
    """The active injector, if any; checks the environment once."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        spec = env_raw("DYN_TPU_FAULTS")
        if spec:
            try:
                _active = injector_from_spec(
                    spec, seed=env_nonneg_int("DYN_TPU_FAULT_SEED", 0)
                )
                logger.warning(
                    "fault injection ACTIVE from DYN_TPU_FAULTS (%d rules, seed=%d)",
                    len(_active.rules), _active.seed,
                )
            except (ValueError, TypeError):
                logger.exception("malformed DYN_TPU_FAULTS spec ignored")
    return _active


def injector_from_spec(spec: str, seed: int = 0) -> FaultInjector:
    """Parse a JSON list of rule dicts into an injector."""
    raw = json.loads(spec)
    if not isinstance(raw, list):
        raise ValueError("DYN_TPU_FAULTS must be a JSON list of rule objects")
    return FaultInjector([FaultRule.from_dict(d) for d in raw], seed=seed)


def corrupt_array(plane: str, addr: str, arr):
    """The "bad host RAM" leg of the silent-corruption drill: when a
    ``corrupt`` rule at ``pages`` fires, flip one bit of one byte of a copy
    of ``arr`` (a host-tier spill's pages: a numpy array or a CPU tensor)
    at an offset drawn from the seeded RNG and recorded in the decision
    log. Returns the corrupted copy when the rule fires, else ``arr``."""
    inj = current()
    if inj is None:
        return arr
    if not inj.decide_sync(plane, addr, "pages", "corrupt"):
        return arr
    if isinstance(arr, torch.Tensor):
        out = arr.clone(memory_format=torch.contiguous_format)
        flat = out.view(-1).view(torch.uint8)
        n = flat.numel()
    else:
        out = np.array(arr)
        flat = out.view(np.uint8).reshape(-1)
        n = flat.size
    if n == 0:
        return arr
    i = inj.rng.randrange(n)
    inj.note_draw(f"offset={i}")
    flat[i] ^= 0x01
    return out


def slow_gate(plane: str, addr: str) -> float:
    """Seconds of injected host-side delay for this dispatch under a
    ``slow`` rule at ``dispatch``: ``rule.delay`` plus a uniform draw from
    ``[0, rule.jitter)`` off the seeded RNG; 0.0 when no rule fires."""
    inj = current()
    if inj is None:
        return 0.0
    rule = inj.decide_sync_rule(plane, addr, "dispatch", "slow")
    if rule is None:
        return 0.0
    d = max(rule.delay, 0.0)
    if rule.jitter > 0.0:
        j = rule.jitter * inj.rng.random()
        inj.note_draw(f"jitter={j:.6f}")
        d += j
    return d


def poison_gate(plane: str, addr: str) -> bool:
    """True when a ``poison`` rule at ``dispatch`` fires for this dispatch:
    its logits are then overwritten with NaN on the device (a core that
    computes garbage), and the output watchdog must end every lane of it.
    Called from the engine thread once per dispatch."""
    inj = current()
    if inj is None:
        return False
    return inj.decide_sync(plane, addr, "dispatch", "poison")
