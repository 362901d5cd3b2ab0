"""``DYN_TPU_*`` env-knob parsing: the one home of the port's knob parsers.

The port's copy of the parsers its knobs read from the JAX package's
``runtime/envknobs.py`` (``env_pos_int``/``env_pos_float`` also stand in
for the ``_env_pos_int``/``_env_pos_float`` that the JAX tracing plane
imports from its ``runtime/admission.py``), with the same clamping
contract: a malformed, out-of-range or nonsensical value degrades to the
documented default, never to a policy the operator did not ask for (an
unbounded ring, a disabled plane).

====================  ======================================================
``env_raw``           raw optional string; empty string counts as unset
``env_flag``          unset → default; "0"/"false"/"no"/"off" (any case) →
                      False; anything else → True
``env_pos_int``       > 0 or the default (0 and negatives are misconfigs)
``env_nonneg_int``    >= 0 or the default (0 is a *policy*, e.g. "off")
``env_pos_float``     > 0 or the default
``env_clamped_int``   > 0 clamped into [lo, hi], else the default
``env_clamped_float`` > 0 clamped into [lo, hi], else the default
====================  ======================================================
"""

from __future__ import annotations

import os
from typing import Optional

_FALSY = ("0", "false", "no", "off")


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """Free-form knob (fault specs): the raw value, with the empty string
    treated as unset."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw


def env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in _FALSY


def env_pos_int(name: str, default: int) -> int:
    """Positive-int knob: unset, malformed, zero or negative → default (a
    bad value must never become a bound of 0 or -1)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def env_nonneg_int(name: str, default: int) -> int:
    """Non-negative int knob: ``0`` is a policy, not a misconfig; only
    malformed or negative values fall back to the default."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= 0 else default


def env_pos_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def env_clamped_int(name: str, default: int, lo: int, hi: int) -> int:
    """Positive-int knob clamped into [lo, hi]; malformed or non-positive
    values fall back to the default."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    if v <= 0:
        return default
    return min(max(v, lo), hi)


def env_clamped_float(name: str, default: float, lo: float, hi: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    if v <= 0:
        return default
    return min(max(v, lo), hi)
