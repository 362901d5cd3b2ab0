"""Tensor-parallel mesh and the logical→physical sharding rules.

Counterpart of the JAX package's ``parallel/mesh.py``. The axis names,
:class:`MeshConfig` and ``_LOGICAL_RULES`` are the JAX ones. Where JAX
builds a ``jax.sharding.Mesh`` and lets GSPMD insert the collectives, the
port keeps a list of ranks, each with its device, and spells the
collectives out (``collectives.py``). A leaf's sharding is a rule that names
which of its dimensions is split over tp (:class:`Sharding`); rank ``r``
holds the ``r``-th contiguous slice of that dimension, as JAX's addressable
shard ``r`` does on a ``tp`` mesh.

This slice runs tensor parallelism alone: ``tp > 1`` with ``dp = pp = sp =
ep = 1``. Any other shape raises (ROADMAP A7 queues pp, sp, ep). An MoE
model's ``experts`` axis maps to ep, so on such a mesh every rank holds
every expert, each at its tp slice of the FFN width (``mlp`` over tp).

:func:`make_mesh` takes ``cuda:0 … cuda:tp-1`` unless the caller names the
devices. A list may name one device more than once: the ranks then share it
(co-located ranks, how the CPU tests and ``chip_smoke.py`` run a mesh on
one device). Nothing co-locates ranks unasked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Total size must equal the number of ranks used."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_EP, AXIS_TP)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.ep, self.tp)


@dataclass(frozen=True)
class Mesh:
    """The ranks of a tp mesh: rank ``r`` runs on ``devices[r]``."""

    config: MeshConfig
    devices: Tuple[torch.device, ...]

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.config.axis_names, self.config.shape))

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on every rank's device (the same tensor where it already
        lies there)."""
        return [t if t.device == d else t.to(d) for d in self.devices]


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; name CPU devices to run "
                               "a mesh on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_config(config: MeshConfig) -> None:
    """This slice runs tp alone: any other axis above 1 raises."""
    others = {a: n for a, n in zip(config.axis_names, config.shape) if a != AXIS_TP and n != 1}
    if others:
        raise ValueError(f"mesh {others} not supported: the port runs tensor parallelism "
                         f"alone (tp > 1, dp = pp = sp = ep = 1); ROADMAP A7 queues the rest")
    if config.tp < 1:
        raise ValueError(f"tp must be >= 1, got {config.tp}")


def make_mesh(config: MeshConfig, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh's ranks on ``devices`` (default ``cuda:0 … cuda:tp-1``);
    fewer devices than ranks raise, as the JAX ``make_mesh`` does. A device
    named more than once holds that many ranks."""
    _check_config(config)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(min(have, config.size))]
    else:
        devs = list(devices)
    if len(devs) < config.size:
        raise ValueError(f"mesh needs {config.size} devices, have {len(devs)}")
    devs = [_resolve(d) for d in devs[: config.size]]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's ranks run on one kind of device: {devs}")
    return Mesh(config, tuple(devs))


# -- logical sharding rules --------------------------------------------------
# Model code annotates leaves with *logical* axis names; this table maps them
# to mesh axes (the JAX table). Unlisted logical axes are replicated.

_LOGICAL_RULES = {
    "batch": AXIS_DP,
    "seq": AXIS_SP,
    "layers": AXIS_PP,  # stacked layer axis → pipeline stages
    "heads": AXIS_TP,  # attention query heads
    "kv_heads": AXIS_TP,  # attention kv heads (GQA)
    "mlp": AXIS_TP,  # MLP intermediate dim
    "vocab": AXIS_TP,  # embedding/unembedding vocab dim
    "experts": AXIS_EP,  # MoE expert axis
    "embed": None,  # model dim: replicated (Megatron-style TP)
    "kv_blocks": None,  # paged-KV physical block axis: replicated across tp
}


@dataclass(frozen=True)
class Sharding:
    """Which dimension of a leaf is split over ``parts`` ranks (``dim``
    None: replicated). Rank ``r`` holds the ``r``-th contiguous slice."""

    dim: Optional[int]
    parts: int

    def shard(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s slice of the whole leaf ``t`` (a view)."""
        if self.dim is None or self.parts == 1:
            return t
        n = t.shape[self.dim]
        if n % self.parts:
            raise ValueError(f"dimension {self.dim} of {tuple(t.shape)} does not split "
                             f"evenly over {self.parts} ranks")
        w = n // self.parts
        return t.narrow(self.dim, r * w, w)


def logical_to_sharding(mesh: Mesh, *logical_axes: Optional[str]) -> Sharding:
    """Map a tuple of logical axis names (or None) to the leaf's rule: the
    one dimension that maps to a mesh axis of size > 1, or none."""
    split = None
    for i, ax in enumerate(logical_axes):
        if ax is None:
            continue
        if ax not in _LOGICAL_RULES:
            raise KeyError(f"unknown logical axis {ax!r}")
        mesh_ax = _LOGICAL_RULES[ax]
        if mesh_ax is not None and mesh.shape.get(mesh_ax, 1) > 1:
            if split is not None:
                raise ValueError(f"axes {logical_axes} split two dimensions over the mesh")
            split = i
    return Sharding(split, mesh.tp if split is not None else 1)


def kv_cache_sharding(mesh: Mesh) -> Sharding:
    """The paged pool [layers, blocks, block_size, kv_heads, head_dim]: kv
    heads over tp, blocks replicated (each rank's pool holds every block
    for its heads)."""
    return logical_to_sharding(mesh, "layers", "kv_blocks", None, "kv_heads", None)
