"""The collectives of a tp mesh, spelled out.

In the JAX package GSPMD inserts these where a sharded product meets a
replicated consumer; the port calls them itself (``models/llama.py``):

- :func:`all_reduce` sums the ranks' partials of a row-parallel product
  (``wo``, ``w_down``) and of the vocab-parallel embedding lookup. It sums in
  fp32 and rounds once to the activation dtype; the row-parallel partials
  reach it unrounded, in fp32 (``models/llama.py matw_partial``), so the
  sum is rounded once, as the unsharded product is. The sum lands
  on every rank's device: ranks that share a device share one tensor; ranks
  on distinct CUDA devices reduce through NCCL
  (``torch.cuda.nccl.all_reduce``, one process driving every device).
- :func:`all_gather` concatenates the vocab-sharded logits on rank 0's
  device.

Each function counts its calls and the bytes of the partials it was given
(``all_reduce.calls``, ``all_reduce.bytes``, likewise ``all_gather``), as
the kernel wrappers count their launches; a one-rank call is no collective
and counts nothing.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch


def reset_counts() -> None:
    """Zero both collectives' counters."""
    for fn in (all_reduce, all_gather):
        fn.calls = 0
        fn.bytes = 0


def _count(fn, parts: Sequence[torch.Tensor]) -> None:
    fn.calls += 1
    fn.bytes += sum(p.numel() * p.element_size() for p in parts)


def all_reduce(parts: Sequence[torch.Tensor], dtype: Optional[torch.dtype] = None
               ) -> List[torch.Tensor]:
    """The sum of ``parts`` (one per rank, equal shapes) on each part's
    device, in ``dtype`` (default the parts'): fp32 sums, one rounding.
    Ranks on one device are summed there; the per-device sums of distinct
    CUDA devices are reduced by NCCL. One part is returned as it is, in
    ``dtype``."""
    dtype = dtype or parts[0].dtype
    if len(parts) == 1:
        return [parts[0].to(dtype)]
    _count(all_reduce, parts)
    groups: Dict[torch.device, List[torch.Tensor]] = {}
    for p in parts:
        groups.setdefault(p.device, []).append(p)
    # a fresh fp32 tensor per device: the parts are never written
    sums = {d: functools.reduce(torch.add, [p.float() for p in ps]) if len(ps) > 1
            else ps[0].to(torch.float32, copy=True) for d, ps in groups.items()}
    if len(sums) > 1:
        bufs = list(sums.values())
        if all(b.device.type == "cuda" for b in bufs):
            torch.cuda.nccl.all_reduce(bufs)
        else:
            raise ValueError(f"all_reduce across devices {list(sums)}: distinct devices "
                             "must all be CUDA devices")
    out = {d: s.to(dtype) for d, s in sums.items()}
    return [out[p.device] for p in parts]


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """``parts`` (one per rank, in rank order) concatenated along ``dim``
    on rank 0's device."""
    if len(parts) == 1:
        return parts[0]
    _count(all_gather, parts)
    dev = parts[0].device
    return torch.cat([p if p.device == dev else p.to(dev) for p in parts], dim=dim)


reset_counts()
