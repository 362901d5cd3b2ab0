"""A reader of the safetensors format, without the ``safetensors`` package.

A file is a little-endian u64 header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (plus
``__metadata__``, ignored), then the raw little-endian buffers, offsets
relative to the end of the header. :class:`SafetensorsFile` maps a file
with ``mmap`` (copy-on-write, so nothing is read until a tensor is used and
the file is never written) and gives each tensor as a CPU tensor over the
mapping (``torch.frombuffer``; BF16 is ``torch.bfloat16`` as stored, no
upcast). A caller copies tensors to the device one at a time, so host RAM
never holds a second copy of the model.

:func:`hf_tensors` finds files as the JAX package's
``engine_jax/weights.py::_hf_tensors`` does: every ``*.safetensors`` in the
directory, sorted; an index json is neither needed nor read.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
}


class SafetensorsFile(Mapping[str, torch.Tensor]):
    """One mapped ``.safetensors`` file: name → CPU tensor over the mapping."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._data_start = 8 + n
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = DTYPES.get(info.get("dtype"))
            if dt is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info.get('dtype')!r}; "
                                 f"the reader takes {sorted(DTYPES)}")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            count = 1
            for d in shape:
                count *= d
            if end - begin != count * dt.itemsize or self._data_start + end > size:
                raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for "
                                 f"shape {shape} {info['dtype']}")
            self._entries[name] = (dt, shape, begin, end)

    def __getitem__(self, name: str) -> torch.Tensor:
        dt, shape, begin, end = self._entries[name]
        if begin == end:
            return torch.empty(shape, dtype=dt)
        offset = self._data_start + begin
        if offset % dt.itemsize:  # not aligned for a view: copy these bytes
            raw = bytearray(self._map[offset:self._data_start + end])
            return torch.frombuffer(raw, dtype=dt).reshape(shape)
        return torch.frombuffer(self._map, dtype=dt, count=(end - begin) // dt.itemsize,
                                offset=offset).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


class _Merged(Mapping[str, torch.Tensor]):
    """Several files' tensors under one name space (a later file's name wins,
    as in the JAX package's merge)."""

    def __init__(self, files):
        self.files = files
        self._where = {name: f for f in files for name in f}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name][name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def hf_tensors(model_path: str) -> Optional[Mapping[str, torch.Tensor]]:
    """Every tensor of the directory's ``*.safetensors`` files (sorted), or
    None when it has none."""
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if not files:
        return None
    return _Merged([SafetensorsFile(f) for f in files])
