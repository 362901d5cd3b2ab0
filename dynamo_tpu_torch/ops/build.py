"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel source in ``csrc/`` has a plain C entry. :class:`KernelLibrary`
compiles one source with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` under the repository root, under a name keyed by
the source's hash (an edited source never loads a stale library), keeps
``-Xptxas -v``'s report of registers and spills beside the library, and
loads it with ``ctypes``. :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them. A failed build raises; nothing falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def launch_device(index: int):
    """A context in which CUDA device ``index`` is current: nothing to do
    when it already is (one device, or rank 0), else its device guard."""
    if torch.cuda.current_device() == index:
        return nullcontext()
    return torch.cuda.device(index)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class KernelLibrary:
    """One ``csrc/<name>.cu`` (or ``source``) built into
    ``lib<name>_<hash>.so``; ``bind`` sets the C entries' ``argtypes`` and
    ``restype`` on the loaded library."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 source: Optional[Path] = None):
        self.name = name
        self.source = Path(source) if source is not None else CSRC / f"{name}.cu"
        self._bind = bind
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._t0 = 0.0
        self.lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}_{tag}.so"

    def start(self) -> None:
        """Start ``nvcc`` in the background unless the library is built or
        being built; :meth:`build` waits for it."""
        with self._lock:
            out = self.path()
            if self._proc is not None or out.exists():
                return
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", str(tmp), str(self.source),
            ]
            self._t0 = time.perf_counter()
            self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)

    def build(self, verbose: bool = False) -> dict:
        """Compile the library (if not built yet) and load it. Returns
        ``{"path", "seconds", "log"}``: the library, the compile time (0 when
        an up-to-date library was found) and ptxas's report."""
        self.start()
        with self._lock:
            out = self.path()
            log_path = out.with_suffix(".ptxas.txt")
            seconds = 0.0
            if self._proc is not None:
                log, _ = self._proc.communicate()
                rc = self._proc.returncode
                self._proc = None
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                if rc != 0:
                    raise RuntimeError(f"nvcc failed on {self.source.name} ({rc}):\n{log}")
                log_path.write_text(log)
                os.replace(tmp, out)
                seconds = time.perf_counter() - self._t0
                if verbose:
                    print(log)
            log = log_path.read_text() if log_path.exists() else ""
            if self.lib is None:
                lib = ctypes.CDLL(str(out))
                self._bind(lib)
                self.lib = lib
            return {"path": str(out), "seconds": seconds, "log": log}

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self.lib is None:
            self.build()
        return self.lib


def build_all(libraries: List[KernelLibrary]) -> Dict[str, dict]:
    """Build several libraries with one ``nvcc`` each, all started together."""
    for lib in libraries:
        lib.start()
    return {lib.name: lib.build() for lib in libraries}
