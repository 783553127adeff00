"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``csrc/build/lib<name>-<digest>.so``, where the
digest covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source or header never loads a stale library. The library is then loaded with :mod:`ctypes`. Nothing is
built at import time, and a missing ``nvcc`` or a failed build raises.
:func:`build` compiles several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from acmil_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
# what the last build of each library printed (ptxas registers, spills) and
# how long it took; empty for a library found already built
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                           "CUDA_HOME to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library(name: str) -> Path:
    # the digest covers the shared headers (csrc/*.cuh) too
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> None:
    """Compile each of ``csrc/<name>.cu`` not built yet: one ``nvcc`` per
    source, all started together. Raises if any build fails."""
    with _lock, profiling.span("kernel.build"):
        running = {}
        for name in names:
            out = _library(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": log}
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building it first
    if this source and these flags have not been built yet."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(str(_library(name)))
        return _libs[name]
