"""Build and load the hand kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface,
``janus_tpu_torch/build/lib<name>.so``, and loaded with ``ctypes``. A
library is rebuilt when it is missing or older than its source. The build
happens on first use, or up front for every kernel at once with
``build_all`` (one ``nvcc`` per source, all started together). A library
is also rebuilt when a shared header (``csrc/*.cuh``) is newer than it. A
failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS = ("pnc_apply", "replica_join", "tusk_commit", "causal_closure",
           "dag_round", "slot_union", "orset_capture", "orset_replay",
           "orset_apply", "dirty_rows", "delta_select", "rga_apply",
           "rga_compact", "rga_order", "safekv_submit", "block_select",
           "state_transfer", "gc_frontier")

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, then the
    toolkit's usual place, then ``PATH``)."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the hand kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str):
    """Start one nvcc into a temporary file; returns (proc, tmp, out)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS) -> dict:
    """Build every stale kernel library in parallel. Returns
    ``{"seconds": wall time, "log": {name: compiler output}}``; raises
    if any build fails."""
    t0 = time.perf_counter()
    logs = {}
    with _LOCK:
        started = {name: _start(name) for name in names if _stale(name)}
        failed = []
        for name, (proc, tmp, out) in started.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[f] for f in failed))
    return {"seconds": time.perf_counter() - t0, "log": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
