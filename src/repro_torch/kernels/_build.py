"""Build and load the hand-written CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(it may include ``.cuh`` headers beside it), compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``src/repro_torch/build/``
(listed in ``.gitignore``) at first use, and loaded with ``ctypes``.
Nothing is built at import time: the CPU tests import every module on a
machine without ``nvcc``.  ``build_all`` starts one ``nvcc`` per source,
all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "build"
SOURCES = {
    "remap_gather": _PKG / "kernels/remap_gather/csrc/remap_gather.cu",
    "paged_attention_fused":
        _PKG / "kernels/paged_attention/csrc/paged_attention_fused.cu",
    "irt_lookup": _PKG / "kernels/irt_lookup/csrc/irt_lookup.cu",
    "paged_attention":
        _PKG / "kernels/paged_attention/csrc/paged_attention.cu",
    "flash_attention":
        _PKG / "kernels/flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd":
        _PKG / "kernels/flash_attention/csrc/flash_attention_bwd.cu",
    "sim_scan": _PKG / "kernels/sim_scan/csrc/sim_scan.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or a header beside it."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    src = SOURCES[name]
    newest = max(p.stat().st_mtime
                 for p in [src, *src.parent.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all(names=None) -> float:
    """Build every stale kernel library, one ``nvcc`` per source started
    together; returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in (names or SOURCES):
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        log = BUILD_DIR / f"{name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, log))
    for name, proc, tmp, log in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit "
                               f"{proc.returncode}):\n{log.read_text()}")
        os.replace(tmp, _lib_path(name))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str, bind):
    """The kernel library ``name``, built first if missing or older than
    its source, passed once through ``bind`` (which declares the C
    signatures and returns what the wrapper calls); cached per name."""
    if name not in _loaded:
        if _stale(name):
            build_all([name])
        _loaded[name] = bind(ctypes.CDLL(str(_lib_path(name))))
    return _loaded[name]


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
