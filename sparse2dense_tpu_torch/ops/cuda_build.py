"""Build of the port's native code: each ``csrc/*.cu`` source becomes one
shared library with a plain C interface, compiled by ``nvcc`` for ``sm_90a``
into ``_build/`` (git-ignored) at first use and rebuilt when the source, or
a header of ``csrc/`` it may include, is newer; ``csrc/voxelizer.cpp`` (the
input pipeline's voxelizer) the same way by the host C++ compiler
(:func:`build_host`). The libraries are loaded with ctypes by their
wrappers."""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Dict, Sequence, Tuple

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def _stale(source: str, library: str) -> bool:
    if not os.path.exists(library):
        return True
    newest = max(os.path.getmtime(f) for f in [source] + glob.glob(os.path.join(CSRC, "*.cuh")))
    return os.path.getmtime(library) < newest


def build_all(pairs: Sequence[Tuple[str, str]]) -> Dict[str, str]:
    """Compile every stale (source, library) pair, one nvcc process each, all
    started together. Returns ptxas's register and shared-memory report per
    library built (nothing for one that was up to date)."""
    jobs = []
    for source, library in pairs:
        if not _stale(source, library):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{library}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC, "-o", tmp, source]
        jobs.append((library, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
    logs, errors = {}, []
    for library, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {library} ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, library)
        logs[library] = err
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def build(source: str, library: str) -> str:
    """Compile one library if it is missing or older than its source."""
    return build_all([(source, library)]).get(library, "")


def build_host(source: str, library: str) -> None:
    """Compile a host C++ source into a shared library if it is missing or
    older than its source. Processes that build at once (input workers) each
    write a file of their own and rename it into place."""
    if not _stale(source, library):
        return
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler (c++ or g++) to build {source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {library} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, library)


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's C interface takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
