"""Wrapper of the fused tile subm conv CUDA kernel (``csrc/tile_subm.cu``).

The kernel replaces the TPU kernel ``tile_subm_pallas``
(``sparse2dense_tpu/ops/pallas/tile_block_kernel.py``). It is compiled with
``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``) and called
through ctypes on PyTorch's current stream.

:func:`tile_subm` takes the plain version (``tile_kernel.tile_subm_plain``)
for tensors on the CPU, and launches the kernel for CUDA tensors or raises:
there is no fallback. ``launches`` counts the kernel launches (each one a
compaction pass over the mask and the conv, two CUDA kernels in a row).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import cuda_build
from .tile_kernel import BLK, tile_subm_plain

SOURCE = os.path.join(cuda_build.CSRC, "tile_subm.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libtile_subm.so")
CHANNELS = ((16, 16), (32, 32), (64, 64), (128, 128))  # (C, Co) built
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0               # kernel launches since the caller last reset it
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns ptxas's register and shared-memory report (empty if up to date)."""
    return cuda_build.build(SOURCE, LIBRARY)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.s2d_tile_subm.restype = ctypes.c_int
        lib.s2d_tile_subm.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        _lib = lib
    return _lib


def tile_subm_cuda(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                   scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
                   residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """Launch the kernel. state (tz, T1p, 16C) float32 or bfloat16; tgt
    (T1p // 128, 32, 128) int32; w (27, C, Co) z-major taps, cast to the
    state's dtype; scale16 / shift16 (1, 16Co) float32; mask16 (a cell mask
    repeated over Co) and residual (tz, T1p, 16Co) in the state's dtype.
    Returns (tz, T1p, 16Co) in the state's dtype."""
    global launches
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"tile_subm_cuda needs CUDA tensors, got {dev}")
    if state.dim() != 3 or w.dim() != 3 or w.shape[:2] != (27, state.shape[2] // 16):
        raise ValueError(f"state (tz, T1p, 16C) and w (27, C, Co) expected, got "
                         f"{tuple(state.shape)} and {tuple(w.shape)}")
    if state.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 state, got {state.dtype}")
    tz, t1p, c16 = state.shape
    c, co = c16 // 16, w.shape[2]
    if (c, co) not in CHANNELS:
        raise ValueError(f"the kernel is built for (C, Co) in {CHANNELS}, got {(c, co)}")
    if t1p % BLK:
        raise ValueError(f"T1p must be a multiple of {BLK}, got {t1p}")
    dt = state.dtype
    # the bf16 (tensor-core) kernel reads the weights as (27, Co, C)
    wt = (w.to(dt).transpose(1, 2) if dt == torch.bfloat16 else w.to(dt)).contiguous()
    cuda_build.check_tensor("state", state, dt, (tz, t1p, 16 * c), dev)
    cuda_build.check_tensor("tgt", tgt, torch.int32, (t1p // BLK, 32, BLK), dev)
    cuda_build.check_tensor("scale16", scale16, torch.float32, (1, 16 * co), dev)
    cuda_build.check_tensor("shift16", shift16, torch.float32, (1, 16 * co), dev)
    cuda_build.check_tensor("mask16", mask16, dt, (tz, t1p, 16 * co), dev)
    if residual is not None:
        cuda_build.check_tensor("residual", residual, dt, (tz, t1p, 16 * co), dev)
    out = torch.empty((tz, t1p, 16 * co), dtype=dt, device=dev)
    live = torch.empty(tz * t1p + 1, dtype=torch.int32, device=dev)  # scratch: list, count
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2d_tile_subm(
            state.data_ptr(), tgt.data_ptr(), wt.data_ptr(), scale16.data_ptr(),
            shift16.data_ptr(), mask16.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            live.data_ptr(), live[-1:].data_ptr(), tz, t1p, c, co, DTYPES[dt], int(relu),
            stream)
    if err != 0:
        raise RuntimeError(f"tile subm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def tile_subm(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
              scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
              residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """The fused tile subm conv: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if state.device.type == "cpu":
        return tile_subm_plain(state, tgt, w, scale16, shift16, mask16, residual, relu)
    return tile_subm_cuda(state, tgt, w, scale16, shift16, mask16, residual, relu)
