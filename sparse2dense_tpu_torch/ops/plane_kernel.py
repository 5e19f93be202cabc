"""Wrapper of the active-plane subm conv CUDA kernel (``csrc/plane_subm.cu``).

The kernel replaces the TPU kernel ``plane_subm_pallas``
(``sparse2dense_tpu/ops/pallas/plane_block_kernel.py``). It is compiled with
``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``) and called
through ctypes on PyTorch's current stream.

:func:`plane_subm` takes the plain version (``plane_conv.plane_subm_plain``)
for tensors on the CPU, and launches the kernel for CUDA tensors or raises:
there is no fallback. ``launches`` counts the kernel launches.
:class:`PlaneConv` runs it under autograd in training.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import cuda_build
from .plane_conv import BLK, PKPlan, plane_conv_grad, plane_subm_plain

SOURCE = os.path.join(cuda_build.CSRC, "plane_subm.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libplane_subm.so")
CHANNELS = ((16, 16), (32, 32), (64, 64), (128, 128))  # (C, Co) built
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0               # kernel launches since the caller last reset it
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns ptxas's register and shared-memory report (empty if up to date)."""
    return cuda_build.build(SOURCE, LIBRARY)


def load(library: str) -> ctypes.CDLL:
    """A built kernel library, with the C interface's types declared."""
    lib = ctypes.CDLL(library)
    lib.s2d_plane_subm.restype = ctypes.c_int
    lib.s2d_plane_subm.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        _lib = load(LIBRARY)
    return _lib


def wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """(27, C, Co) weights -> the B operand layout of the bf16 kernel's
    ``wgmma`` (no swizzle, K-major): per tap, (C / 8, Co / 8) core matrices
    of 8 output x 8 input channels, 128 contiguous bytes each, in a tensor
    (27, C / 8, Co / 8, 8, 8). Weight (k, ci, co) lies at
    [k, ci // 8, co // 8, co % 8, ci % 8]."""
    k, c, co = w.shape
    return w.reshape(k, c // 8, 8, co // 8, 8).permute(0, 1, 3, 4, 2).contiguous()


def plane_subm_cuda(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
                    scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
                    residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """Launch the kernel. state (T1p, 16C) float32 or bfloat16; tgt
    (T1p // 128, 32, 128) int32; w (27, C, Co) z-major taps, cast to the
    state's dtype; scale16 / shift16 (1, 16Co) float32; mask16 and residual
    (T1p, 16Co) in the state's dtype. Returns (T1p, 16Co) in the state's
    dtype."""
    global launches
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"plane_subm_cuda needs CUDA tensors, got {dev}")
    if state.dim() != 2 or w.dim() != 3 or w.shape[:2] != (27, state.shape[1] // 16):
        raise ValueError(f"state (T1p, 16C) and w (27, C, Co) expected, got "
                         f"{tuple(state.shape)} and {tuple(w.shape)}")
    if state.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 state, got {state.dtype}")
    t1p, c16 = state.shape
    c, co = c16 // 16, w.shape[2]
    if (c, co) not in CHANNELS:
        raise ValueError(f"the kernel is built for (C, Co) in {CHANNELS}, got {(c, co)}")
    if t1p % BLK:
        raise ValueError(f"T1p must be a multiple of {BLK}, got {t1p}")
    dt = state.dtype
    # the bf16 (tensor-core) kernel reads the weights in wgmma's B layout
    wt = wgmma_weights(w.to(dt)) if dt == torch.bfloat16 else w.to(dt).contiguous()
    cuda_build.check_tensor("state", state, dt, (t1p, 16 * c), dev)
    cuda_build.check_tensor("tgt", tgt, torch.int32, (t1p // BLK, 32, BLK), dev)
    cuda_build.check_tensor("scale16", scale16, torch.float32, (1, 16 * co), dev)
    cuda_build.check_tensor("shift16", shift16, torch.float32, (1, 16 * co), dev)
    cuda_build.check_tensor("mask16", mask16, dt, (t1p, 16 * co), dev)
    if residual is not None:
        cuda_build.check_tensor("residual", residual, dt, (t1p, 16 * co), dev)
    out = torch.empty((t1p, 16 * co), dtype=dt, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2d_plane_subm(
            state.data_ptr(), tgt.data_ptr(), wt.data_ptr(), scale16.data_ptr(),
            shift16.data_ptr(), mask16.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            t1p, c, co, DTYPES[dt], int(relu), stream)
    if err != 0:
        raise RuntimeError(f"plane subm kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def plane_subm(state: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
               scale16: torch.Tensor, shift16: torch.Tensor, mask16: torch.Tensor,
               residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """The fused plane subm conv: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if state.device.type == "cpu":
        return plane_subm_plain(state, tgt, w, scale16, shift16, mask16, residual, relu)
    return plane_subm_cuda(state, tgt, w, scale16, shift16, mask16, residual, relu)


class PlaneConv(torch.autograd.Function):
    """The linear plane conv under autograd (the reference's ``_plane_core``
    custom VJP): ``apply(state (N, 16C), w (27, C, Co) z-major taps, mask16
    (N, 16Co), plan)`` -> mask16 * conv(state) in the state's dtype. The
    forward is :func:`plane_subm` with an identity epilogue (scale 1, shift
    0, no residual, no ReLU): the kernel on CUDA tensors. The backward is
    the float32 VJP of the plain formula over ``plan.nbr``
    (``plane_conv.plane_conv_grad``), whichever forward ran, as the
    reference's recomputes its reference formula: gradients to the state
    and the taps, none to the mask or the plan. No TPU kernel has a
    backward."""

    @staticmethod
    def forward(ctx, state, w, mask16, plan: PKPlan):
        if plan.nbr is None:
            raise ValueError("PlaneConv needs the plan's neighbour table "
                             "(plan._replace(nbr=plane_conv.flat_neighbor_ranks(...)))")
        ctx.save_for_backward(state, w, mask16)
        ctx.nbr = plan.nbr
        ones = torch.ones((1, 16 * w.shape[2]), dtype=torch.float32, device=state.device)
        return plane_subm(state, plan.tgt, w, ones, torch.zeros_like(ones), mask16,
                          residual=None, relu=False)

    @staticmethod
    def backward(ctx, grad):
        state, w, mask16 = ctx.saved_tensors
        ds, dw = plane_conv_grad(state, w, ctx.nbr, grad.float() * mask16.float(),
                                 need_state=ctx.needs_input_grad[0])
        return ds, dw, None, None
