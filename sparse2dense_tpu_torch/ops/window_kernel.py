"""Wrapper of the window-pass CUDA kernel (``csrc/window_pass.cu``).

The kernel replaces the TPU kernel ``window_pass_pallas``
(``sparse2dense_tpu/ops/pallas/window_kernel.py``). It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use (``ops/cuda_build.py``: into ``_build/``, which git ignores) and
called through ctypes on PyTorch's current stream.

:func:`window_pass` takes the plain version (``window_conv.window_pass_plain``)
for a tensor on the CPU, and launches the kernel for a CUDA tensor or raises:
there is no fallback. ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import cuda_build
from .window_conv import ConvPlan, window_pass_plain

SOURCE = os.path.join(cuda_build.CSRC, "window_pass.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libwindow_pass.so")
BLOCK = 128
COUTS = (16, 32)           # output widths the kernel is instantiated for
SMEM_LIMIT = 232448        # dynamic shared memory a Hopper block may use

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
        lib.s2d_window_pass.restype = ctypes.c_int
        lib.s2d_window_pass.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        _lib = lib
    return _lib


def live_taps(ksize: Tuple[int, int, int]) -> Tuple[int, int]:
    """Bit masks of the live dy groups and of the live (dx, dz) taps j inside
    a group (j = dxi * 3 + dzi) of a (kz, ky, kx) kernel."""
    kz, ky, kx = ksize
    dys = (0, 1, 2) if ky == 3 else (1,)
    dxs = (0, 1, 2) if kx == 3 else (1,)
    dzs = (0, 1, 2) if kz == 3 else (1,)
    dy_mask = sum(1 << d for d in dys)
    j_mask = sum(1 << (dxi * 3 + dzi) for dxi in dxs for dzi in dzs)
    return dy_mask, j_mask


def window_pass_cuda(features: torch.Tensor, plan: ConvPlan, weights: torch.Tensor,
                     ksize: Tuple[int, int, int] = (3, 3, 3)) -> torch.Tensor:
    """Launch the kernel: features (V_in, Cin) and weights (27, Cin, Cout) are
    cast to bf16; returns (V_out, Cout) float32."""
    global launches
    dev = features.device
    if dev.type != "cuda":
        raise ValueError(f"window_pass_cuda needs CUDA tensors, got {dev}")
    if features.dim() != 2 or weights.dim() != 3 or weights.shape[:2] != (27, features.shape[1]):
        raise ValueError(f"features (V, Cin) and weights (27, Cin, Cout) expected, "
                         f"got {tuple(features.shape)} and {tuple(weights.shape)}")
    v_in, cin = features.shape
    cout = weights.shape[2]
    nb, window = plan.ws.shape[0], plan.window
    if plan.block != BLOCK:
        raise ValueError(f"the kernel needs plan block {BLOCK}, got {plan.block}")
    if window % 128 or window > v_in:
        raise ValueError(f"the kernel needs a window that is a multiple of 128 and "
                         f"at most V_in={v_in}, got {window}")
    if cout not in COUTS:
        raise ValueError(f"the kernel is built for Cout in {COUTS}, got {cout}")
    smem = window * 4 + window * cin * 2 + 9 * cin * cout * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"window {window} x Cin {cin} needs {smem} B of shared memory")
    feat = features.to(torch.bfloat16).contiguous()
    w = weights.to(torch.bfloat16).contiguous()
    cuda_build.check_tensor("plan.lin", plan.lin, torch.int32, (v_in,), dev)
    cuda_build.check_tensor("plan.kbase", plan.kbase, torch.int32, (nb * BLOCK, 3), dev)
    cuda_build.check_tensor("plan.ws", plan.ws, torch.int32, (nb, 3), dev)
    cuda_build.check_tensor("plan.offsets", plan.offsets, torch.int32, (3, 9), dev)
    cuda_build.check_tensor("weights", w, torch.bfloat16, (27, cin, cout), dev)
    out = torch.empty((nb * BLOCK, cout), dtype=torch.float32, device=dev)
    dy_mask, j_mask = live_taps(ksize)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2d_window_pass(
            feat.data_ptr(), plan.lin.data_ptr(), plan.kbase.data_ptr(),
            plan.ws.data_ptr(), plan.offsets.data_ptr(), w.data_ptr(), out.data_ptr(),
            v_in, nb, cin, cout, window, dy_mask, j_mask, stream)
    if err != 0:
        raise RuntimeError(f"window-pass kernel launch failed: CUDA error {err}")
    launches += 1
    return out[:plan.out_lin.shape[0]]


def window_pass(features: torch.Tensor, plan: ConvPlan, weights: torch.Tensor,
                ksize: Tuple[int, int, int] = (3, 3, 3)) -> torch.Tensor:
    """The window pass of :func:`window_conv.window_conv`: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if features.device.type == "cpu":
        return window_pass_plain(features, plan, weights)
    return window_pass_cuda(features, plan, weights, ksize)
