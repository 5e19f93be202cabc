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
import torch.nn.functional as F

from . import cuda_build
from .window_conv import ConvPlan, reader_table, window_pass_grad, window_pass_plain

SOURCE = os.path.join(cuda_build.CSRC, "window_pass.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libwindow_pass.so")
BLOCK = 128
# (cin_pad, Cout) pairs the kernel is instantiated for (Cin <= 16 pads to 16):
# with all 27 taps' weights resident in shared memory, and with the taps
# streamed through a ring of RING slots (the resident layout would not fit)
RESIDENT = ((16, 16), (16, 32), (32, 16), (32, 32), (32, 64))
STREAMED = ((64, 64), (64, 128), (128, 128))
WIDTHS = RESIDENT + STREAMED
RING = 2
SMEM_LIMIT = 232448        # dynamic shared memory a Hopper block may use
TABLE_RESERVE = 4096       # kept for a block's table of a byte a plan block it takes

launches = 0               # kernel launches since the caller last reset it
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns ptxas's register and shared-memory report (empty if up to date)."""
    return cuda_build.build(SOURCE, LIBRARY)


def load(library: str) -> ctypes.CDLL:
    """A built kernel library, with the C interface's types declared."""
    lib = ctypes.CDLL(library)
    lib.s2d_window_pass.restype = ctypes.c_int
    lib.s2d_window_pass.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        _lib = load(LIBRARY)
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


def cin_pad(cin: int) -> int:
    """Input width the kernel's tensor cores see: 16 for Cin <= 16, else Cin."""
    return max(16, cin)


def window_weights(w: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) weights -> the kernel's layout (27, Cout, cin_pad + 8):
    per tap and output channel a row of the input channels (the K-contiguous
    B rows of ``ldmatrix``), zero past Cin; the 8 extra values a row spread
    the rows over the shared-memory banks. At the streamed widths each tap's
    (Cout, cin_pad + 8) slice is the unit one bulk copy brings."""
    cin = w.shape[1]
    return F.pad(w.transpose(1, 2), (0, cin_pad(cin) + 8 - cin)).contiguous()


def streamed(cin: int, cout: int) -> bool:
    """Whether the kernel streams the taps' weights at these widths."""
    return (cin_pad(cin), cout) in STREAMED


def weight_bytes(cin: int, cout: int) -> int:
    """Shared memory of a block's weights: all 27 taps, or the ring of RING
    taps and a zero row of cin_pad values (the streamed widths)."""
    tap = cout * (cin_pad(cin) + 8) * 2
    return RING * tap + 2 * cin_pad(cin) if streamed(cin, cout) else 27 * tap


def smem_bytes(cin: int, cout: int, window: int, buffers: int = 2) -> int:
    """Dynamic shared memory of a kernel block, without its table of a byte
    a plan block: head (barriers, offsets, zero row, hit table), weights,
    and ``buffers`` window buffers (keys, the block's kbase rows, features)."""
    head = 256 + BLOCK * 9 * 4
    return head + weight_bytes(cin, cout) + buffers * (window * (4 + 2 * cin) + BLOCK * 12)


def window_buffers(cin: int, cout: int, window: int) -> int:
    """The window buffers a block takes: 2 (the next unit's window lands
    while this one is contracted) where they fit, else 1 (the streamed
    widths only: a unit's window is fetched when it starts)."""
    if not streamed(cin, cout) or smem_bytes(cin, cout, window, 2) + TABLE_RESERVE <= SMEM_LIMIT:
        return 2
    return 1


def unsupported(block: int, cin: int, cout: int, window: int) -> Optional[str]:
    """Why the kernel does not take a plan of this block and window at these
    widths, or None if it does."""
    if block != BLOCK:
        return f"plan block {block} (the kernel takes {BLOCK})"
    if (cin_pad(cin), cout) not in WIDTHS:
        return (f"Cin {cin} -> Cout {cout} (the kernel is built for Cin <= 16 or 32 -> "
                f"Cout 16 or 32, Cin 32 -> Cout 64, Cin 64 -> Cout 64 or 128, and "
                f"Cin 128 -> Cout 128)")
    buffers = window_buffers(cin, cout, window)
    if window % 128 or smem_bytes(cin, cout, window, buffers) + TABLE_RESERVE > SMEM_LIMIT:
        return f"window {window} x Cin {cin} (a multiple of 128 within shared memory)"
    return None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts on a 16-byte boundary (the kernel's
    bulk copies read whole windows of it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    why = unsupported(plan.block, cin, cout, window)
    if why:
        raise ValueError(f"not supported by the window-pass kernel: {why}")
    if window > v_in:
        raise ValueError(f"the kernel needs a window of at most V_in={v_in}, got {window}")
    feat = _aligned(features.to(torch.bfloat16).contiguous())
    w = window_weights(weights.to(torch.bfloat16))
    lin, kbase = _aligned(plan.lin), _aligned(plan.kbase)
    cuda_build.check_tensor("plan.lin", lin, torch.int32, (v_in,), dev)
    cuda_build.check_tensor("plan.kbase", kbase, torch.int32, (nb * BLOCK, 3), dev)
    cuda_build.check_tensor("plan.ws", plan.ws, torch.int32, (nb, 3), dev)
    cuda_build.check_tensor("plan.offsets", plan.offsets, torch.int32, (3, 9), dev)
    cuda_build.check_tensor("weights", w, torch.bfloat16, (27, cout, cin_pad(cin) + 8), dev)
    out = torch.empty((nb * BLOCK, cout), dtype=torch.float32, device=dev)
    dy_mask, j_mask = live_taps(ksize)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s2d_window_pass(
            feat.data_ptr(), lin.data_ptr(), kbase.data_ptr(),
            plan.ws.data_ptr(), plan.offsets.data_ptr(), w.data_ptr(), out.data_ptr(),
            v_in, nb, cin, cout, window, dy_mask, j_mask, window_buffers(cin, cout, window),
            stream)
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


class WindowPass(torch.autograd.Function):
    """:func:`window_pass` under autograd: ``apply(features (V_in, Cin),
    weights (27, Cin, Cout) dyx taps, plan, ksize)`` -> (V_out, Cout)
    float32. The forward keeps no one-hot or gathered rows; the backward is
    the float32 VJP of the plain formula through the plan's reader table
    (``plan.readers``, built here if the plan has none), whichever forward
    ran, as the reference's custom VJP recomputes its reference formula. No
    TPU kernel has a backward: the reference's is XLA too."""

    @staticmethod
    def forward(ctx, features, weights, plan: ConvPlan, ksize):
        ctx.save_for_backward(features, weights)
        ctx.plan = plan
        return window_pass(features, plan, weights, ksize)

    @staticmethod
    def backward(ctx, grad):
        features, weights = ctx.saved_tensors
        plan = ctx.plan
        readers = plan.readers if plan.readers is not None else reader_table(plan)
        dx, dw = window_pass_grad(features, weights, readers, grad,
                                  need_features=ctx.needs_input_grad[0])
        return dx, dw, None, None
