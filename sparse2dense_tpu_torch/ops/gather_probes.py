"""Gather probes: the plain versions and the CUDA wrappers of three kernels
(``csrc/gather_probes.cu``) that measure the card's gather mechanisms, as
the TPU probes of ``sparse2dense_tpu/tools/microbench.py`` measure the TPU's.
feat is (V, C) float32 with C a multiple of 4; indices are int32.

- :func:`take` (B4a, ``bench_pallas_take``): ``out[i] = feat[idx[i]]``;
- :func:`window_take` (B4b, ``bench_pallas_onehot``): for output block b of
  ``blk`` rows, ``out[b*blk + r] = feat[s_b + local[b*blk + r]]`` with the
  window start clamped at the tail, ``s_b = min(b*blk, V - w)``, and
  ``local`` in [0, w). (The reference's own check wraps the window modulo V
  and so compares only rows ``[:V - w]``; these versions follow the kernel on
  every row.) The kernel bulk-copies each block's indices, so on the card
  ``blk`` must be a multiple of 4 and ``local`` 16-byte aligned (a fresh
  tensor is); the plain version takes any ``blk``. Loading the indices
  with ordinary loads instead, which takes any, was 5-10% slower warm.
- :func:`run_gather` (B4c, ``bench_pallas_dma``): R = ``run_len`` rows per
  copy, ``out[i*R:(i+1)*R] = feat[idx[i]:idx[i] + R]``, with every
  ``idx[i]`` a multiple of R and ``idx[i] + R <= V``, as the TPU kernel
  assumes.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/cuda_build.py``) and called through ctypes on PyTorch's current
stream. Each dispatching function takes the plain version for CPU tensors
and launches the kernel for CUDA tensors or raises: there is no fallback.
``launches`` counts each kernel's launches; :func:`empty` launches an empty
kernel, the fixed cost of one timed call, which no path runs and no count
counts. The plain versions refuse an index out of range: on the CPU with a
ValueError, on the card with an asynchronous device assert (no host sync);
the kernels stop with a trap.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch

from . import cuda_build

SOURCE = os.path.join(cuda_build.CSRC, "gather_probes.cu")
LIBRARY = os.path.join(cuda_build.BUILD_DIR, "libgather_probes.so")
LANES = 32                 # run_gather: issuing lanes a block, one slot each
BARRIER_BYTES = 256        # run_gather: a block's mbarriers
SMEM_LIMIT = 232448        # dynamic shared memory a Hopper block may use

# kernel launches since the caller last reset them
launches: Dict[str, int] = {"take": 0, "window_take": 0, "run_gather": 0}
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns ptxas's register and shared-memory report (empty if up to date)."""
    return cuda_build.build(SOURCE, LIBRARY)


def load(library: str) -> ctypes.CDLL:
    """A built kernel library, with the C interface's types declared."""
    lib = ctypes.CDLL(library)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.s2d_take.argtypes = [p, p, p, i, i, i, p]
    lib.s2d_window_take.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.s2d_run_gather.argtypes = [p, p, p, i, i, i, i, p]
    lib.s2d_empty.argtypes = [p]
    for fn in (lib.s2d_take, lib.s2d_window_take, lib.s2d_run_gather, lib.s2d_empty):
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        _lib = load(LIBRARY)
    return _lib


def _require(ok: torch.Tensor, msg: str) -> None:
    """Refuse what the kernels do not take: a ValueError on the CPU, an
    asynchronous device assert on the card (no host sync)."""
    if ok.device.type == "cpu":
        if not bool(ok):
            raise ValueError(msg)
    else:
        torch._assert_async(ok)


def _check_table(feat: torch.Tensor) -> None:
    if feat.dim() != 2 or feat.shape[1] % 4:
        raise ValueError(f"feat must be (V, C) with C a multiple of 4, got {tuple(feat.shape)}")


def _check_window(v: int, n: int, blk: int, w: int) -> None:
    if n % blk or not 0 < w <= v:
        raise ValueError(f"need rows ({n}) a multiple of blk ({blk}) and 0 < w ({w}) <= V ({v})")


def window_starts(v: int, n: int, blk: int, w: int, device=None) -> torch.Tensor:
    """First table row of each output block's window, as the window-take
    kernel computes it: ``min(b*blk, v - w)`` (clamped at the tail)."""
    _check_window(v, n, blk, w)
    return (torch.arange(n // blk, device=device) * blk).clamp(max=v - w)


def window_index(v: int, local: torch.Tensor, blk: int, w: int) -> torch.Tensor:
    """Absolute row of every output row of :func:`window_take`:
    ``min(b*blk, v - w) + local[b*blk + r]``."""
    start = window_starts(v, local.shape[0], blk, w, local.device)
    return (start[:, None] + local.view(-1, blk).long()).reshape(-1)


def take_plain(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N,) indices into feat (V, C) -> (N, C)."""
    _check_table(feat)
    _require(((idx >= 0) & (idx < feat.shape[0])).all(), "take: index out of [0, V)")
    return feat[idx.long()]


def window_take_plain(feat: torch.Tensor, local: torch.Tensor, blk: int, w: int) -> torch.Tensor:
    """(N,) window-local indices, N a multiple of blk -> (N, C)."""
    _check_table(feat)
    _require(((local >= 0) & (local < w)).all(), f"window_take: local index out of [0, {w})")
    return feat[window_index(feat.shape[0], local, blk, w)]


def run_gather_plain(feat: torch.Tensor, idx: torch.Tensor, run_len: int) -> torch.Tensor:
    """(N,) run starts -> (N * run_len, C)."""
    _check_table(feat)
    _require(((idx >= 0) & (idx <= feat.shape[0] - run_len) & (idx % run_len == 0)).all(),
             f"run_gather: a run start is not a multiple of {run_len} in "
             f"[0, V - {run_len}]")
    rows = idx.long()[:, None] + torch.arange(run_len, device=idx.device)
    return feat[rows.reshape(-1)]


def _check_cuda_args(name: str, feat: torch.Tensor, idx: torch.Tensor):
    dev = feat.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    _check_table(feat)
    cuda_build.check_tensor("feat", feat, torch.float32, feat.shape, dev)
    cuda_build.check_tensor("indices", idx, torch.int32, (idx.shape[0],), dev)
    if feat.data_ptr() % 16:
        raise ValueError("feat must be 16-byte aligned (bulk copies and vector loads)")
    return dev


def _launch(name: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def take_cuda(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the take kernel (B4a): warps over batches of 32 rows, each
    gathered into shared memory and stored by one bulk copy; one wave of
    blocks."""
    dev = _check_cuda_args("take_cuda", feat, idx)
    v, c = feat.shape
    out = torch.empty((idx.shape[0], c), dtype=torch.float32, device=dev)
    _launch("take", _library().s2d_take, dev, feat.data_ptr(), idx.data_ptr(),
            out.data_ptr(), v, idx.shape[0], c)
    return out


def window_take_cuda(feat: torch.Tensor, local: torch.Tensor, blk: int, w: int) -> torch.Tensor:
    """Launch the window-take kernel (B4b): one block an output block, its
    window and its local indices bulk-copied into shared memory."""
    dev = _check_cuda_args("window_take_cuda", feat, local)
    v, c = feat.shape
    n = local.shape[0]
    _check_window(v, n, blk, w)
    if blk % 4 or local.data_ptr() % 16:
        raise ValueError(f"window_take: blk ({blk}) must be a multiple of 4 and local 16-byte "
                         f"aligned (bulk copies)")
    if w * c * 4 + blk * 4 > SMEM_LIMIT - 1024:
        raise ValueError(f"a window of {w} x {c} float32 and {blk} indices do not fit shared "
                         f"memory")
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    _launch("window_take", _library().s2d_window_take, dev, feat.data_ptr(), local.data_ptr(),
            out.data_ptr(), v, n, c, blk, w)
    return out


def run_gather_cuda(feat: torch.Tensor, idx: torch.Tensor, run_len: int) -> torch.Tensor:
    """Launch the run-gather kernel (B4c): one bulk copy per run, issued by
    every lane of one-warp blocks over every SM."""
    dev = _check_cuda_args("run_gather_cuda", feat, idx)
    v, c = feat.shape
    if run_len < 1 or run_len > v or LANES * run_len * c * 4 > SMEM_LIMIT - BARRIER_BYTES - 1024:
        raise ValueError(f"run_len {run_len}: {LANES} runs of {run_len} x {c} float32 must fit "
                         f"shared memory, and a run the table")
    out = torch.empty((idx.shape[0] * run_len, c), dtype=torch.float32, device=dev)
    _launch("run_gather", _library().s2d_run_gather, dev, feat.data_ptr(), idx.data_ptr(),
            out.data_ptr(), v, idx.shape[0], c, run_len)
    return out


def empty(like: torch.Tensor) -> None:
    """Launch the empty kernel on ``like``'s card (nothing on the CPU)."""
    if like.device.type == "cuda":
        with torch.cuda.device(like.device):
            err = _library().s2d_empty(torch.cuda.current_stream(like.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def take(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B4a: the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if feat.device.type == "cpu":
        return take_plain(feat, idx)
    return take_cuda(feat, idx)


def window_take(feat: torch.Tensor, local: torch.Tensor, blk: int, w: int) -> torch.Tensor:
    """B4b: the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if feat.device.type == "cpu":
        return window_take_plain(feat, local, blk, w)
    return window_take_cuda(feat, local, blk, w)


def run_gather(feat: torch.Tensor, idx: torch.Tensor, run_len: int) -> torch.Tensor:
    """B4c: the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if feat.device.type == "cpu":
        return run_gather_plain(feat, idx, run_len)
    return run_gather_cuda(feat, idx, run_len)
