"""Data parallelism over processes (counterpart of
``sparse2dense_tpu/parallel/mesh.py``; the reference's NCCL DDP with apex
SyncBN, torchie/apis/train.py:281,296-303).

The JAX package jits its step over global arrays, so every sum over the
batch is global: BatchNorm's statistics, every loss normaliser, the
gradients. Here each of W processes holds its own B samples and makes those
sums global itself, so that W processes behave as one process holding the
W*B samples:

- :func:`all_reduce_sum` sums a tensor over the processes and carries its
  gradient (the backward of a sum is the sum of the gradients): BatchNorm's
  statistics (``models/norm.py``);
- :func:`global_sum` sums a tensor that carries no gradient: a loss's
  normaliser, a count;
- :func:`reduce_gradients` sums the parameters' gradients after the
  backward (each rank's loss is its share of the global loss), so every
  rank clips and steps on the same numbers and the parameters stay equal to
  the bit; :func:`reduce_metrics` sums the logged losses and counters.

With no process group (``launcher="none"``) each of these is the identity
and no collective runs. Every rank must make the same collectives in the
same order, so a rank whose share of a sum is empty still takes part.
Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo stages
CUDA tensors through the host for those, which lets two ranks share one
card (NCCL refuses that).
"""
from __future__ import annotations

import os
import socket
from typing import Dict, Iterable

import torch
import torch.distributed as td

from ..device import resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    return td.is_available() and td.is_initialized()


def world_size() -> int:
    return td.get_world_size() if is_distributed() else 1


def rank() -> int:
    return td.get_rank() if is_distributed() else 0


def is_main() -> bool:
    """True on rank 0 (and in a single process): the rank that logs and
    writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world_size() > 1:
        td.barrier()


def _launch_device(device=None) -> torch.device:
    """``device`` if it names one, else ``cuda:LOCAL_RANK`` (ranks past the
    visible cards share them, round-robin)."""
    if device is not None and str(device) != "cuda":
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())


def _backend(dev: torch.device, device) -> str:
    """gloo on the CPU and where ranks share a card; NCCL where each rank
    has a card of its own. Ranks share a card when they outnumber the
    visible cards or when the caller names one card for a group of more
    than one (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through the host for ``all_reduce`` and ``broadcast``). Every
    rank decides alike: the same command line and the same host."""
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    named = device is not None and str(device) != "cuda"
    shared = local > 1 and (named or local > torch.cuda.device_count())
    return "gloo" if shared else "nccl"


def rank_device(device=None) -> torch.device:
    """The device this process runs on: ``device`` if it names one (the
    CPU or a numbered card), else (None or "cuda") ``cuda:LOCAL_RANK`` in a
    torchrun process group, else CUDA. Never the CPU unless asked for."""
    return _launch_device(device) if is_distributed() else resolve_device(device)


def init_distributed(launcher: str = "none", device=None) -> tuple:
    """Start this process's part of a multi-process run and return
    ``(rank, world_size)``.

    ``"none"``: one process, no process group, no collective: ``(0, 1)``.
    ``"pytorch"``: torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a missing variable
    raises and names it. The process runs on ``device``, else
    ``cuda:LOCAL_RANK`` (:func:`rank_device` says which after); the group's
    backend follows from the devices (:func:`_backend`). A group that does
    not start raises: there is no quiet single-process run."""
    if launcher == "none":
        return 0, 1
    if launcher != "pytorch":
        raise ValueError(f"--launcher {launcher!r}: 'none' or 'pytorch'")
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--launcher pytorch needs torchrun's environment; {', '.join(missing)} not set "
            "(run under torchrun, or use --launcher none)")
    dev = _launch_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _backend(dev, device)
    try:
        td.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                              world_size=int(os.environ["WORLD_SIZE"]))
    except Exception as e:
        raise RuntimeError(f"the {backend} process group did not start: {e}") from e
    return td.get_rank(), td.get_world_size()


def close_distributed() -> None:
    """End this process's part of the process group, if it has one."""
    if is_distributed():
        td.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        td.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        td.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable: its gradient is
    the sum of the processes' gradients of the result. One collective in the
    forward, one in the backward."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (no gradient) over the processes."""
    if world_size() == 1:
        return x
    y = x.detach().clone()
    td.all_reduce(y)
    return y


@torch.no_grad()
def global_sums(*xs: torch.Tensor) -> tuple:
    """Each of the 0-dim tensors ``xs`` (of one dtype) summed over the
    processes, in one collective."""
    if world_size() == 1:
        return xs
    flat = torch.stack([x.detach() for x in xs])
    td.all_reduce(flat)
    return tuple(flat.unbind())


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the processes, in one
    collective a dtype. A parameter without a gradient takes part with
    zeros (and keeps the sum), as a zero leaf of the reference's gradient
    tree does."""
    if world_size() == 1:
        return
    params = [p for p in params if p.requires_grad]
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        td.all_reduce(flat)
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


GLOBAL_METRICS = ("grad_norm",)   # already the same on every rank


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's 0-dim metrics summed over the processes (each rank's loss is
    its share of the global loss; counters add), in one collective; the
    gradient norm, computed on the reduced gradients, as it is."""
    if world_size() == 1:
        return metrics
    keys = [k for k, v in metrics.items() if k not in GLOBAL_METRICS and v.dim() == 0]
    if not keys:
        return metrics
    dtype = torch.float32
    for k in keys:
        dtype = torch.promote_types(dtype, metrics[k].dtype)
    flat = torch.stack([metrics[k].to(dtype) for k in keys])
    td.all_reduce(flat)
    out = dict(metrics)
    out.update({k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)})
    return out


@torch.no_grad()
def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank (in one collective a
    dtype), as DDP does when it wraps a model."""
    if world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        td.broadcast(flat, 0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def max_param_gap(params: Iterable[torch.Tensor]) -> float:
    """The largest |difference| between this rank's ``params`` and rank
    0's (rank 0's broadcast), the most over the ranks: 0.0 when the ranks
    hold equal parameters."""
    flat = torch.cat([p.detach().reshape(-1).float() for p in params])
    if world_size() == 1:
        return 0.0
    ref = flat.clone()
    td.broadcast(ref, 0)
    gap = (flat - ref).abs().max().reshape(1)
    td.all_reduce(gap, op=td.ReduceOp.MAX)
    return float(gap)


def free_port() -> int:
    """A free TCP port on localhost, for ``MASTER_PORT``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
