"""Processes for a data-parallel run on one host, and the runs that hold
W processes against one.

- :func:`spawn` starts ``fn(*args)`` in n spawned processes with torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), waits for them under a time limit, and raises if one
  raised or the limit passed (the others are stopped);
- :func:`cli_worker` runs ``tools/train.py`` or ``tools/test.py`` with
  ``--launcher pytorch`` in such a process and saves what it returned;
- :func:`steps_worker` runs a job's training steps (the plain step or the
  teacher-student step) on this rank's slice of a batch, and
  :func:`one_process_steps` the same steps on the whole batch in the
  calling process: W ranks of B samples against one process of W*B.

The worker functions live in the package, so a spawned process imports
them from anywhere (not from a test module).
"""
from __future__ import annotations

import importlib
import os
import pickle
import time
from typing import Callable, Optional, Sequence

import torch

from . import dist


def _entry(index: int, fn: Callable, nprocs: int, port: int, threads: Optional[int],
           args: tuple) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(index),
                      LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    fn(*args)


def spawn(fn: Callable, nprocs: int, args: tuple = (), threads: Optional[int] = None,
          timeout: float = 600.0) -> None:
    """``fn(*args)`` in ``nprocs`` spawned processes, rank r with torchrun's
    variables for rank r of ``nprocs`` on localhost (a free port;
    ``LOCAL_WORLD_SIZE`` too), torch on
    ``threads`` intra-op threads if given. Returns when all have exited;
    raises the first one's error (``torch.multiprocessing``'s
    ``ProcessRaisedException``) or ``TimeoutError`` after ``timeout`` s,
    stopping the others either way."""
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, nprocs, dist.free_port(), threads, args), nprocs=nprocs,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} processes did not finish in {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)


def cli_worker(tool: str, argv: Sequence[str], out_dir: str) -> None:
    """``tools/<tool>.py``'s ``main(argv)`` in this rank, then
    ``<out_dir>/<tool>_rank<r>.pkl``: for "train" the model's state (on the
    CPU), the steps taken, the logged metrics and :func:`dist.max_param_gap`
    over the ranks; for "test" the detections and the evaluation's result
    (None on ranks other than 0); and the B1 launches of the run."""
    from ..ops import window_kernel as WK

    ret = importlib.import_module(f"sparse2dense_tpu_torch.tools.{tool}").main(list(argv))
    if tool == "train":
        out = dict(state={k: v.detach().cpu() for k, v in ret.model.state_dict().items()},
                   global_iter=ret.global_iter, log=dict(ret.log_buffer.val_history),
                   param_gap=dist.max_param_gap(ret.model.parameters()))
    else:
        out = dict(detections=ret[0], result=ret[1])
    out["window_pass_launches"] = WK.launches
    with open(os.path.join(out_dir, f"{tool}_rank{dist.rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.close_distributed()


def slice_batch(batch: dict, start: int, stop: int) -> dict:
    """Samples ``start:stop`` of a batch (its tensors and per-task lists of
    tensors; "metadata" too)."""
    return {k: [x[start:stop] for x in v] if isinstance(v, list) and k != "metadata"
            else v[start:stop] for k, v in batch.items()}


TOTAL_STEPS = 10   # the one-cycle schedule's length in a job


def build_job(job: dict, device):
    """(student, step) of a job: ``job["config"]`` with
    ``job["backbone"]`` overrides on teacher and student, seeded weights
    (teacher 0, student 1, as ``tools/profile_train_step.py``; then
    ``job["state"]``'s, if given), in ``job["dtype"]`` (float64 holds W
    ranks to one process beyond float32's rounding; float32 by default),
    ``OneCycleAdam`` over ``TOTAL_STEPS``; the step is the teacher-student
    step (``job["kind"] == "ts"``) or the plain one. ``job["tf32"]`` False
    turns TF32 off in cuDNN and matmuls (in this process)."""
    from ..models import build_detector
    from ..solver.optim import OneCycleAdam
    from ..training.train_state import make_train_step
    from ..training.trainer import TS_Trainer
    from ..utils.config import ConfigDict

    if job.get("tf32") is False:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ConfigDict.fromfile(job["config"])
    keys = ("model", "S_model") if job["kind"] == "ts" else ("S_model",)
    for key in keys:
        cfg[key]["backbone"].update(job.get("backbone") or {})
    kw = dict(test_cfg=cfg.test_cfg, voxel_generator=cfg.get("voxel_generator"), device=device)
    student = build_detector(cfg.S_model, generator=torch.Generator().manual_seed(1), **kw)
    dtype = getattr(torch, job.get("dtype", "float32"))
    state = job.get("state") or {}
    if "student" in state:
        student.load_state_dict(state["student"])
    student.to(dtype)
    optimizer = OneCycleAdam(student.parameters(), cfg.optimizer, cfg.lr_config,
                             TOTAL_STEPS, cfg.optimizer_config.get("grad_clip"))
    if job["kind"] != "ts":
        return student, make_train_step(student, optimizer)
    teacher = build_detector(cfg.model, generator=torch.Generator().manual_seed(0), **kw)
    if "teacher" in state:
        teacher.load_state_dict(state["teacher"])
    teacher.to(dtype)
    return student, TS_Trainer(teacher, student, optimizer, cfg.model).step


def run_steps(student, step: Callable, batch: dict, steps: int,
              after: Optional[Callable] = None) -> dict:
    """``steps`` calls of ``step(batch, mark)``: each step's metrics (floats),
    host ms, stage ms (the device synchronised at each mark), peak GiB on
    CUDA, B1 launches, and the student's gradients and state (parameters,
    BatchNorm running statistics) after it (on the CPU); ``after()`` after
    each step, outside its time."""
    from ..ops import window_kernel as WK

    cuda = next(student.parameters()).is_cuda
    rows = []
    for _ in range(steps):
        stages, clock = {}, [0.0]

        def mark(name):
            if cuda:
                torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = (now - clock[0]) * 1e3
            clock[0] = now

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        launches = WK.launches
        t0 = clock[0] = time.perf_counter()
        metrics = step(batch, mark)
        if cuda:
            torch.cuda.synchronize()
        rows.append(dict(
            metrics={k: float(v) for k, v in metrics.items() if v.dim() == 0},
            step_ms=(time.perf_counter() - t0) * 1e3, stages=stages,
            window_pass_launches=WK.launches - launches,
            peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
            grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                   for n, p in student.named_parameters()},
            model={k: v.detach().cpu().clone() for k, v in student.state_dict().items()}))
        if after is not None:
            after()
    return dict(rows=rows)


def steps_worker(job_paths: Sequence[str], out_dir: str) -> None:
    """The steps of the jobs saved at ``job_paths``, in turn, in this rank
    (one process group; the jobs' devices alike): rank r of W takes samples
    ``r*B:(r+1)*B`` of ``job["batch"]`` (B = ``job["per_rank"]``), on
    ``job["device"]``; after each step the largest gap between its
    parameters and rank 0's. Job i writes ``<out_dir>/steps_rank<r>_<i>.pt``."""
    jobs = [torch.load(p, weights_only=False) for p in job_paths]
    rank, world = dist.init_distributed("pytorch", jobs[0]["device"])
    device = dist.rank_device(jobs[0]["device"])
    for i, job in enumerate(jobs):
        student, step = build_job(job, device)
        b = job["per_rank"]
        batch = _to(slice_batch(job["batch"], rank * b, (rank + 1) * b), device, job)
        gaps = []
        out = run_steps(student, step, batch, job["steps"],
                        after=lambda: gaps.append(dist.max_param_gap(student.parameters())))
        out.update(param_gaps=gaps, world=world, rank=rank)
        torch.save(out, os.path.join(out_dir, f"steps_rank{rank}_{i}.pt"))
    dist.close_distributed()


def one_process_steps(job: dict, device) -> dict:
    """The job's steps on the whole of ``job["batch"]`` in this process (no
    process group): the run W ranks are held against."""
    student, step = build_job(job, device)
    return run_steps(student, step, _to(job["batch"], device, job), job["steps"])


def _to(batch: dict, device, job: dict) -> dict:
    """The batch on ``device``, its floating tensors in the job's dtype."""
    dtype = getattr(torch, job.get("dtype", "float32"))

    def put(x):
        return x.to(device, dtype) if x.is_floating_point() else x.to(device)

    return {k: v if k == "metadata" else [put(x) for x in v] if isinstance(v, list)
            else put(v) for k, v in batch.items()}
