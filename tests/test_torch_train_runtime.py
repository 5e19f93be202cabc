"""The training runtime: ``tools/train.py``, checkpoints, hooks and resume,
on ``distill_tiny`` (window engine, dense stages from conv2 in float32, a
text log line every step) on the CPU.

The CLI chain: a plain ``Trainer`` run trains the tiny teacher (its
``model`` as ``S_model``, distillation off) for one step and writes
``epoch_1``; the teacher-student config loads it through ``--load_from``
and trains 2 epochs x 2 steps; another run resumes from that run's
``epoch_1`` (``--resume_from``, as a job cut after its first epoch would)
and takes the second epoch. It must end bit-equal to the uninterrupted run:
parameters, BN buffers, optimizer moments and step count, the learning rate
of the last step. The host code without a model (the log
buffer, the hooks' classes, priorities and checkpoint schedule,
``merge_params``, the one-cycle learning rate at the resumed step) is held
against the JAX package's; the learning rate within 1e-6 relative (float32
cosines through numpy and through jnp).

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the chain's tests,
``tests/test_torch_train_chain.py`` and ``tests/test_torch_train_resume.py``
(each runs ``chain``); the hooks and ``merge_params``,
``tests/test_torch_train_hooks.py``; the checkpoint schedule,
``tests/test_torch_train_schedule.py``; the zoo,
``tests/test_torch_train_recipe.py``."""
import logging
import os
import sys

import pytest

import torch

from sparse2dense_tpu.training import hooks as jhooks
from sparse2dense_tpu_torch.tools import train as cli
from sparse2dense_tpu_torch.training import checkpoint as tckpt
from sparse2dense_tpu_torch.training import hooks as thooks
from sparse2dense_tpu_torch.utils.config import FLAGSHIP

CFG = "configs/tests/distill_tiny.py"
OVERRIDE = """
for _m in (model, S_model):
    _m["backbone"].update(engine="window", dense_from_stage=1, dense_compute_dtype=None)
del _m
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook")])
"""
TEACHER_STAGE = "S_model = model\ndistillation = False\n"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' small ops run as fast on it, and
    the suite's parallel workers share the cores (several threads each made
    this file's steps tens of times slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _argv(cfg, work, *extra):
    return [cfg, "--work_dir", work, "--batch_size", "1", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    text = open(CFG).read() + OVERRIDE
    ts_cfg, teacher_cfg = str(tmp / "ts.py"), str(tmp / "teacher.py")
    with open(ts_cfg, "w") as f:
        f.write(text)
    with open(teacher_cfg, "w") as f:
        f.write(text + TEACHER_STAGE)
    work = {k: str(tmp / k) for k in ("teacher", "whole", "resumed")}
    records = _Records()
    logger = logging.getLogger("sparse2dense_tpu_torch")
    logger.addHandler(records)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        teacher = cli.main(_argv(teacher_cfg, work["teacher"], "--synthetic", "1",
                                 "--epochs", "1"))
        load = ("--load_from", os.path.join(work["teacher"], "epoch_1"), "--synthetic", "2",
                "--epochs", "2")
        whole = cli.main(_argv(ts_cfg, work["whole"], *load))
        resumed = cli.main(_argv(ts_cfg, work["resumed"], *load, "--resume_from",
                                 os.path.join(work["whole"], "epoch_1")))
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
    return dict(teacher=teacher, whole=whole, resumed=resumed, work=work,
                ts_cfg=ts_cfg, log=records.messages)


def test_cli_refuses_what_it_does_not_run(tmp_path, monkeypatch):
    """``--launcher pytorch`` without torchrun's environment raises and
    names the missing variables (no quiet single-process run)."""
    argv = _argv(FLAGSHIP, str(tmp_path))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                                           "MASTER_PORT not set"):
        cli.main(argv + ["--launcher", "pytorch"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="environment; MASTER_PORT not set"):
        cli.main(argv + ["--synthetic", "2", "--launcher", "pytorch"])
    assert not os.listdir(tmp_path)


def test_log_buffer_against_jax():
    values = [(1.0, 1), (2.0, 3), (4.0, 1), (7.0, 2)]
    outs = []
    for mod in (jhooks, thooks):
        buf = mod.LogBuffer()
        for v, n in values:
            buf.update({"loss": v, "time": 10 * v}, count=n)
        out = []
        for window in (0, 1, 2, 3, 10):
            buf.average(window)
            out.append(dict(buf.output))
        buf.clear_output()
        out.append((dict(buf.output), buf.ready))
        outs.append(out)
    assert outs[0] == outs[1]


HOOK_CONFIGS = [
    (None, None),
    (dict(interval=5, hooks=[dict(type="TextLoggerHook")]), dict(interval=1)),
    (dict(interval=3, hooks=[dict(type="TextLoggerHook"), dict(type="TensorboardLoggerHook")]),
     dict(interval=2, iter_interval=3)),
]


def _hook_list(hooks):
    return [(type(h).__name__, h.priority, getattr(h, "interval", None),
             getattr(h, "iter_interval", None)) for h in hooks]


class _Recorder:
    """The trainer's side of the checkpoint hook: records each save."""

    work_dir = "w"

    def __init__(self):
        self.epoch = self.global_iter = self.inner_iter = 0
        self.saves = []

    def save_checkpoint(self, out_dir, name=None, latest=True, mid_epoch=False):
        self.saves.append((self.epoch, self.global_iter, out_dir, name, latest, mid_epoch))


def test_preempt_save_leaves_latest_on_the_last_epoch(tmp_path):
    state = {"model": {"w": torch.arange(3.0)}}
    tckpt.save_checkpoint(str(tmp_path), "epoch_1", state, meta={"epoch": 1})
    tckpt.save_checkpoint(str(tmp_path), "preempt", state, meta={"epoch": 1}, latest=False)
    assert os.readlink(tmp_path / "latest") == "epoch_1"
    restored, meta = tckpt.load_checkpoint(str(tmp_path / "latest"))
    assert meta == {"epoch": 1} and torch.equal(restored["model"]["w"], state["model"]["w"])


def test_tensorboard_hook_raises_without_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        thooks.TensorboardLoggerHook().before_run(_Recorder())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x
