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
cosines through numpy and through jnp)."""
import logging
import os
import sys

import numpy as np
import pytest

import torch

from sparse2dense_tpu import zoo
from sparse2dense_tpu.solver.schedules import one_cycle_lr as jax_one_cycle_lr
from sparse2dense_tpu.training import checkpoint as jckpt
from sparse2dense_tpu.training import hooks as jhooks
from sparse2dense_tpu_torch.tools import train as cli
from sparse2dense_tpu_torch.training import checkpoint as tckpt
from sparse2dense_tpu_torch.training import hooks as thooks
from sparse2dense_tpu_torch.utils.config import DENSE_TEACHER, FLAGSHIP, ConfigDict

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


def test_cli_trains_and_writes_checkpoints(chain):
    whole, work = chain["whole"], chain["work"]
    assert (whole.epoch, whole.global_iter, whole.optimizer.count) == (2, 4, 4)
    assert sorted(os.listdir(work["whole"])) == ["epoch_1", "epoch_2", "latest"]
    assert os.readlink(os.path.join(work["whole"], "latest")) == "epoch_2"
    state, meta = tckpt.load_checkpoint(os.path.join(work["whole"], "latest"))
    assert (meta["epoch"], meta["iter"]) == (2, 4)
    assert meta["config"] == open(chain["ts_cfg"]).read()
    assert meta["classes"] == ["VEHICLE", "PEDESTRIAN", "CYCLIST"]
    for name, value in whole.model.state_dict().items():
        assert torch.equal(state["model"][name], value), name
    history = whole.log_buffer.val_history
    assert len(history["loss"]) == 4 and np.isfinite(history["loss"]).all()
    assert min(history["grad_norm"]) > 0
    assert len(history["time"]) == len(history["data_time"]) == 4
    assert sorted(os.listdir(work["teacher"])) == ["epoch_1", "latest"]
    assert sorted(os.listdir(work["resumed"])) == ["epoch_2", "latest"]
    assert type(chain["teacher"]).__name__ == "Trainer"


def test_hooks_log(chain):
    log = chain["log"]
    assert sum(m.startswith("epoch [2][2/2], lr: ") and "loss: " in m for m in log) == 2
    assert any(m.startswith("saved checkpoint ") and m.endswith("epoch_2") for m in log)
    assert any(m.startswith("loaded teacher checkpoint ") for m in log)
    assert any(m.startswith("resumed from ") and "epoch 1, iter 2" in m for m in log)


def test_load_from_loads_the_teacher_exactly(chain):
    saved, _ = tckpt.load_checkpoint(os.path.join(chain["work"]["teacher"], "epoch_1"))
    trained = chain["teacher"].model.state_dict()
    for run in ("whole", "resumed"):
        teacher = chain[run].teacher.state_dict()
        assert sorted(teacher) == sorted(saved["model"])
        for name, value in teacher.items():
            assert torch.equal(value, saved["model"][name]), name
            assert torch.equal(value, trained[name]), name


def test_resume_is_bit_equal_to_uninterrupted_training(chain):
    whole, resumed = chain["whole"], chain["resumed"]
    assert (resumed.epoch, resumed.global_iter) == (whole.epoch, whole.global_iter)
    got, want = resumed.model.state_dict(), whole.model.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    got, want = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert got["count"] == want["count"] == 4
    assert sorted(got["state"]) == sorted(want["state"])
    for i, moments in want["state"].items():
        for k, value in moments.items():
            assert torch.equal(got["state"][i][k], value), (i, k)
    assert resumed.current_stats["lr"] == whole.current_stats["lr"]
    assert resumed.current_stats["lr"] == float(whole.optimizer.lr(3))
    assert resumed.log_buffer.val_history["loss"] == whole.log_buffer.val_history["loss"][2:]


def test_learning_rate_at_the_resumed_step_against_jax(chain):
    lr_cfg, opt = ConfigDict.fromfile(CFG).lr_config, chain["resumed"].optimizer
    want = jax_one_cycle_lr(lr_cfg.lr_max, lr_cfg.div_factor, lr_cfg.pct_start, 4)
    for step in range(5):
        np.testing.assert_allclose(float(opt.lr(step)), float(want(step)), rtol=1e-6)


def test_cli_refuses_what_it_does_not_run(tmp_path):
    argv = _argv(FLAGSHIP, str(tmp_path))
    with pytest.raises(NotImplementedError, match="DDP.*item 6"):
        cli.main(argv + ["--launcher", "pytorch"])
    with pytest.raises(NotImplementedError, match="DDP.*item 6"):
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


@pytest.mark.parametrize("log_config,checkpoint_config", HOOK_CONFIGS)
def test_build_hooks_against_jax(log_config, checkpoint_config):
    want = _hook_list(jhooks.build_hooks(log_config, checkpoint_config, work_dir="w"))
    assert _hook_list(thooks.build_hooks(log_config, checkpoint_config, work_dir="w")) == want


class _Recorder:
    """The trainer's side of the checkpoint hook: records each save."""

    work_dir = "w"

    def __init__(self):
        self.epoch = self.global_iter = self.inner_iter = 0
        self.saves = []

    def save_checkpoint(self, out_dir, name=None, latest=True, mid_epoch=False):
        self.saves.append((self.epoch, self.global_iter, out_dir, name, latest, mid_epoch))


@pytest.mark.parametrize("checkpoint_config", [dict(interval=1), dict(interval=2),
                                               dict(interval=2, iter_interval=3)])
def test_checkpoint_schedule_against_jax(checkpoint_config):
    saves = []
    for mod in (jhooks, thooks):
        hooks = [h for h in mod.build_hooks(None, checkpoint_config, work_dir="out")
                 if type(h).__name__ == "CheckpointHook"]
        trainer = _Recorder()
        for _ in range(5):
            for i in range(4):
                trainer.inner_iter = i
                for h in hooks:
                    h.after_train_iter(trainer)
                trainer.global_iter += 1
            for h in hooks:
                h.after_train_epoch(trainer)
            trainer.epoch += 1
        saves.append(trainer.saves)
    assert saves[0] == saves[1] and saves[1]


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


def test_merge_params_against_jax(caplog):
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    target = {"conv": {"weight": arr(4, 3), "bias": arr(4)}, "bn": {"mean": arr(4), "var": arr(4)},
              "head": {"weight": arr(2, 4)}}
    restored = {"conv": {"weight": arr(4, 3), "bias": arr(5)}, "bn": {"mean": arr(4)},
                "head": {"weight": arr(2, 4)}, "extra": {"weight": arr(3)}}
    with caplog.at_level(logging.WARNING):
        want = _flat(jckpt.merge_params(target, restored, logging.getLogger("jax_side")))
        got = tckpt.merge_params(
            {k: torch.from_numpy(v) for k, v in _flat(target).items()},
            {k: torch.from_numpy(v) for k, v in _flat(restored).items()},
            logging.getLogger("port_side"))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(value), err_msg=name)
    messages = {r.name: r.getMessage() for r in caplog.records}
    assert messages["port_side"] == messages["jax_side"] == (
        "checkpoint merge: 1 missing, 1 shape-mismatched keys")


@pytest.mark.parametrize("variant,path", [("3x_dense_interval_5", DENSE_TEACHER),
                                          ("3x_distill_interval_5", FLAGSHIP)])
def test_recipe_configs_against_the_zoo(variant, path):
    """The port's two recipe configs are the reference zoo rows, key for
    key, the data layer's entries and the voxel generator's data-pipeline
    flag included; the one exemption is the flagship's teacher checkpoint,
    which is not in the repository."""
    want, got = zoo.waymo_voxelnet(variant), ConfigDict.fromfile(path)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x
