"""The training CLI's chain on distill_tiny (window engine): the teacher
trains and writes its checkpoint, the text log writes its lines, and
``--load_from`` loads the teacher exactly (moved from
``tests/test_torch_train_runtime.py``, whose ``chain`` fixture runs it)."""
import os

import numpy as np
import torch

from sparse2dense_tpu_torch.training import checkpoint as tckpt

from tests.test_torch_train_runtime import chain, one_thread  # noqa: F401 (fixtures)


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
