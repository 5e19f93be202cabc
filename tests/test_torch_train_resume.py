"""The training CLI's resume on distill_tiny: ``--resume_from`` is bit-equal to
an uninterrupted run, at the learning rate JAX's schedule gives the resumed
step (moved from ``tests/test_torch_train_runtime.py``, whose ``chain``
fixture runs it)."""
import numpy as np
import torch

from sparse2dense_tpu.solver.schedules import one_cycle_lr as jax_one_cycle_lr
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_train_runtime import CFG, chain, one_thread  # noqa: F401 (fixtures)


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
