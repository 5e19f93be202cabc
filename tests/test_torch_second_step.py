"""SECOND's teacher-student step (branch "second", ``second_distill_tiny``) against
JAX's, and its window-engine step against its gather-engine step (moved
from ``tests/test_torch_second.py`` with the branch of a SpMiddleFHD teacher)."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.training.distill import branch_of, make_ts_train_step
from sparse2dense_tpu_torch.utils.config import ConfigDict, SECOND

from tests.test_torch_distill import _compare_stats, assert_grads_close
from tests.test_torch_second import DCFG, _compare_metrics, ts_run  # noqa: F401 (fixtures)


def test_branch_of_second():
    assert branch_of(ConfigDict.fromfile(DCFG).model) == "second"
    assert branch_of(ConfigDict.fromfile(SECOND).model) == "second"
    with pytest.raises(ValueError, match="unknown distillation branch"):
        make_ts_train_step(None, None, None, "voxelnext")


def test_second_ts_step_against_jax(ts_run):
    run, jmetrics = ts_run["runs"]["reference"], ts_run["jmetrics"]
    _compare_metrics(run["metrics"], jmetrics)
    assert "kd_hm_loss" not in run["metrics"] and "T_hm_loss" not in run["metrics"]
    assert float(run["metrics"]["grad_norm"]) > 0
    assert_grads_close(run["grads"], ts_run["jgrads"])
    _compare_stats(run["stats"], ts_run["jstats"])


def test_second_ts_step_window_against_gather(ts_run):
    """The port's window engine against its gather engine: metrics,
    gradients (subm0's and down1's among them, through B1's autograd
    Function on the card) and BN statistics."""
    win, gat = ts_run["runs"]["window"], ts_run["runs"]["gather"]
    assert all(float(win["metrics"][k]) == 0 for k in ("telemetry/subm0", "telemetry/down1"))
    _compare_metrics({k: v for k, v in win["metrics"].items() if not k.startswith("telemetry/")},
                     gat["metrics"])
    assert_grads_close(win["grads"], {k: torch.from_numpy(v) for k, v in gat["grads"].items()})
    for name in ("backbone.subm0.conv_0_weight", "backbone.subm0.conv_1_weight",
                 "backbone.down1.conv_weight"):
        assert np.abs(win["grads"][name]).max() > 0, name
    _compare_stats(win["stats"], gat["stats"])
