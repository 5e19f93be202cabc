"""distill_tiny's teacher-student step on the gather engine (the reference's
default engine) against JAX's: metrics 1e-4, student gradients 1e-3 of
their module's largest, BN running statistics 1e-5 (moved from
``tests/test_torch_gather_engine.py``)."""
import numpy as np

from tests.test_torch_distill import _compare_metrics, _compare_stats, assert_grads_close
from tests.test_torch_gather_engine import run  # noqa: F401 (fixtures)


def test_gather_ts_step_metrics(run):
    _compare_metrics(run["metrics"], run["jmetrics"])
    assert float(run["metrics"]["grad_norm"]) > 0
    assert not [k for k in run["metrics"] if k.startswith("telemetry/")]


def test_gather_ts_step_student_gradients(run):
    assert_grads_close(run["s_grads"], run["js_grads"])
    for name in ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                 "backbone.conv2_down.conv_weight", "backbone.conv2_1.conv2_weight"):
        assert np.abs(run["s_grads"][name]).max() > 0, name


def test_gather_ts_step_batchnorm_statistics(run):
    _compare_stats(run["s_stats"], run["js_stats"])
