"""The plain training step of ``distill_tiny``'s VoxelNet teacher (window
engine, dense stages from conv2 in float32) against JAX's, on the same
seeded random weights and batch as ``tests/test_torch_distill.py``'s
teacher-student step (its ``ts_and_teacher_steps``, here without the
teacher-student step): metrics 1e-4, gradients 1e-3 of their module's
largest, BN running statistics 1e-5."""
import pytest

from tests.test_torch_distill import (
    ENGINE, _compare_metrics, _compare_stats, assert_grads_close, ts_and_teacher_steps)


@pytest.fixture(scope="module")
def run():
    return ts_and_teacher_steps(ENGINE, ts_step=False)


def test_teacher_train_step(run):
    """The plain step of the VoxelNet teacher (RPN neck): metrics,
    gradients and the BN statistics of its training forward."""
    _compare_metrics(run["t_metrics"], run["jt_metrics"])
    assert_grads_close(run["t_grads"], run["jt_grads"])
    _compare_stats(run["t_stats"], run["jt_stats"])
