"""distill_tiny's teacher-student step with both backbones on the tile engine
against the same step on the gather engine (already held against JAX):
metrics, student gradients, BN running statistics (moved from
``tests/test_torch_tile_train.py``)."""
import numpy as np

from tests.test_torch_distill import _compare_stats
from tests.test_torch_tile_detector import COUNTERS
from tests.test_torch_tile_train import ts_steps  # noqa: F401 (fixtures)


def test_tile_ts_step_metrics(ts_steps):
    got, want = ts_steps["tile"]["metrics"], ts_steps["gather"]["metrics"]
    tele = {k: int(v) for k, v in got.items() if k.startswith("telemetry/")}
    assert {k.split("/")[1] for k in tele} >= set(COUNTERS)
    assert all(v == 0 for v in tele.values()), tele
    assert sorted(k for k in got if k not in tele) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    assert float(got["grad_norm"]) > 0


def test_tile_ts_step_student_gradients(ts_steps):
    got, want = ts_steps["tile"]["grads"], ts_steps["gather"]["grads"]
    assert sorted(got) == sorted(want)
    scale = {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(g).max()))
    floor = 1e-12 * max(scale.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=1e-3 * scale[name.rsplit(".", 1)[0]] + floor,
                                   err_msg=name)
    for name in ("backbone.conv_input.conv_0_weight", "backbone.conv1_0.conv1_weight",
                 "backbone.conv2_down.conv_weight", "backbone.conv2_1.conv2_weight"):
        assert np.abs(got[name]).max() > 0, name


def test_tile_ts_step_batchnorm_statistics(ts_steps):
    _compare_stats(ts_steps["tile"]["stats"], ts_steps["gather"]["stats"])
