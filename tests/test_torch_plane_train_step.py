"""distill_tiny's teacher-student step with both backbones on the plane
engine against the same step on the gather engine (already held against
JAX): metrics, student gradients, BN running statistics (moved from
``tests/test_torch_plane_train.py``)."""
import numpy as np

from tests.test_torch_distill import _compare_stats
from tests.test_torch_plane_train import COUNTERS, ts_steps  # noqa: F401 (fixtures)


def test_plane_ts_step_metrics(ts_steps):
    got, want = ts_steps["plane"]["metrics"], ts_steps["gather"]["metrics"]
    tele = {k: int(v) for k, v in got.items() if k.startswith("telemetry/")}
    assert {k.split("/")[1] for k in tele} >= set(COUNTERS)
    assert all(v == 0 for k, v in tele.items() if k.split("/")[1] in COUNTERS), tele
    assert sorted(k for k in got if k not in tele) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    assert float(got["grad_norm"]) > 0


def test_plane_ts_step_student_gradients(ts_steps):
    """Each gradient within 1e-3 of its module's largest. A conv bias right
    before train-mode BatchNorm has a true gradient of 0, and what each
    engine computes for it is float32 rounding of sums whose terms scale
    with the step's largest gradient (~3e7 on this ill-conditioned tiny
    step), so every tensor also gets 1e-12 of that largest gradient."""
    got, want = ts_steps["plane"]["grads"], ts_steps["gather"]["grads"]
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
    for name in ("backbone.conv_input.conv_0_weight", "backbone.conv2_down.conv_weight",
                 "backbone.conv2_0.conv1_weight", "backbone.conv4_1.conv2_weight",
                 "backbone.extra_conv.conv_weight"):
        assert np.abs(got[name]).max() > 0, name


def test_plane_ts_step_batchnorm_statistics(ts_steps):
    _compare_stats(ts_steps["plane"]["stats"], ts_steps["gather"]["stats"])
