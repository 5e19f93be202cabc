"""PointPillars' inference (head maps, detections) and KD_PointPillars in
training (head maps, S2D maps, PCR generators and loss) against JAX (moved
from ``tests/test_torch_pp.py``, whose ``models``, ``teacher_run`` and
``student_run`` fixtures they use)."""
import numpy as np

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_pp import models, student_run, teacher_run  # noqa: F401 (fixtures)

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_point_pillars_inference_maps(teacher_run):
    """The teacher reads the dense stream; its canvas F_a and the
    reconstruction stream's F_b (the PFN's tolerance) and every head map."""
    out = teacher_run["out"]
    for got, want in zip((out["f_a"], out["f_b"]), teacher_run["jf"]):
        want = np.asarray(want)
        assert got.shape == (2, 32, 32, 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
    for pd, jpd in zip(out["preds"], teacher_run["jpreds"]):
        for k, v in jpd.items():
            v = np.asarray(v)
            np.testing.assert_allclose(pd[k].numpy(), v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1.0), err_msg=k)


def test_point_pillars_detections(teacher_run):
    want, got = teacher_run["jdet"], teacher_run["det"]
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_preds"].numpy(), np.asarray(want["label_preds"]))
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_kd_point_pillars_train_maps(student_run):
    """F_S_a, F_S_b NHWC; the PCR outputs NCDHW at depth 1 (JAX: NDHWC)."""
    out, jout = student_run["out"], student_run["jout"]
    assert out["gen_offset"].shape == (2, 3, 1, 32, 32)
    assert out["gen_mask"].shape == (2, 1, 1, 32, 32)
    for k in ("f_s_a", "f_s_b", "gen_offset", "gen_mask"):
        got = out[k] if k.startswith("f_") else out[k].permute(0, 2, 3, 4, 1)
        want = np.asarray(jout[k])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0), err_msg=k)
    for pd, jpd in zip(out["preds"], jout["preds"]):
        for k, v in jpd.items():
            v = np.asarray(v)
            np.testing.assert_allclose(pd[k].numpy(), v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1.0), err_msg=k)


def test_kd_point_pillars_pcr_loss(student_run):
    for got, want in zip(student_run["pcr"], student_run["jpcr"]):
        assert float(want) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
