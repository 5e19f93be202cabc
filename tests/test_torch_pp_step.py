"""The "pp" teacher-student step (``distill_cfg(pp_tiny)``'s PointPillars
teacher and KD_PointPillars student, one point a pillar, batch 1) against
JAX's, where the reference is reproducible (moved from
``tests/test_torch_pp.py``, whose ``models`` and ``ts_run`` fixtures it uses)."""
import numpy as np

from tests.test_torch_distill import _compare_stats, assert_grads_close
from tests.test_torch_pp import _worst_scaled, models, ts_run  # noqa: F401 (fixtures)


def test_pp_ts_step_reference_is_reproducible_here(ts_run):
    """The judged fixture: JAX's step on ulp-perturbed weights moves its
    gradients by less than a tenth of the tolerance below."""
    spread = _worst_scaled({k: ts_run["jax_perturbed"]["grads"][k].numpy()
                            for k in ts_run["grads"]},
                           {k: v.numpy() for k, v in ts_run["jax"]["grads"].items()})
    assert spread < 1e-4, spread


def test_pp_ts_step_metrics(ts_run):
    got, want = ts_run["metrics"], ts_run["jax"]["metrics"]
    assert ts_run["branch"] == "pp"
    assert sorted(got) == sorted(want)
    for k in ("kd_hm_loss", "T_hm_loss", "sparse2dense_loss", "mask_loss",
              "reconstruction_loss"):
        assert float(want[k]) > 0, k
    assert "kd_reg_loss" not in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)


def test_pp_ts_step_gradients(ts_run):
    assert_grads_close(ts_run["grads"], ts_run["jax"]["grads"])
    for name in ("reader.pfn_0.linear.weight", "backbone.encoder_1a.conv.weight",
                 "backbone.generator_a.conv.weight", "backbone.fusion_sparse.conv.weight",
                 "neck.block_0.down.conv.weight", "bbox_head.task_0.hm_out.weight"):
        assert np.abs(ts_run["grads"][name]).max() > 0, name


def test_pp_ts_step_batchnorm_statistics(ts_run):
    assert any(k.startswith("backbone.generator_a") for k in ts_run["stats"])
    _compare_stats(ts_run["stats"], ts_run["jax"]["stats"])
