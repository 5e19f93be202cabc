"""A train-mode TileKBlock (two TileConvs, bias, masked BN, ReLU, residual)
against the reference's TileBasicBlock: output, BN statistics and
gradients (moved from ``tests/test_torch_tile_train.py``)."""
import numpy as np

from tests.test_torch_tile_train import _rel, block_case  # noqa: F401 (fixtures)


def test_tile_block_train_output_and_statistics_match_jax(block_case):
    c = block_case
    np.testing.assert_allclose(c["out"], c["jout"], **_rel(c["jout"]))
    stats = {k: v.numpy() for k, v in c["block"].state_dict().items() if "running" in k}
    assert sorted(stats) == sorted(c["jstats"])
    for k, v in c["jstats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)
        assert not np.allclose(v, 0 if "mean" in k else 1), k   # the statistics moved


def test_tile_block_train_gradients_match_jax(block_case):
    """Weight gradients within 1e-3 of the block's largest (the block is
    their module; a conv bias right before train-mode BatchNorm has a true
    gradient of 0, and both sides give it rounding), the input's within
    1e-3 of its largest."""
    c = block_case
    got = {n: p.grad.numpy() for n, p in c["block"].named_parameters()}
    assert sorted(got) == sorted(c["jgrads"])
    scale = max(float(np.abs(g).max()) for g in c["jgrads"].values())
    for name, g in c["jgrads"].items():
        np.testing.assert_allclose(got[name], g, rtol=0, atol=1e-3 * scale, err_msg=name)
    np.testing.assert_allclose(c["dy"], c["jdy"], rtol=0, atol=1e-3 * np.abs(c["jdy"]).max())
    assert np.abs(got["conv1_weight"]).max() > 0 and np.abs(got["conv2_weight"]).max() > 0
