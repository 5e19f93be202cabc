"""The tile backbone in train mode against the gather engine (already held
against JAX) at ``dense_from_stage`` 0: the tile counters 0, the BEV and BN
running statistics, the gradients, and the two tile backends bit for bit
(moved from ``tests/test_torch_tile_train.py``; 2 and 99 run these tests in
``tests/test_torch_tile_train_dfs2.py`` and ``_dfs99.py``)."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD

from tests.test_torch_distill import _port_grads
from tests.test_torch_tile_detector import COUNTERS
from tests.test_torch_tile_train import ENGINES, GRID, SETTINGS, _coords, _weights


@pytest.fixture(scope="module", params=[0], ids=["dfs0"])
def backbones(request):
    """At ``dense_from_stage`` 0 (2 and 99:
    ``tests/test_torch_tile_train_dfs{2,99}.py``)."""
    return make_backbones(request.param)


def make_backbones(dfs):
    """Train-mode forward and the gradients of sum(BEV^2) on the gather and
    the tile engine (both backends), from one set of weights, at
    ``dense_from_stage`` ``dfs``."""
    rng = np.random.RandomState(dfs + 5)
    feats = np.stack([rng.randn(200, 5) for _ in range(2)]).astype(np.float32)
    coords = np.stack([_coords(s, GRID, 200, 20) for s in (dfs, dfs + 1)])
    feats[:, -20:] = 0
    weights, out = None, {}
    for name, kw in ENGINES.items():
        mod = SpMiddleResNetFHD(dense_from_stage=dfs, **SETTINGS, **kw)
        weights = weights or _weights(mod, 31 + dfs)
        mod.load_state_dict(weights)
        mod.train()
        bev, _, tele = mod(torch.from_numpy(feats), torch.from_numpy(coords))
        bev.square().sum().backward()
        out[name] = dict(bev=bev.detach().numpy(), telemetry=tele,
                         stats={k: v.clone() for k, v in mod.state_dict().items()
                                if "running" in k},
                         grads=_port_grads(mod))
    return dfs, out


def test_tile_train_counters_are_zero(backbones):
    dfs, runs = backbones
    for name in ("xla", "pallas"):
        tele = runs[name]["telemetry"]
        assert sorted(tele) == sorted(COUNTERS)
        for k, (counts, budget) in tele.items():
            assert (int(counts.sum()), budget) == (0, 0), (name, k)


def test_tile_train_bev_and_statistics_match_gather(backbones):
    dfs, runs = backbones
    t, g = runs["xla"], runs["gather"]
    assert t["bev"].shape == g["bev"].shape and np.abs(g["bev"]).max() > 0
    np.testing.assert_allclose(t["bev"], g["bev"], rtol=2e-4, atol=2e-4)
    assert sorted(t["stats"]) == sorted(g["stats"])
    for k, v in g["stats"].items():
        np.testing.assert_allclose(t["stats"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_tile_train_gradients_match_gather(backbones):
    """Every weight from conv_input to extra_conv gets the gather engine's
    gradient, within 2e-3 of its module's largest; conv_input's weights
    keep the reference's (16, 5, 3, 3, 3) shape."""
    dfs, runs = backbones
    got, want = runs["xla"]["grads"], runs["gather"]["grads"]
    assert sorted(got) == sorted(want)
    scale = {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 1.0), float(np.abs(g).max()))
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=2e-3,
                                   atol=2e-3 * scale[name.rsplit(".", 1)[0]], err_msg=name)
    assert got["conv_input.conv_0_weight"].shape == (16, 5, 3, 3, 3)
    for name in ("conv_input.conv_0_weight", "conv1_0.conv1_weight", "conv2_1.conv2_weight",
                 "conv3_down.conv_weight", "conv4_1.conv2_weight", "extra_conv.conv_weight"):
        assert np.abs(got[name]).max() > 0, name


def test_tile_train_backends_agree_bit_for_bit(backbones):
    """``"pallas"`` trains as ``"xla"`` does (its plan windows are not read
    in training): the same BEV, statistics and gradients, bit for bit."""
    dfs, runs = backbones
    x, p = runs["xla"], runs["pallas"]
    np.testing.assert_array_equal(p["bev"], x["bev"])
    for k, v in x["stats"].items():
        assert torch.equal(p["stats"][k], v), k
    for k, v in x["grads"].items():
        np.testing.assert_array_equal(p["grads"][k], v, err_msg=k)
