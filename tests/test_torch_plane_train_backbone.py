"""The plane backbone in train mode against the gather engine (already held
against JAX): the plane counters 0, the BEV and BN running statistics, the
gradients (moved from ``tests/test_torch_plane_train.py``)."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD

from tests.test_torch_distill import _port_grads
from tests.test_torch_layers import flax_shapes, rand_variables
from tests.test_torch_plane_train import COUNTERS, SETTINGS, scene


@pytest.fixture(scope="module")
def backbones():
    """Train-mode forward and the gradients of sum(BEV^2) on both engines,
    from one set of weights (the reference gather module's shapes, read off
    the port's twin)."""
    feats, coords = scene(2, v=400, b=2)
    variables = rand_variables(flax_shapes(SpMiddleResNetFHD(engine="gather", **SETTINGS)),
                               seed=31)
    out = {}
    for engine in ("gather", "plane"):
        mod = SpMiddleResNetFHD(engine=engine, **SETTINGS)
        mod.load_state_dict(from_flax(variables, mod))
        mod.train()
        bev, _, tele = mod(torch.from_numpy(feats), torch.from_numpy(coords))
        bev.square().sum().backward()
        out[engine] = dict(bev=bev.detach().numpy(), telemetry=tele,
                           stats={k: v.clone() for k, v in mod.state_dict().items()
                                  if "running" in k},
                           grads=_port_grads(mod))
    return out


def test_plane_train_counters_are_zero(backbones):
    tele = backbones["plane"]["telemetry"]
    for name in COUNTERS:
        assert int(tele[name][0].sum()) == 0, name
    assert all(int(c.max()) <= b for c, b in tele.values())


def test_plane_train_bev_and_statistics_match_gather(backbones):
    p, g = backbones["plane"], backbones["gather"]
    assert p["bev"].shape == g["bev"].shape and np.abs(g["bev"]).max() > 0
    np.testing.assert_allclose(p["bev"], g["bev"], rtol=2e-4, atol=2e-4)
    assert sorted(p["stats"]) == sorted(g["stats"])
    for k, v in g["stats"].items():
        np.testing.assert_allclose(p["stats"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_plane_train_gradients_match_gather(backbones):
    """Every weight from conv_input to extra_conv gets the gather engine's
    gradient, within 2e-3 of its module's largest."""
    got, want = backbones["plane"]["grads"], backbones["gather"]["grads"]
    assert sorted(got) == sorted(want)
    scale = {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 1.0), float(np.abs(g).max()))
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=2e-3,
                                   atol=2e-3 * scale[name.rsplit(".", 1)[0]], err_msg=name)
    for name in ("conv_input.conv_0_weight", "conv2_0.conv1_weight", "conv3_down.conv_weight",
                 "conv4_1.conv2_weight", "extra_conv.conv_weight"):
        assert np.abs(got[name]).max() > 0, name
