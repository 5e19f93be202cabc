"""The window engine at ``dense_from_stage`` 3 and 99: every stage past
conv3_down on windowed convs (the conv3 blocks or SECOND's subm2 at 64->64,
conv4_down at 64->128 or down3 at 64->64, at 99 also the conv4 blocks at
128->128 or subm3 at 64->64 and the z-only extra_conv), on both backbones,
against the port's gather engine at the same ``dense_from_stage`` (held
against JAX by ``tests/test_torch_gather_engine{,_dfs2,_dfs99}.py``) with
the same weights, in eval and in train mode: the BEV within 1e-4 of its
largest value, BN running statistics within 1e-5, the gradients of
sum(BEV^2) within 1e-3 of their module's largest, every plan's residual
rows within its budget. The frame and the weights are
``tests/test_torch_window_dfs2.py``'s. This file holds the runs and the
gradients; each (backbone, mode) case's modules, residual rows, BEV and
statistics are checked in ``tests/test_torch_window_dfs3_<backbone>_<mode>.py``,
B1's weight layout and widths in ``tests/test_torch_window_dfs3_layout.py``,
its plain version at the new widths against JAX in
``tests/test_torch_window_dfs3_pass.py``, one Flax tree loaded into both
engines in ``tests/test_torch_window_dfs3_convert.py``."""
import numpy as np
import pytest
import torch

from tests.test_torch_layers import session_shared
from tests.test_torch_window_dfs2 import (  # noqa: F401 (fixtures)
    BACKBONES, GRID, frame, one_thread, seeded_weights)

DFS = (3, 99)


def run_backbone(cls, engine, dfs, weights, feats, coords, train):
    mod = cls(num_input_features=5, sparse_shape=GRID, engine=engine, dense_from_stage=dfs)
    mod.load_state_dict(weights)
    mod.train(train)
    with torch.set_grad_enabled(train):
        bev, _, tele = mod(feats, coords)
        if train:
            bev.square().sum().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in mod.named_parameters()} if train else {}
    stats = {k: v.clone() for k, v in mod.state_dict().items() if "running" in k}
    modules = {n: type(m).__name__ for n, m in mod.named_children()}
    return dict(bev=bev.detach().numpy(), telemetry=tele, grads=grads, stats=stats,
                modules=modules)


@pytest.fixture(scope="module")
def runs(frame, tmp_path_factory):
    """(backbone, dense_from_stage, train) -> (window run, gather run), each
    computed once a test session (``session_shared``: the training runs are
    checked here and in the ``*_train.py`` files)."""
    cache = {}

    def compute(name, dfs, train):
        cls = BACKBONES[name]
        weights = seeded_weights(cls(num_input_features=5, sparse_shape=GRID), 40)
        return tuple(run_backbone(cls, engine, dfs, weights, *frame, train)
                     for engine in ("window", "gather"))

    def get(name, dfs, train):
        key = (name, dfs, train)
        if key not in cache:
            cache[key] = session_shared(
                tmp_path_factory, f"window_dfs{dfs}_{name}_{'train' if train else 'eval'}",
                lambda: compute(*key))
        return cache[key]
    return get


def engines_fixture(name, train):
    """An ``engines`` fixture for one (backbone, train) case at both
    ``dense_from_stage`` values: (backbone, dense_from_stage, train, window
    run, gather run). Each case's module runs its two checks on it."""
    @pytest.fixture(params=[(name, dfs, train) for dfs in DFS],
                    ids=[f"{name}-dfs{dfs}-{'train' if train else 'eval'}" for dfs in DFS])
    def engines(request, runs):
        return request.param + runs(*request.param)
    return engines


def assert_gradients_match(got, want):
    """Each gradient within 1e-3 of its module's largest, plus 1e-12 of the
    largest gradient of all."""
    scale = {}
    for n, g in want.items():
        module = n.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(g).max()))
    floor = 1e-12 * max(scale.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0,
                                   atol=1e-3 * scale[n.rsplit(".", 1)[0]] + floor, err_msg=n)


@pytest.mark.parametrize("name,dfs", [(n, d) for n in BACKBONES for d in DFS])
def test_deep_gradients_match_gather(runs, name, dfs):
    """Train mode: each gradient within 1e-3 of its module's largest, plus
    1e-12 of the largest gradient of all (a conv bias right before
    train-mode BatchNorm has a true gradient of 0 and gets float32 rounding
    of sums that scale with it); a gradient on every windowed conv weight
    past conv3_down."""
    win, gather = runs(name, dfs, True)
    got = win["grads"]
    assert_gradients_match(got, gather["grads"])
    if name == "resnet":
        windowed = ["conv3_0.conv1_weight", "conv3_1.conv2_weight", "conv4_down.conv_weight"]
        windowed += (["conv4_0.conv1_weight", "conv4_1.conv2_weight", "extra_conv.conv_weight"]
                     if dfs > 4 else [])
    else:
        windowed = ["subm2.conv_0_weight", "subm2.conv_2_weight", "down3.conv_weight"]
        windowed += ["subm3.conv_2_weight", "extra_conv.conv_weight"] if dfs > 4 else []
    for n in windowed:
        assert np.abs(got[n]).max() > 0, n
