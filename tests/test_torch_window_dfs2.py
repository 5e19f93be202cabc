"""The window engine at ``dense_from_stage=2``: the conv2 stage (blocks or
SECOND's subm1) and the strided conv to stage 3 on windowed convs, on both
backbones, against the port's gather engine at ``dense_from_stage=2`` (held
against JAX by ``tests/test_torch_gather_engine.py`` and
``tests/test_torch_second.py``) with the same weights, in eval and in train
mode: the BEV within 1e-4 of its largest value, BN running statistics
within 1e-5, the gradients of sum(BEV^2) within 1e-3 of their module's
largest. The tiny frame's residual rows fit every plan's budget, so the
window engine is exact. This file holds the frame, the runs, the
gradients and the refusals; each (backbone, mode) case's modules, residual
rows, BEV and statistics are checked in
``tests/test_torch_window_dfs2_<backbone>_<mode>.py``, the per-stage plan
windows and the window pass at Cin 32 -> Cout 64 (conv3_down's width) on
the card in ``tests/test_torch_window_dfs2_windows.py``."""
import numpy as np
import pytest

import torch

from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleFHD, SpMiddleResNetFHD
from sparse2dense_tpu_torch.ops import window_kernel as TWK
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import session_shared

GRID = (25, 32, 32)
BACKBONES = {"resnet": SpMiddleResNetFHD, "second": SpMiddleFHD}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small ops run as fast on it, and the suite's
    parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frame():
    """``voxelnet_tiny``'s synthetic frame (two samples) with seeded voxel
    features."""
    coords = make_batch(ConfigDict.fromfile("configs/tests/voxelnet_tiny.py"), 2,
                        max_voxels=512, n_points=3000, n_obj=6, device="cpu")["coordinates"]
    feats = np.random.RandomState(5).randn(*coords.shape[:2], 5).astype(np.float32)
    return torch.from_numpy(feats), coords


def seeded_weights(module, seed):
    """A state dict of ``module``'s shapes from a seeded numpy generator:
    fan-in scaled kernels, BN statistics away from 0 and 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in module.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif t.dim() == 5:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out


def run_backbone(cls, engine, weights, feats, coords, train):
    mod = cls(num_input_features=5, sparse_shape=GRID, engine=engine, dense_from_stage=2)
    mod.load_state_dict(weights)
    mod.train(train)
    with torch.set_grad_enabled(train):
        bev, _, tele = mod(feats, coords)
        if train:
            bev.square().sum().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in mod.named_parameters()} if train else {}
    stats = {k: v.clone() for k, v in mod.state_dict().items() if "running" in k}
    return mod, dict(bev=bev.detach().numpy(), telemetry=tele, grads=grads, stats=stats)


@pytest.fixture(scope="module")
def runs(frame, tmp_path_factory):
    """(backbone, train) -> (window module, window run, gather run), each
    run once a session (``session_shared``: the training runs are checked
    here and in the ``tests/test_torch_window_dfs2_*_train.py`` files)."""
    cache = {}

    def compute(name, train):
        cls = BACKBONES[name]
        weights = seeded_weights(cls(num_input_features=5, sparse_shape=GRID), 40)
        win_mod, win = run_backbone(cls, "window", weights, *frame, train)
        _, gather = run_backbone(cls, "gather", weights, *frame, train)
        return win_mod, win, gather

    def get(name, train):
        if (name, train) not in cache:
            cache[name, train] = session_shared(
                tmp_path_factory, f"window_dfs2_{name}_{'train' if train else 'eval'}",
                lambda: compute(name, train))
        return cache[name, train]
    return get


def engines_fixture(name, train):
    """An ``engines`` fixture for one (backbone, train) case: (backbone,
    train, window module, window run, gather run). Each case's module
    (``tests/test_torch_window_dfs2_<backbone>_<mode>.py``) runs its four
    checks on it."""
    @pytest.fixture(params=[(name, train)], ids=[f"{name}-{'train' if train else 'eval'}"])
    def engines(request, runs):
        return request.param + runs(*request.param)
    return engines


@pytest.mark.parametrize("name", list(BACKBONES))
def test_dfs2_gradients_match_gather(runs, name):
    """Train mode: each gradient within 1e-3 of its module's largest, plus
    1e-12 of the largest gradient of all (a conv bias right before
    train-mode BatchNorm has a true gradient of 0 and gets float32 rounding
    of sums that scale with it); a gradient on every windowed conv
    weight."""
    _, win, gather = runs(name, True)
    got, want = win["grads"], gather["grads"]
    scale = {}
    for n, g in want.items():
        module = n.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(g).max()))
    floor = 1e-12 * max(scale.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0,
                                   atol=1e-3 * scale[n.rsplit(".", 1)[0]] + floor, err_msg=n)
    windowed = (("conv2_0.conv1_weight", "conv2_1.conv2_weight", "conv3_down.conv_weight")
                if name == "resnet" else
                ("subm1.conv_0_weight", "subm1.conv_1_weight", "down2.conv_weight"))
    for n in windowed:
        assert np.abs(got[n]).max() > 0, n


def test_dfs3_raises_and_names_the_widths():
    """The window engine builds window modules past conv3_down at
    ``dense_from_stage`` 3 (B1 takes 64->64, 64->128 and 128->128 since the
    weights stream through shared memory); what the port still lacks,
    ``engine="column"``, raises and names itself."""
    from sparse2dense_tpu_torch.models.backbones.scn import (WinBasicBlock, WinDownsample,
                                                             WinSubMStage)

    res = SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                            dense_from_stage=3)
    assert isinstance(res.conv3_1, WinBasicBlock) and isinstance(res.conv4_down, WinDownsample)
    second = SpMiddleFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                         dense_from_stage=3)
    assert isinstance(second.subm2, WinSubMStage) and isinstance(second.down3, WinDownsample)
    for cls in (SpMiddleResNetFHD, SpMiddleFHD):
        with pytest.raises(NotImplementedError, match="engine='column'"):
            cls(num_input_features=5, sparse_shape=GRID, engine="column", dense_from_stage=3)


WINDOWS = (128, 256, 384, 512)


def test_window_kernel_takes_32_to_64():
    assert TWK.unsupported(128, 32, 64, 384) is None
    assert TWK.unsupported(128, 32, 64, 512) is None
    assert "window" in TWK.unsupported(128, 32, 64, 640)
    assert "Cout 64" in TWK.unsupported(128, 16, 64, 384)
    assert TWK.smem_bytes(32, 64, 384) + 4096 == 202496


