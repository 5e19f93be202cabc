"""The window engine at ``dense_from_stage=2``: the conv2 stage (blocks or
SECOND's subm1) and the strided conv to stage 3 on windowed convs, on both
backbones, against the port's gather engine at ``dense_from_stage=2`` (held
against JAX by ``tests/test_torch_gather_engine.py`` and
``tests/test_torch_second.py``) with the same weights, in eval and in train
mode: the BEV within 1e-4 of its largest value, BN running statistics
within 1e-5, the gradients of sum(BEV^2) within 1e-3 of their module's
largest. The tiny frame's residual rows fit every plan's budget, so the
window engine is exact. Also: per-stage plan windows (a 4-tuple
``win_window``) as the reference's ``_stage_windows`` assigns them, and the
window pass at Cin 32 -> Cout 64 (conv3_down's width) on the card."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones.scn import _stage_windows
from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.models.backbones.scn import (SpMiddleFHD, SpMiddleResNetFHD,
                                                         WinBasicBlock, WinDownsample,
                                                         WinSubMStage)
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

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
def runs(frame):
    """(backbone, train) -> (window module, window run, gather run), each
    run once for the module."""
    cache = {}

    def get(name, train):
        if (name, train) not in cache:
            cls = BACKBONES[name]
            weights = seeded_weights(cls(num_input_features=5, sparse_shape=GRID), 40)
            win_mod, win = run_backbone(cls, "window", weights, *frame, train)
            _, gather = run_backbone(cls, "gather", weights, *frame, train)
            cache[name, train] = win_mod, win, gather
        return cache[name, train]
    return get


@pytest.fixture(params=[(b, t) for b in BACKBONES for t in (False, True)],
                ids=lambda p: f"{p[0]}-{'train' if p[1] else 'eval'}")
def engines(request, runs):
    """(backbone, train, window module, window run, gather run)."""
    name, train = request.param
    return (name, train) + runs(name, train)


def test_dfs2_modules(engines):
    """The conv2 stage and the strided conv after it are the window engine's."""
    name, _, mod, _, _ = engines
    if name == "resnet":
        assert isinstance(mod.conv2_0, WinBasicBlock) and isinstance(mod.conv3_down,
                                                                     WinDownsample)
        assert not isinstance(mod.conv3_0, WinBasicBlock)
    else:
        assert isinstance(mod.subm1, WinSubMStage) and isinstance(mod.down2, WinDownsample)
        assert not isinstance(mod.subm2, WinSubMStage)


def test_dfs2_residual_rows_within_budget(engines):
    name, _, _, win, _ = engines
    tele = win["telemetry"]
    want = ({"conv1", "conv2_down", "conv2", "conv3_down"} if name == "resnet"
            else {"subm0", "down1", "subm1", "down2"})
    assert set(tele) == want
    for key, (counts, budget) in tele.items():
        assert int(counts.max()) <= budget, key


def test_dfs2_bev_matches_gather(engines):
    _, _, _, win, gather = engines
    want = gather["bev"]
    assert win["bev"].shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(win["bev"], want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_dfs2_batchnorm_statistics_match_gather(engines):
    _, _, _, win, gather = engines
    for k, v in gather["stats"].items():
        np.testing.assert_allclose(win["stats"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


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
    for cls, widths in ((SpMiddleResNetFHD, ("64->64", "64->128", "128->128")),
                        (SpMiddleFHD, ("64->64",))):
        with pytest.raises(NotImplementedError, match="dense_from_stage=3") as err:
            cls(num_input_features=5, sparse_shape=GRID, engine="window", dense_from_stage=3)
        assert all(w in str(err.value) for w in widths)


WINDOWS = (128, 256, 384, 512)


def test_stage_windows_as_the_reference(frame, monkeypatch):
    """A 4-tuple ``win_window``: each stage's plans take the reference's
    ``_stage_windows`` entry (conv1 0, conv2_down and conv2 1, conv3_down
    2), and each subm plan equals JAX's plan at that window."""
    wins = _stage_windows(WINDOWS)
    subm, strided = [], []
    make_subm, make_strided = TWC.make_subm_plan_presorted, TWC.make_strided_plan

    def rec_subm(lin, coords, grid, **kw):
        subm.append((lin, coords, tuple(grid), kw["window"]))
        return make_subm(lin, coords, grid, **kw)

    def rec_strided(*args, **kw):
        strided.append(kw["window"])
        return make_strided(*args, **kw)

    monkeypatch.setattr(TWC, "make_subm_plan_presorted", rec_subm)
    monkeypatch.setattr(TWC, "make_strided_plan", rec_strided)
    mod = SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                            dense_from_stage=2, win_window=WINDOWS)
    mod.load_state_dict(seeded_weights(mod, 41))
    with torch.no_grad():
        mod.eval()(*frame)
    assert mod.wins == wins
    assert [w for *_, w in subm] == [wins[0]] * 2 + [wins[1]] * 2   # a plan a sample
    assert strided == [wins[1]] * 2 + [wins[2]] * 2
    for lin, coords, grid, window in (subm[0], subm[2]):
        jp = JWC.make_subm_plan_presorted(jnp.asarray(lin.numpy()), jnp.asarray(coords.numpy()),
                                          grid, window=window)
        tp = make_subm(lin, coords, grid, window=window)
        for field in ("ws", "kbase", "resid_rows", "n_resid"):
            np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                          np.asarray(getattr(jp, field)), err_msg=field)
    with pytest.raises(ValueError, match="4 per-stage windows"):
        SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                          win_window=(384, 384))


def test_window_kernel_takes_32_to_64():
    assert TWK.unsupported(128, 32, 64, 384) is None
    assert TWK.unsupported(128, 32, 64, 512) is None
    assert "window" in TWK.unsupported(128, 32, 64, 640)
    assert "Cout 64" in TWK.unsupported(128, 16, 64, 384)
    assert TWK.smem_bytes(32, 64, 384) + 4096 == 202496


@pytest.mark.cuda
def test_window_pass_cuda_32_to_64_matches_plain(frame):
    """The CUDA kernel at Cin 32 -> Cout 64 on a strided plan against its
    plain version on bf16-rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, coords = frame
    c = coords[0].cuda()
    lin = TWC.yxz_lin(c, GRID)
    order = torch.argsort(lin, stable=True)
    c, lin = c[order], lin[order]
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g_out = (13, 16, 16)
    oc, ol = TWC.downsample_active_set_yxz(c, (c >= 0).all(-1), GRID, g_out, *down,
                                           c.shape[0])
    plan = TWC.make_strided_plan(lin, ol, oc, GRID, g_out, *down, window=128,
                                 resid_budget=c.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn((c.shape[0], 32), device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn((27, 32, 64), device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    got = TWK.window_pass(f, plan, w)
    want = TWC.window_pass_plain(f.float(), plan, w.float())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
