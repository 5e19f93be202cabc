"""The training slice's parts against JAX on the same numpy inputs: the
training batch (targets and distillation streams, bit-exact), the CenterNet
losses, ``center_head_loss``, the PCR targets and losses, the PCR
generators in training (against the reference's z-folded outputs,
unfolded: channel d*C + c), the window-engine backbone in training with
every stage dense, and the optimizer against optax over 10 one-cycle
steps. float32; tolerances per test."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu.models.detectors import kd as jkd
from sparse2dense_tpu.models.heads import center_head as jhead
from sparse2dense_tpu.models.losses import centernet as jloss
from sparse2dense_tpu.models.necks import s2d_rpn as js2d
from sparse2dense_tpu.solver.optim import build_optimizer
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones import scn as tscn
from sparse2dense_tpu_torch.models.detectors import kd as tkd
from sparse2dense_tpu_torch.models.heads import center_head as thead
from sparse2dense_tpu_torch.models.losses import centernet as tloss
from sparse2dense_tpu_torch.models.necks import s2d_rpn as ts2d
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import assert_grads_close
from tests.test_torch_layers import load, rand_variables

CFG = "configs/tests/distill_tiny.py"
FRAME = dict(max_voxels=256, n_points=1500, n_obj=5, seed=3)
REL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def batches():
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    return (jax_make_batch(jcfg, 2, distillation=True, **FRAME),
            make_batch(tcfg, 2, device="cpu", with_targets=True, distillation=True, **FRAME))


def t(x):
    return torch.from_numpy(np.array(x))


def test_make_batch_bit_exact(batches):
    jb, tb = batches
    assert sorted(jb) == sorted(tb)
    for key, want in jb.items():
        for w, g in zip(want, tb[key]) if isinstance(want, list) else [(want, tb[key])]:
            w = np.asarray(w)
            assert g.dtype == t(w).dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    assert np.asarray(jb["mask"][0]).sum(1).min() > 0     # both samples have objects
    assert np.asarray(jb["hm"][0]).shape == (2, 4, 4, 3)


def _maps(rng, b, h, w, c):
    return rng.randn(b, h, w, c).astype(np.float32)


def test_centernet_losses(batches):
    jb, _ = batches
    rng = np.random.RandomState(0)
    ind, mask, cat = (np.asarray(jb[k][0]) for k in ("ind", "mask", "cat"))
    out = 1 / (1 + np.exp(-_maps(rng, 2, 4, 4, 3)))
    target = np.asarray(jb["hm"][0])
    want = jloss.fast_focal_loss(jnp.asarray(out), jnp.asarray(target), ind, mask, cat)
    got = tloss.fast_focal_loss(t(out), t(target), t(ind), t(mask), t(cat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)
    no_obj = np.zeros_like(mask)   # the num_pos == 0 branch
    np.testing.assert_allclose(
        tloss.fast_focal_loss(t(out), t(target), t(ind), t(no_obj), t(cat)).numpy(),
        np.asarray(jloss.fast_focal_loss(jnp.asarray(out), jnp.asarray(target), ind, no_obj,
                                         cat)), **REL)
    reg = _maps(rng, 2, 4, 4, 8)
    box = np.asarray(jb["anno_box"][0])[..., :8]
    np.testing.assert_allclose(tloss.reg_loss(t(reg), t(mask), t(ind), t(box)).numpy(),
                               np.asarray(jloss.reg_loss(jnp.asarray(reg), mask, ind, box)),
                               **REL)


def test_center_head_loss(batches):
    jb, tb = batches
    rng = np.random.RandomState(1)
    preds = [{k: _maps(rng, 2, 4, 4, c) for k, c in
              (("hm", 3), ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2))}]
    kw = dict(weight=2.0, code_weights=(1.0, 0.5, 1.0, 2.0, 1.0, 1.0, 0.25, 1.0))
    want, wlogs = jhead.center_head_loss([{k: jnp.asarray(v) for k, v in preds[0].items()}], jb,
                                         **kw)
    got, logs = thead.center_head_loss([{k: t(v) for k, v in preds[0].items()}], tb, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **REL)
    assert sorted(logs) == sorted(wlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].numpy(), np.asarray(wlogs[k]), **REL, err_msg=k)


def test_pcr_targets_and_losses(batches):
    jb, tb = batches
    rng = np.random.RandomState(2)
    rng_full = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
    for tag, shape in (("2", (20, 16, 16)), ("4", (10, 8, 8))):
        args = [f"reconstruction_{p}_{tag}" for p in ("voxels", "num_points", "coordinates")]
        want = jkd.rasterize_mean_points(*(jb[a] for a in args), shape)
        got = tkd.rasterize_mean_points(*(tb[a] for a in args), shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)
        assert int((np.asarray(want).sum(-1) != 0).sum()) > 20
        grid = tkd.world_grid(shape, rng_full)
        np.testing.assert_allclose(grid.numpy(), np.asarray(jkd.world_grid(shape, rng_full)),
                                   **REL)
        off, msk = rng.randn(2, *shape, 3).astype(np.float32), rng.randn(2, *shape, 1).astype(
            np.float32)
        wl = jkd.mask_offset_loss(jnp.asarray(off), jnp.asarray(msk), want, jnp.asarray(grid))
        gl = tkd.mask_offset_loss(t(off), t(msk), got, grid)
        np.testing.assert_allclose([float(x) for x in gl], [float(x) for x in wl], **REL)


def test_pcr_loss_against_the_folded_reference(batches):
    """KD_VoxelNet.pcr_loss on NCDHW generator outputs against the
    reference's z-folded one on the same values."""
    jb, tb = batches
    rng = np.random.RandomState(4)
    jout, tout = {}, {}
    for tag, (d, h, w) in (("2", (20, 16, 16)), ("4", (10, 8, 8))):
        for name, c in (("offset", 3), ("mask", 1)):
            x = rng.randn(2, c, d, h, w).astype(np.float32)
            tout[f"gen_{name}_{tag}"] = t(x)
            # NCDHW -> folded (B, H, W, D*C), channel d*C + c
            jout[f"gen_{name}_{tag}"] = jnp.asarray(
                np.transpose(x, (0, 3, 4, 2, 1)).reshape(2, h, w, d * c))
    rng_full = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)
    jm = jkd.KD_VoxelNet(None, None, None, None, pc_range_full=rng_full)
    tm = tkd.KD_VoxelNet(torch.nn.Identity(), torch.nn.Identity(), torch.nn.Identity(),
                         torch.nn.Identity(), pc_range_full=rng_full)
    want = jm.pcr_loss(jout, jb)
    got = tm.pcr_loss(tout, tb)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], **REL)


NECK = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2), ds_num_filters=(16, 16),
            us_layer_strides=(1, 2), us_num_filters=(16, 16), num_input_features=24)


def test_s2d_rpn_train_pcr_generators():
    """Training forward of S2D_RPN (PCR generators in 5D) against the
    reference's folded generators, unfolded; and the BN statistics."""
    x = np.random.RandomState(5).randn(2, 8, 8, 24).astype(np.float32)
    jm, tm = js2d.S2D_RPN(**NECK), ts2d.S2D_RPN(**NECK)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x, True))
    tm = load(tm, v).train()
    want, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        got = tm(t(x))
    assert got[1].shape == (2, 3, 20, 32, 32) and got[4].shape == (2, 1, 10, 16, 16)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if g.dim() == 5:   # folded (B, H, W, D*C) -> (B, C, D, H, W)
            b, c, d, h, ww = g.shape
            w = np.transpose(w.reshape(b, h, ww, d, c), (0, 4, 3, 1, 2))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=str(i))
    stats = from_flax({"batch_stats": mutated["batch_stats"]}, tm)
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), **REL, err_msg=k)


def test_backbone_train_all_dense():
    """The window-engine backbone in training with every stage dense
    (``dense_from_stage=0``): the BEV map, the BN statistics and the
    gradient of a random projection of the map (tolerance as in the
    distillation test, which covers ``dense_from_stage=1``)."""
    from tests.test_window_conv import _clustered_scene, _pad

    grid = (41, 32, 32)
    feats, coords = _clustered_scene(np.random.RandomState(8), grid, 150)
    feats, coords = _pad(feats[:, :5], coords, 192)
    feats, coords = feats[None], coords[None]
    kw = dict(num_input_features=5, sparse_shape=grid, engine="window", dense_from_stage=0)
    jm, tm = jscn.SpMiddleResNetFHD(**kw), tscn.SpMiddleResNetFHD(**kw)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), feats, coords, False))
    tm = load(tm, v).train()
    proj = np.random.RandomState(9).randn(1, 4, 4, 256).astype(np.float32)

    def jfun(params):
        (bev, _), mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, feats,
                                 coords, True, mutable=["batch_stats"])
        return jnp.sum(bev * proj), (bev, mut["batch_stats"])

    (_, (want, bs)), grads = jax.jit(jax.value_and_grad(jfun, has_aux=True))(v["params"])
    bev, _, _ = tm(t(feats), t(coords))
    (bev * t(proj)).sum().backward()
    np.testing.assert_allclose(bev.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    stats, jgrads = from_flax({"batch_stats": bs}, tm), from_flax({"params": grads}, tm)
    for k, val in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(val.numpy(), stats[k].numpy(), **REL, err_msg=k)
    assert_grads_close({n: p.grad.numpy() for n, p in tm.named_parameters()}, jgrads)


def test_optimizer_matches_optax():
    """Clip, Adam with the one-cycle b1 and lr, decoupled decay: 10 steps
    against the reference's optax chain, clipping on every other step."""
    ocfg = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True)
    lcfg = dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85], div_factor=10.0,
                pct_start=0.3)
    rng = np.random.RandomState(6)
    shapes = [(5, 3), (7,), (2, 3, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = build_optimizer(ocfg, lcfg, 10, grad_clip=dict(max_norm=35))
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt = OneCycleAdam(tp, ocfg, lcfg, 10, grad_clip=dict(max_norm=35))
    for step in range(10):
        grads = [(rng.randn(*s) * (30.0 if step % 2 else 0.5)).astype(np.float32)
                 for s in shapes]
        jg = {str(i): jnp.asarray(g) for i, g in enumerate(grads)}
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = t(g)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)), rtol=1e-6)
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[str(i)]), rtol=0,
                                       atol=1e-6, err_msg=f"step {step}")
