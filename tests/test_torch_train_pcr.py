"""The training parts against JAX and optax (moved from
``tests/test_torch_train_parts.py``, whose batches they use): the PCR targets
(mean-point grids) and losses, the PCR loss against the reference's folded
layout, the all-dense backbone in training, and the optimizer."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu.models.detectors import kd as jkd
from sparse2dense_tpu.solver.optim import build_optimizer
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones import scn as tscn
from sparse2dense_tpu_torch.models.detectors import kd as tkd
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam

from tests.test_torch_distill import assert_grads_close
from tests.test_torch_layers import eager_cache_fixture, flax_shapes, load, rand_variables
from tests.test_torch_train_parts import REL, batches, t  # noqa: F401 (fixtures)

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


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
    v = rand_variables(flax_shapes(tm))
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
