"""Layers of the PyTorch port against their JAX/Flax references on the same
numpy inputs. Flax variables are drawn at random (seeded) from the module's
variable shapes and carried over with ``convert.from_flax``. float32
throughout; tolerances cover summation order (rtol 1e-4, atol 1e-5)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu.models.heads import center_head as jhead
from sparse2dense_tpu.models.necks import rpn as jrpn
from sparse2dense_tpu.models.necks import s2d_rpn as js2d
from sparse2dense_tpu.models import norm as jnorm
from sparse2dense_tpu.models.readers.pillar_encoder import VoxelFeatureExtractorV3 as JVFE
from sparse2dense_tpu.ops.nms import rotated_nms as j_rotated_nms
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.backbones import scn as tscn
from sparse2dense_tpu_torch.models.heads import center_head as thead
from sparse2dense_tpu_torch.models.necks import rpn as trpn
from sparse2dense_tpu_torch.models.necks import s2d_rpn as ts2d
from sparse2dense_tpu_torch.models import norm as tnorm
from sparse2dense_tpu_torch.models.readers.pillar_encoder import VoxelFeatureExtractorV3 as TVFE
from sparse2dense_tpu_torch.ops.nms import rotated_nms as t_rotated_nms
from sparse2dense_tpu_torch.ops.nms_suppression import rotated_iou

TOL = dict(rtol=1e-4, atol=1e-5)
TASKS = ({"num_class": 3, "class_names": ["VEHICLE", "PEDESTRIAN", "CYCLIST"]},)
HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2)}


def rand_variables(init_fn, seed=0):
    """Flax variables with the shapes ``init_fn()`` would give, drawn from a
    seeded numpy generator: fan-in scaled kernels, BN stats away from 0/1."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith("kernel"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, shapes[k])
            for k in ("params", "batch_stats") if k in shapes}


def load(module, variables):
    module.load_state_dict(from_flax(variables, module))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_batchnorm_eval_and_masked_train():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    mask = rng.rand(2, 5, 6, 1) > 0.4
    jbn = jnorm.BatchNorm()
    v = rand_variables(lambda: jbn.init(jax.random.PRNGKey(0), x))
    tbn = load(tnorm.BatchNorm(4, channel_dim=-1), v)
    with torch.no_grad():
        got = tbn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbn.apply(v, x, use_running_average=True)), **TOL)

    want, upd = jbn.apply(v, x, mask=mask, use_running_average=False, mutable=["batch_stats"])
    tbn.train()
    with torch.no_grad():
        got = tbn(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(), upd["batch_stats"]["mean"], **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(), upd["batch_stats"]["var"], **TOL)
    assert tbn.eps == 1e-3


def test_layernorm2d_and_vfe():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    jln = jnorm.LayerNorm2d()
    v = rand_variables(lambda: jln.init(jax.random.PRNGKey(0), x))
    tln = load(tnorm.LayerNorm2d(8), v)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tln(nchw(x))), np.asarray(jln.apply(v, x)), **TOL)

    vox = rng.randn(2, 10, 5, 5).astype(np.float32)
    npts = rng.randint(0, 6, (2, 10)).astype(np.int32)
    want = JVFE(num_input_features=5).apply({}, vox, npts)
    got = TVFE(num_input_features=5)(torch.from_numpy(vox), torch.from_numpy(npts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _dense_scene(rng, c=4, shape=(1, 6, 7, 8)):
    mask = (rng.rand(*shape, 1) > 0.6).astype(np.float32)
    x = rng.randn(*shape, c).astype(np.float32) * mask
    return x, mask


@pytest.mark.parametrize("kind", ["subm_stage", "basic_block", "down", "down_z"])
def test_dense_stages(kind):
    """dense_subm_conv / dense_strided_conv through the stage modules."""
    rng = np.random.RandomState(2)
    x, mask = _dense_scene(rng)
    if kind == "subm_stage":
        jm, tm = jscn.DenseSubMStage((6,)), tscn.DenseSubMStage(4, (6,))
    elif kind == "basic_block":
        jm, tm = jscn.DenseBasicBlock(4), tscn.DenseBasicBlock(4, 4)
    elif kind == "down":
        jm = jscn.DenseDownsample(6, (2, 2, 2), (1, 1, 1))
        tm = tscn.DenseDownsample(4, 6, (2, 2, 2), (1, 1, 1))
    else:
        jm = jscn.DenseDownsample(6, (2, 1, 1), (0, 0, 0), ksize=(3, 1, 1))
        tm = tscn.DenseDownsample(4, 6, (2, 1, 1), (0, 0, 0), (3, 1, 1))
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x, mask, False))
    tm = load(tm, v)
    want = jm.apply(v, x, mask, False)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
                 torch.from_numpy(np.moveaxis(mask, -1, 1).copy()))
    if kind.startswith("down"):
        np.testing.assert_array_equal(nhwc(got[1]), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_densify_and_bev():
    rng = np.random.RandomState(3)
    grid = (4, 6, 5)
    lin = rng.choice(np.prod(grid), 20, replace=False)
    coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
    coords = np.concatenate([coords, -np.ones((4, 3), np.int32)])[None]
    feats = rng.randn(1, 24, 3).astype(np.float32)
    valid = (coords >= 0).all(-1)
    jd, jm = jscn.densify(jscn.SparseTensor(jnp.asarray(feats), coords, valid), grid)
    td, tm = tscn.densify(torch.from_numpy(feats), torch.from_numpy(coords),
                          torch.from_numpy(valid), grid)
    np.testing.assert_array_equal(np.moveaxis(td.numpy(), 1, -1), np.asarray(jd))
    np.testing.assert_array_equal(np.moveaxis(tm.numpy(), 1, -1), np.asarray(jm))
    np.testing.assert_array_equal(tscn.dense_to_bev(td).numpy(),
                                  np.asarray(jscn.dense_to_bev(jd)))


@pytest.mark.parametrize("kind", ["conv_bn_gelu", "convt_bn_gelu", "convnext", "rpn"])
def test_neck_layers(kind):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 8, 8, 6).astype(np.float32)
    if kind == "conv_bn_gelu":
        jm, tm = js2d.ConvBNGelu(5, kernel=2, stride=2, padding=0), \
            ts2d.ConvBNGelu(6, 5, kernel=2, stride=2, padding=0)
    elif kind == "convt_bn_gelu":
        jm, tm = js2d.ConvTBNGelu(5), ts2d.ConvTBNGelu(6, 5)
    elif kind == "convnext":
        jm, tm = js2d.ConvNeXtBlock(6), ts2d.ConvNeXtBlock(6)
    else:
        cfg = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2), ds_num_filters=(8, 8),
                   us_layer_strides=(1, 2), us_num_filters=(8, 8), num_input_features=6)
        jm, tm = jrpn.RPN(**cfg), trpn.RPN(**cfg)
    args = () if kind == "convnext" else (False,)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x, *args))
    tm = load(tm, v)
    want = np.asarray(jm.apply(v, x, *args))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy() if kind == "rpn" else nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_center_head_and_decode():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 6, 7, 8).astype(np.float32)
    jm = jhead.CenterHead(in_channels=8, tasks=TASKS, common_heads=tuple(sorted(HEADS.items())),
                          share_conv_channel=8)
    tm = thead.CenterHead(in_channels=8, tasks=TASKS, common_heads=HEADS, share_conv_channel=8)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x))
    tm = load(tm, v)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), **TOL, err_msg=k)
    test_cfg = dict(out_size_factor=8, voxel_size=[0.1, 0.1], pc_range=[-75.2, -75.2])
    jb, jh = jhead.decode_preds(want[0], test_cfg)
    tb, th = thead.decode_preds({k: torch.tensor(np.asarray(a)) for k, a in want[0].items()},
                                test_cfg)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_rotated_nms_indices_exact():
    rng = np.random.RandomState(6)
    k = 160
    boxes = np.concatenate([rng.uniform(-10, 10, (k, 2)), rng.uniform(1, 4, (k, 2)),
                            rng.uniform(-np.pi, np.pi, (k, 1))], 1).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    scores[rng.rand(k) < 0.2] = -np.inf
    thr = 0.3
    # no IoU within 1e-4 of the threshold: the two frameworks' float paths
    # cannot then disagree on a suppression
    iou = rotated_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    assert np.abs(iou - thr).min() > 1e-4
    want = np.asarray(j_rotated_nms(jnp.asarray(boxes), jnp.asarray(scores), thr, 40))
    got = t_rotated_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, 40)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10


def test_backbone_dense_from_stage_0():
    """The all-dense branch of the window-engine backbone (the detector test
    covers dense_from_stage=1)."""
    from tests.test_window_conv import _clustered_scene, _pad

    grid = (41, 32, 32)
    feats, coords = _clustered_scene(np.random.RandomState(7), grid, 200)
    feats, coords = _pad(feats[:, :5], coords, 256)
    feats, coords = feats[None], coords[None]
    kw = dict(num_input_features=5, sparse_shape=grid, engine="window", dense_from_stage=0)
    jm, tm = jscn.SpMiddleResNetFHD(**kw), tscn.SpMiddleResNetFHD(**kw)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), feats, coords, False))
    tm = load(tm, v)
    want = np.asarray(jax.jit(lambda v, f, c: jm.apply(v, f, c, False)[0])(v, feats, coords))
    with torch.no_grad():
        bev, _, telemetry = tm(torch.from_numpy(feats), torch.from_numpy(coords))
    assert telemetry == {}
    np.testing.assert_allclose(bev.numpy(), want, **TOL)
