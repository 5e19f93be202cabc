"""The center head and its decode, the rotated NMS and the all-dense backbone
against the reference's (``tests/test_torch_layers.py``'s variables)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu.models.heads import center_head as jhead
from sparse2dense_tpu.ops.nms import rotated_nms as j_rotated_nms
from sparse2dense_tpu_torch.models.backbones import scn as tscn
from sparse2dense_tpu_torch.models.heads import center_head as thead
from sparse2dense_tpu_torch.ops.nms import rotated_nms as t_rotated_nms
from sparse2dense_tpu_torch.ops.nms_suppression import rotated_iou

from tests.test_torch_layers import HEADS, TASKS, TOL, load, rand_variables


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
