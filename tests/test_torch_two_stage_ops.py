"""The two-stage detector's plain ops against JAX on the CPU: the 3D IoU,
the BEV gather and its sample points, the canonical targets and the
decoded boxes, and the proposal targets given JAX's own draws.

Inputs are made from seeded numpy generators; both packages get the same
arrays. JAX runs these small functions op by op, as the port does: jitted,
XLA rewrites the divisions by the constant voxel size and stride as
products and fuses the clip's arithmetic, an ulp of a coordinate apart
(up to 3.7e-6 of the IoU from its float64 value on the IoU test's boxes,
where the port and eager JAX stay within 1.2e-7 of it; the gather's
weights alike). Tolerances: the IoU, the gather, the sample points, the targets
and the decoded boxes 1e-6; the sampled indices bit-equal."""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.roi_heads import roi_head as jroi
from sparse2dense_tpu.models.second_stage import bev as jbev
from sparse2dense_tpu.ops.iou3d import boxes_iou3d as jiou
from sparse2dense_tpu_torch.models.roi_heads import roi_head as troi
from sparse2dense_tpu_torch.models.second_stage import bev as tbev
from sparse2dense_tpu_torch.ops.iou3d import boxes_iou3d

from tests.test_torch_layers import eager_cache_fixture  # and one torch thread

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached

TOL = dict(rtol=0, atol=1e-6)
TARGET_CONFIG = dict(ROI_PER_IMAGE=16, FG_RATIO=0.5, REG_FG_THRESH=0.55, CLS_FG_THRESH=0.75,
                     CLS_BG_THRESH=0.25, CLS_BG_THRESH_LO=0.1, HARD_BG_RATIO=0.8)


def _boxes(rng, n, spread=6.0):
    xyz = rng.uniform(-spread, spread, (n, 3)) * np.array([1, 1, 0.2])
    dims = rng.uniform(0.5, 4.0, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xyz, dims, yaw], 1).astype(np.float32)


def _near(rng, gt, n, jitter, rows=None):
    """``n`` boxes jittered around random rows of ``gt`` (or ``rows``)."""
    pick = gt[rng.randint(0, len(gt), n) if rows is None else rows]
    noise = rng.normal(0, 1, pick.shape) * np.array([jitter, jitter, jitter / 2, jitter / 2,
                                                     jitter / 2, jitter / 2, jitter])
    out = pick + noise.astype(np.float32)
    out[:, 3:6] = np.abs(out[:, 3:6]) + 0.1
    return out.astype(np.float32)


def test_boxes_iou3d_against_jax():
    """Random pairs, a box with itself, disjoint boxes, boxes apart in z
    only, and a box inside another; then a batch of (B, R, G) matrices in
    one call equals its samples one by one; the port within 2e-7 of its
    own float64 IoU."""
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 24), _boxes(rng, 17)
    base = np.array([[0, 0, 0, 4, 2, 2, 0.3]], np.float32)
    special = np.concatenate([
        base,                                                    # identical
        base + np.array([[20, 20, 0, 0, 0, 0, 0]], np.float32),  # disjoint in BEV
        base + np.array([[0, 0, 5, 0, 0, 0, 0]], np.float32),    # disjoint in z only
        base * np.array([[1, 1, 1, 0.5, 0.5, 0.5, 1]], np.float32),  # contained
    ])
    a = np.concatenate([a, special])
    b = np.concatenate([b, base])
    want = np.asarray(jiou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    exact = boxes_iou3d(torch.from_numpy(a).double(), torch.from_numpy(b).double()).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-7)
    last = got[-4:, -1]
    np.testing.assert_allclose(last, [1.0, 0.0, 0.0, 0.125], atol=1e-6)
    batched = boxes_iou3d(torch.from_numpy(np.stack([a[:20], a[-20:]])),
                          torch.from_numpy(np.stack([b, b[::-1].copy()])))
    for i, (x, y) in enumerate(((a[:20], b), (a[-20:], b[::-1].copy()))):
        np.testing.assert_array_equal(batched[i].numpy(), boxes_iou3d(
            torch.from_numpy(x), torch.from_numpy(y)).numpy())


def test_bev_gather_against_jax():
    """``box_centers`` and ``BEVFeatureExtractor`` (the bilinear gather,
    the last row and column's clamp) on an NHWC view of an NCHW map, as the
    neck gives it: points inside, on the last row and column, and outside
    the map."""
    rng = np.random.RandomState(1)
    nchw = rng.randn(2, 6, 9, 11).astype(np.float32)
    boxes = np.stack([np.concatenate([_boxes(rng, 7, spread=4.0),
                                      np.array([[5.5, 3.5, 0, 1, 1, 1, 0],
                                                [-9, 9, 0, 1, 1, 1, 0.2]], np.float32)])
                      for _ in range(2)])
    kw = dict(pc_start=(-5.5, -4.5), voxel_size=(0.5, 0.5), out_stride=2)
    nhwc = np.transpose(nchw, (0, 2, 3, 1))
    for num_point in (1, 5):
        check_bev_gather(boxes, nchw, nhwc, kw, num_point)


def check_bev_gather(boxes, nchw, nhwc, kw, num_point):
    jcent = jbev.box_centers(jnp.asarray(boxes), num_point)
    jfeat = jbev.BEVFeatureExtractor(**kw).apply({}, jnp.asarray(nhwc), jcent, num_point)
    tcent = tbev.box_centers(torch.from_numpy(boxes), num_point)
    view = torch.from_numpy(nchw).permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    tfeat = tbev.BEVFeatureExtractor(**kw)(view, tcent, num_point)
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), **TOL)
    assert tfeat.shape == (2, 9, 6 * num_point)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), **TOL)


def test_canonical_targets_and_predicted_boxes_against_jax():
    """The matched gt in each RoI's frame (headings on both sides of every
    flip) and the deltas decoded back, and the round trip of zero deltas."""
    rng = np.random.RandomState(2)
    rois = _boxes(rng, 64)[None].repeat(2, 0)
    rois[1, :, 6] += rng.choice([-2 * np.pi, 2 * np.pi, np.pi], 64).astype(np.float32)
    gts = _near(rng, rois[0], 64, 0.8)[None].repeat(2, 0)
    gts[:, :, 6] = rng.uniform(-2 * np.pi, 2 * np.pi, (2, 64))
    deltas = (rng.randn(2, 64, 7) * 0.3).astype(np.float32)
    want_ct = np.asarray(jroi.canonical_targets(jnp.asarray(rois), jnp.asarray(gts)))
    want_pb = np.asarray(jroi.generate_predicted_boxes(jnp.asarray(rois), jnp.asarray(deltas)))
    t_rois = torch.from_numpy(rois)
    np.testing.assert_allclose(troi.canonical_targets(t_rois, torch.from_numpy(gts)).numpy(),
                               want_ct, **TOL)
    np.testing.assert_allclose(
        troi.generate_predicted_boxes(t_rois, torch.from_numpy(deltas)).numpy(), want_pb,
        **TOL)
    back = troi.generate_predicted_boxes(t_rois, torch.zeros(2, 64, 7))
    np.testing.assert_allclose(back.numpy(), rois, atol=1e-5)


def test_proposal_targets_against_jax():
    """``proposal_target_layer`` (and so ``subsample_rois``) given JAX's
    own draws, ``jax.random.uniform(key_b, (R,))`` for each sample's key:
    the sampled indices bit-equal, the targets within 1e-6 (the soft IoU
    labels in IoU units). The fixture
    fills every group (foreground, hard and easy background, invalid RoIs,
    padded and other-class gt slots), and a second sample with a short easy
    background makes the hard background back-fill."""
    rng = np.random.RandomState(3)
    b, r, g = 2, 48, 8
    gt = np.zeros((b, g, 8), np.float32)
    rois = np.zeros((b, r, 7), np.float32)
    labels = rng.randint(1, 4, (b, r)).astype(np.int32)
    for i in range(b):
        n_gt = 6 - i
        gt[i, :n_gt, :7] = _boxes(rng, n_gt)
        gt[i, :n_gt, 7] = rng.randint(1, 4, n_gt)
        # 16 close RoIs of their gt's class; then jittered ones, of random
        # classes in sample 0 (many easy), of their gt's class and closer in
        # sample 1 (mostly hard); sample 0 also has far-away RoIs
        rows = rng.randint(0, n_gt, r)
        n_far = 14 if i == 0 else 1
        rois[i] = np.concatenate([
            _near(rng, gt[i, :n_gt, :7], 16, 0.05, rows[:16]),
            _near(rng, gt[i, :n_gt, :7], r - 16 - n_far, 0.6 if i == 0 else 0.25,
                  rows[16:r - n_far]),
            _boxes(rng, n_far) + np.float32(40.0) * np.array([1, 1, 0, 0, 0, 0, 0],
                                                             np.float32)])
        labels[i, :r - n_far] = gt[i, rows[:r - n_far], 7]
        if i == 0:
            labels[i, 16:] = rng.randint(1, 4, r - 16)
    valid = rng.rand(b, r) > 0.1
    batch = dict(rois=rois, roi_labels=labels, roi_scores=rng.rand(b, r).astype(np.float32),
                 roi_valid=valid, roi_features=rng.randn(b, r, 5).astype(np.float32),
                 gt_boxes_and_cls=gt)
    key = jax.random.PRNGKey(7)
    want = jroi.proposal_target_layer({k: jnp.asarray(v) for k, v in batch.items()},
                                      TARGET_CONFIG, key)
    draws = np.stack([np.asarray(jax.random.uniform(k, (r,))) for k in jax.random.split(key, b)])
    got = troi.proposal_target_layer({k: torch.from_numpy(v) for k, v in batch.items()},
                                     TARGET_CONFIG, torch.from_numpy(draws))
    # the sampled RoIs are the rows of the JAX sample: the indices, bit-equal
    idx = got["index"].numpy()
    for i in range(b):
        rows = [int(np.flatnonzero((rois[i] == w).all(1))[0]) for w in np.asarray(want["rois"][i])]
        np.testing.assert_array_equal(idx[i], rows)
    for k in ("roi_labels", "roi_scores", "roi_features"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["reg_valid_mask"].numpy(),
                                  np.asarray(want["reg_valid_mask"]))
    # within 1e-6, and within 1e-6 of their size past 1 (float32's 24 bits:
    # a far-away RoI's canonical target, against gt slot 0, is ~40 m)
    np.testing.assert_allclose(got["gt_of_rois"].numpy(), np.asarray(want["gt_of_rois"]),
                               rtol=1e-6, atol=1e-6)
    # the soft labels are the sampled IoUs stretched by 1 / (FG - BG) = 2:
    # held in IoU units (the two packages' IoUs differ by up to 6e-7 here,
    # XLA's sin and cos against torch's; both are ~1e-6 from float64)
    stretch = TARGET_CONFIG["CLS_FG_THRESH"] - TARGET_CONFIG["CLS_BG_THRESH"]
    np.testing.assert_allclose(got["rcnn_cls_labels"].numpy() * stretch,
                               np.asarray(want["rcnn_cls_labels"]) * stretch, **TOL)
    labels_s = got["rcnn_cls_labels"].numpy()
    assert (labels_s == 1).any() and (labels_s == 0).any() and \
        ((labels_s > 0) & (labels_s < 1)).any()
    ov = troi.max_iou_with_same_class(torch.from_numpy(rois), torch.from_numpy(labels),
                                      torch.from_numpy(gt[..., :7]),
                                      torch.from_numpy(gt[..., 7].astype(np.int32)))[0].numpy()
    m = TARGET_CONFIG["ROI_PER_IMAGE"]
    for i, short in ((0, False), (1, True)):
        fg = ((ov[i] >= 0.55) & valid[i]).sum()
        easy = ((ov[i] < 0.1) & valid[i]).sum()
        bg = m - min(fg, m // 2)
        assert (easy < bg - int(bg * 0.8)) == short, (i, fg, easy)
