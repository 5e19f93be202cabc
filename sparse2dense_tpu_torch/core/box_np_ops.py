"""Box geometry on the host (NumPy; the box decode also on torch tensors):
the port's copy of ``sparse2dense_tpu/core/box_np_ops.py``. Anchor matching
and the box coder use the first half; the data layer (point-in-box tests,
the augmentations' collision test) the corner functions at the end. For the
same inputs it gives bit-identical arrays.
"""
from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def center_to_minmax_2d(centers, dims):
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def rbbox2d_to_near_bbox(rbboxes):
    """Rotated (x, y, w, l, r) -> nearest axis-aligned (xmin, ymin, xmax,
    ymax): the box with w and l swapped when |r| is nearer pi/2 than 0."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(bboxes_center[:, :2], bboxes_center[:, 2:])


def iou_matrix(boxes, query_boxes, eps=1.0):
    """Axis-aligned 2D IoU matrix (N, K) of (xmin, ymin, xmax, ymax) boxes."""
    boxes = np.asarray(boxes)
    query_boxes = np.asarray(query_boxes)
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=boxes.dtype if n else np.float32)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0]) + eps
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1]) + eps
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    union = area_b + area_q - inter
    return np.where(inter > 0, inter / union, 0.0).astype(boxes.dtype)


def nearest_iou_similarity(boxes1, boxes2):
    """IoU of the nearest axis-aligned boxes of two sets of (x, y, w, l, r)."""
    return iou_matrix(rbbox2d_to_near_bbox(boxes1), rbbox2d_to_near_bbox(boxes2), eps=0.0)


def second_box_encode(boxes, anchors, encode_angle_to_vector=False,
                      smooth_dim=False, norm_velo=False):
    """VoxelNet/SECOND deltas of boxes against anchors, both (N, 7)
    [x y z w l h r] or (N, 9) with vx vy before r."""
    boxes = np.asarray(boxes)
    anchors = np.asarray(anchors)
    nd = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[:, i] for i in range(6))
    xg, yg, zg, wg, lg, hg = (boxes[:, i] for i in range(6))
    ra, rg = anchors[:, -1], boxes[:, -1]

    diag = np.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    if smooth_dim:
        lt, wt, ht = lg / la - 1, wg / wa - 1, hg / ha - 1
    else:
        lt, wt, ht = np.log(lg / la), np.log(wg / wa), np.log(hg / ha)
    ret = [xt, yt, zt, wt, lt, ht]
    if nd > 7:
        vxa, vya = anchors[:, 6], anchors[:, 7]
        vxg, vyg = boxes[:, 6], boxes[:, 7]
        if norm_velo:
            ret += [(vxg - vxa) / diag, (vyg - vya) / diag]
        else:
            ret += [vxg - vxa, vyg - vya]
    if encode_angle_to_vector:
        ret += [np.cos(rg) - np.cos(ra), np.sin(rg) - np.sin(ra)]
    else:
        ret += [rg - ra]
    return np.stack(ret, axis=-1)


def second_box_decode(encodings, anchors, encode_angle_to_vector=False,
                      smooth_dim=False, norm_velo=False, xp=np):
    """Inverse of :func:`second_box_encode` over any leading axes. ``xp`` is
    ``numpy`` or ``torch`` (the functions used exist under the same names
    in both)."""
    nd = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    ra = anchors[..., -1]
    xt, yt, zt, wt, lt, ht = (encodings[..., i] for i in range(6))

    diag = xp.sqrt(la ** 2 + wa ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
    else:
        lg, wg, hg = xp.exp(lt) * la, xp.exp(wt) * wa, xp.exp(ht) * ha
    ret = [xg, yg, zg, wg, lg, hg]
    off = 6
    if nd > 7:
        vxa, vya = anchors[..., 6], anchors[..., 7]
        vxt, vyt = encodings[..., 6], encodings[..., 7]
        if norm_velo:
            ret += [vxt * diag + vxa, vyt * diag + vya]
        else:
            ret += [vxt + vxa, vyt + vya]
        off = 8
    if encode_angle_to_vector:
        rtx, rty = encodings[..., off], encodings[..., off + 1]
        rg = xp.arctan2(rty + xp.sin(ra), rtx + xp.cos(ra))
    else:
        rg = encodings[..., off] + ra
    ret.append(rg)
    return xp.stack(ret, -1)


def create_anchors_3d_range(feature_size, anchor_range, sizes=(1.6, 3.9, 1.56),
                            rotations=(0, np.pi / 2), velocities=None,
                            dtype=np.float32):
    """(D, H, W) feature grid -> (D, H, W, n_size, n_rot, 7 | 9) anchors at
    the cell centres of ``anchor_range``."""
    anchor_range = np.asarray(anchor_range, dtype)
    stride = (anchor_range[3] - anchor_range[0]) / feature_size[2]
    z_centers = np.linspace(anchor_range[2], anchor_range[5], feature_size[0], dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], feature_size[1],
                            endpoint=False, dtype=dtype) + stride / 2
    x_centers = np.linspace(anchor_range[0], anchor_range[3], feature_size[2],
                            endpoint=False, dtype=dtype) + stride / 2
    rotations = np.asarray(rotations, dtype)
    sizes = np.reshape(np.asarray(sizes, dtype), [-1, 3])
    if velocities is not None:
        velocities = np.asarray(velocities, dtype).reshape([-1, 2])
        combines = np.hstack([sizes, velocities])
    else:
        combines = sizes

    xs, ys, zs, rs = np.meshgrid(x_centers, y_centers, z_centers, rotations, indexing="ij")
    n_size = combines.shape[0]
    base = np.stack([xs, ys, zs], axis=-1)  # (X, Y, Z, R, 3)
    base = np.tile(base[:, :, :, None, :, :], (1, 1, 1, n_size, 1, 1))
    rot = np.tile(rs[:, :, :, None, :, None], (1, 1, 1, n_size, 1, 1))
    comb = np.broadcast_to(combines[None, None, None, :, None, :],
                           base.shape[:5] + (combines.shape[-1],))
    ret = np.concatenate([base, comb, rot], axis=-1)  # (X, Y, Z, S, R, nd)
    return np.transpose(ret, [2, 1, 0, 3, 4, 5])  # -> (Z, Y, X, S, R, nd)


def rotation_2d(points, angles):
    """(N, P, 2) points rotated by (N,) angles (counterclockwise)."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rot_mat_T = np.stack([[rot_cos, -rot_sin], [rot_sin, rot_cos]])  # (2, 2, N)
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def corners_nd(dims, origin=0.5):
    """(N, ndim) dims -> (N, 2**ndim, ndim) corners around origin."""
    ndim = dims.shape[1]
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.asarray(origin, dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, -1, ndim)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def rotation_3d_in_axis(points, angles, axis=2):
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    if axis == 2:
        rot_mat_T = np.stack([[rot_cos, -rot_sin, zeros], [rot_sin, rot_cos, zeros],
                              [zeros, zeros, ones]])
    elif axis == 1:
        rot_mat_T = np.stack([[rot_cos, zeros, -rot_sin], [zeros, ones, zeros],
                              [rot_sin, zeros, rot_cos]])
    else:
        rot_mat_T = np.stack([[ones, zeros, zeros], [zeros, rot_cos, -rot_sin],
                              [zeros, rot_sin, rot_cos]])
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.5), axis=2):
    """(N, 3) centers + dims + yaw -> (N, 8, 3) corners; the det3d lidar
    convention is origin (0.5, 0.5, 0.5) (the gravity centre), yaw about z."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape(-1, 1, 3)


def points_in_rbbox(points, rbbox, origin=(0.5, 0.5, 0.5)):
    """Boolean (n_points, n_boxes): which points lie in which rotated 3D box
    (rbbox (N, 7) [x y z w l h yaw], the gravity centre)."""
    n_box = rbbox.shape[0]
    n_pts = points.shape[0]
    if n_box == 0 or n_pts == 0:
        return np.zeros((n_pts, n_box), dtype=bool)
    shifted = points[None, :, :3] - rbbox[:, None, :3]  # (N, P, 3), in each box's frame
    cos, sin = np.cos(-rbbox[:, 6]), np.sin(-rbbox[:, 6])
    lx = shifted[..., 0] * cos[:, None] - shifted[..., 1] * sin[:, None]
    ly = shifted[..., 0] * sin[:, None] + shifted[..., 1] * cos[:, None]
    lz = shifted[..., 2]
    half = rbbox[:, 3:6] / 2  # (N, 3) w l h
    inside = ((np.abs(lx) <= half[:, None, 0]) & (np.abs(ly) <= half[:, None, 1])
              & (np.abs(lz) <= half[:, None, 2]))
    return inside.T  # (P, N)
