"""Rotated BEV box IoU on host tensors: the port's copy of
``sparse2dense_tpu/ops/rotated_iou.py`` in plain PyTorch (the evaluator's
box matching; the reference runs it as jitted JAX on the host). The
rect-rect intersection is a Sutherland-Hodgman clip whose polygon ring is a
Python list of per-slot coordinate tensors, every op elementwise over the
broadcast pair shape:

- a clip doubles the slot list (4 -> 8 -> 16 -> 32 -> 64); duplicate
  vertices are allowed (zero-length edges clip correctly), and invalid slots
  are refilled from their circular predecessor with log2(n) selects;
- the area is the shoelace sum over the final slots (duplicates add 0).

Boxes are BEV rects ``(cx, cy, dx, dy, heading)``, columns [0, 1, 3, 4, 6]
of a 7-dof box.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _corner_slots(boxes):
    """(..., 5) rects -> their 4 CCW corners as ([x0..x3], [y0..y3])."""
    cx, cy, dx, dy, ang = boxes.unbind(-1)
    c, s = torch.cos(ang), torch.sin(ang)
    xs, ys = [], []
    for ux, uy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
        lx = 0.5 * ux * dx
        ly = 0.5 * uy * dy
        xs.append(cx + lx * c - ly * s)
        ys.append(cy + lx * s + ly * c)
    return xs, ys


def _fill_from_predecessor(xs, ys, valid):
    """Refill invalid slots from the nearest valid circular predecessor."""
    n = len(xs)
    k = 1
    while k < n:
        nxs, nys, nvalid = [], [], []
        for i in range(n):
            j = (i - k) % n
            take = (~valid[i]) & valid[j]
            nxs.append(torch.where(take, xs[j], xs[i]))
            nys.append(torch.where(take, ys[j], ys[i]))
            nvalid.append(valid[i] | valid[j])
        xs, ys, valid = nxs, nys, nvalid
        k *= 2
    return xs, ys


def _clip_halfplane(xs, ys, alive, ax, ay, bx, by):
    """Clip the duplicate-ring polygons by the half-plane left of a->b."""
    n = len(xs)
    ex, ey = bx - ax, by - ay
    d = [ex * (ys[i] - ay) - ey * (xs[i] - ax) for i in range(n)]
    oxs, oys, ovalid = [], [], []
    for i in range(n):
        j = (i + 1) % n
        cur_in = d[i] >= 0
        nxt_in = d[j] >= 0
        crossing = cur_in != nxt_in
        denom = d[i] - d[j]
        t = d[i] / torch.where(denom.abs() < _EPS, torch.full_like(denom, _EPS), denom)
        ix = xs[i] + t * (xs[j] - xs[i])
        iy = ys[i] + t * (ys[j] - ys[i])
        # even slot: the vertex if inside, else the entry point
        oxs.append(torch.where(cur_in, xs[i], ix))
        oys.append(torch.where(cur_in, ys[i], iy))
        ovalid.append(cur_in | crossing)
        # odd slot: the exit point when leaving the half-plane
        oxs.append(ix)
        oys.append(iy)
        ovalid.append(cur_in & crossing)
    any_valid = ovalid[0]
    for v in ovalid[1:]:
        any_valid = any_valid | v
    oxs, oys = _fill_from_predecessor(oxs, oys, ovalid)
    return oxs, oys, alive & any_valid


def rotated_intersection_area(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise BEV intersection areas of broadcastable (..., 5) rects."""
    shape = torch.broadcast_shapes(boxes_a.shape[:-1], boxes_b.shape[:-1])
    xs, ys = _corner_slots(boxes_a.expand(shape + (5,)))
    bxs, bys = _corner_slots(boxes_b.expand(shape + (5,)))
    alive = torch.ones(shape, dtype=torch.bool, device=boxes_a.device)
    for i in range(4):
        j = (i + 1) % 4
        xs, ys, alive = _clip_halfplane(xs, ys, alive, bxs[i], bys[i], bxs[j], bys[j])
    n = len(xs)
    area2 = xs[0] * ys[1 % n] - xs[1 % n] * ys[0]
    for i in range(1, n):
        j = (i + 1) % n
        area2 = area2 + (xs[i] * ys[j] - xs[j] * ys[i])
    return torch.where(alive, 0.5 * area2.abs(), torch.zeros_like(area2))


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) BEV IoU."""
    inter = rotated_intersection_area(boxes_a[:, None, :], boxes_b[None, :, :])
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)
