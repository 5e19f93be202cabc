"""CenterNet target-drawing utilities (host-side NumPy): the port's copy of
``sparse2dense_tpu/core/center_utils.py``.

Semantics match det3d (det3d/core/utils/center_utils.py:18,40,49):
same CornerNet gaussian-radius quadratics, same truncated-gaussian stamp with
elementwise max into the heatmap. These run in the data pipeline on the host;
the device never sees ragged shapes.
"""
from __future__ import annotations

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.5) -> float:
    """Minimum radius such that a box shifted by r still has IoU >= min_overlap.

    det_size is (height, width) in feature-map cells. Returns the min of the
    three CornerNet case solutions (reference center_utils.py:18-38).
    """
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * a1 * c1)) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 4 * a2 * c2)) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    """(2m+1, 2n+1) unnormalized gaussian bump; tiny values flushed to 0."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> np.ndarray:
    """Stamp max(heatmap, k*gaussian) around integer center, clipped to bounds.

    In-place on ``heatmap`` (H, W); sigma = diameter/6 as in the reference.
    """
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_hm = heatmap[y - top:y + bottom, x - left:x + right]
    masked_g = gaussian[radius - top:radius + bottom, radius - left:radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap
