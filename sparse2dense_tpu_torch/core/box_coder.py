"""The SECOND box coder: the port's copy of
``sparse2dense_tpu/core/box_coder.py``. Encoding runs on the host (NumPy);
decoding on NumPy arrays or torch tensors."""
from __future__ import annotations

import numpy as np

from . import box_np_ops


class GroundBox3dCoder:
    """7-dim (9 with velocities) deltas with log dims and, optionally, the
    angle as a (cos, sin) difference."""

    def __init__(self, linear_dim=False, vec_encode=False, n_dim=7, norm_velo=False):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.norm_velo = norm_velo
        self.n_dim = n_dim

    @property
    def code_size(self):
        return self.n_dim + 1 if self.vec_encode else self.n_dim

    def encode(self, boxes, anchors):
        return box_np_ops.second_box_encode(
            boxes, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim, norm_velo=self.norm_velo)

    def decode(self, encodings, anchors, xp=np):
        """``xp``: ``numpy`` for arrays, ``torch`` for tensors."""
        return box_np_ops.second_box_decode(
            encodings, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim, norm_velo=self.norm_velo, xp=xp)


def build_box_coder(cfg) -> GroundBox3dCoder:
    """A coder from its config dict (the det3d ``build_box_coder`` that
    reference config files call)."""
    cfg = dict(cfg)
    kind = cfg.pop("type", "ground_box3d_coder")
    if kind != "ground_box3d_coder":
        raise NotImplementedError(f"box coder {kind}")
    return GroundBox3dCoder(
        linear_dim=cfg.get("linear_dim", False),
        vec_encode=cfg.get("encode_angle_vector", cfg.get("vec_encode", False)),
        n_dim=cfg.get("n_dim", 7),
        norm_velo=cfg.get("norm_velo", False),
    )
