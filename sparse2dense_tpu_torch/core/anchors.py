"""Anchors and IoU target assignment of the SECOND path (host-side NumPy):
the port's copy of ``sparse2dense_tpu/core/anchors.py`` (det3d's
anchor_generator.py, target_assigner.py and target_ops.py). For the same
inputs it gives bit-identical arrays."""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from . import box_np_ops
from .box_coder import GroundBox3dCoder, build_box_coder


class AnchorGeneratorRange:
    """Anchors of each size and rotation at every cell centre of a world
    range."""

    def __init__(self, anchor_ranges, sizes=(1.6, 3.9, 1.56), rotations=(0, np.pi / 2),
                 velocities=None, class_name=None, match_threshold=-1, unmatch_threshold=-1,
                 dtype=np.float32):
        self.anchor_ranges = anchor_ranges
        self.sizes = sizes
        self.rotations = rotations
        self.velocities = velocities
        self.class_name = class_name
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold
        self.dtype = dtype

    @property
    def num_anchors_per_localization(self):
        num_size = np.asarray(self.sizes).reshape([-1, 3]).shape[0]
        return len(self.rotations) * num_size

    def generate(self, feature_map_size):
        return box_np_ops.create_anchors_3d_range(
            feature_map_size, self.anchor_ranges, self.sizes, self.rotations,
            self.velocities, self.dtype)


def create_target_np(all_anchors, gt_boxes, similarity_fn, box_encoding_fn,
                     gt_classes=None, matched_threshold=0.6, unmatched_threshold=0.45,
                     positive_fraction=None, rpn_batch_size=300, box_code_size=7,
                     rng: np.random.RandomState = None):
    """IoU-threshold anchor assignment: each gt claims its best anchors (ties
    included), anchors at or above ``matched_threshold`` take their best gt,
    those below ``unmatched_threshold`` are background. Returns labels (-1
    ignore, 0 background, else the class), bbox_targets and
    bbox_outside_weights."""
    num = all_anchors.shape[0]
    if gt_classes is None:
        gt_classes = np.ones([gt_boxes.shape[0]], dtype=np.int32)
    labels = np.full((num,), -1, dtype=np.int32)
    gt_ids = np.full((num,), -1, dtype=np.int32)

    if len(gt_boxes) > 0:
        overlap = similarity_fn(all_anchors, gt_boxes)  # (num, n_gt)
        anchor_to_gt_argmax = overlap.argmax(axis=1)
        anchor_to_gt_max = overlap[np.arange(num), anchor_to_gt_argmax]
        gt_to_anchor_max = overlap.max(axis=0)
        gt_to_anchor_max[gt_to_anchor_max == 0] = -1
        anchors_with_max = np.where(overlap == gt_to_anchor_max)[0]
        gt_inds_force = anchor_to_gt_argmax[anchors_with_max]
        labels[anchors_with_max] = gt_classes[gt_inds_force]
        gt_ids[anchors_with_max] = gt_inds_force
        pos = anchor_to_gt_max >= matched_threshold
        labels[pos] = gt_classes[anchor_to_gt_argmax[pos]]
        gt_ids[pos] = anchor_to_gt_argmax[pos]
        bg_inds = np.where(anchor_to_gt_max < unmatched_threshold)[0]
    else:
        bg_inds = np.arange(num)

    fg_inds = np.where(labels > 0)[0]

    if positive_fraction is not None and positive_fraction > 0:
        rng = rng or np.random
        num_fg = int(positive_fraction * rpn_batch_size)
        if len(fg_inds) > num_fg:
            disable = rng.choice(fg_inds, size=len(fg_inds) - num_fg, replace=False)
            labels[disable] = -1
            fg_inds = np.where(labels > 0)[0]
        num_bg = rpn_batch_size - np.sum(labels > 0)
        if len(bg_inds) > num_bg:
            labels[bg_inds[rng.randint(len(bg_inds), size=num_bg)]] = 0
    else:
        if len(gt_boxes) == 0:
            labels[:] = 0
        else:
            labels[bg_inds] = 0
            labels[anchors_with_max] = gt_classes[gt_inds_force]

    bbox_targets = np.zeros((num, box_code_size), dtype=all_anchors.dtype)
    if len(gt_boxes) > 0:
        fg_inds = np.where(labels > 0)[0]
        bbox_targets[fg_inds] = box_encoding_fn(gt_boxes[anchor_to_gt_argmax[fg_inds]],
                                                all_anchors[fg_inds])
    bbox_outside_weights = np.zeros((num,), dtype=all_anchors.dtype)
    bbox_outside_weights[labels > 0] = 1.0
    return {"labels": labels, "bbox_targets": bbox_targets,
            "bbox_outside_weights": bbox_outside_weights}


class TargetAssigner:
    """Anchor assignment class by class, each class against its own
    anchors."""

    def __init__(self, box_coder: GroundBox3dCoder, anchor_generators,
                 region_similarity="nearest_iou_similarity", positive_fraction=None,
                 sample_size=512):
        self.box_coder = box_coder
        self.anchor_generators = list(anchor_generators)
        self.positive_fraction = (None if positive_fraction is not None and positive_fraction < 0
                                  else positive_fraction)
        self.sample_size = sample_size
        if region_similarity != "nearest_iou_similarity":
            raise NotImplementedError(region_similarity)
        self._similarity = box_np_ops.nearest_iou_similarity

    @property
    def classes(self):
        return [a.class_name for a in self.anchor_generators]

    @property
    def num_anchors_per_location(self):
        return sum(a.num_anchors_per_localization for a in self.anchor_generators)

    def generate_anchors_dict(self, feature_map_size):
        """{class: {anchors (D, H, W, S*R, nd), matched / unmatched thresholds}}."""
        out = OrderedDict()
        for gen in self.anchor_generators:
            anchors = gen.generate(feature_map_size)
            anchors = anchors.reshape([*anchors.shape[:3], -1, anchors.shape[-1]])
            n = int(np.prod(anchors.shape[:-1]))
            out[gen.class_name] = {
                "anchors": anchors,
                "matched_thresholds": np.full([n], gen.match_threshold, anchors.dtype),
                "unmatched_thresholds": np.full([n], gen.unmatch_threshold, anchors.dtype),
            }
        return out

    def generate_anchors(self, feature_map_size):
        d = self.generate_anchors_dict(feature_map_size)
        return {
            "anchors": np.concatenate([v["anchors"] for v in d.values()], axis=-2),
            "matched_thresholds": np.concatenate([v["matched_thresholds"] for v in d.values()]),
            "unmatched_thresholds": np.concatenate(
                [v["unmatched_thresholds"] for v in d.values()]),
        }

    def assign_v2(self, anchors_dict, gt_boxes, gt_classes=None, gt_names=None):
        """Each class's assignment, concatenated over the anchor axis."""

        def similarity_fn(anchors, gts):
            return self._similarity(anchors[:, [0, 1, 3, 4, -1]], gts[:, [0, 1, 3, 4, -1]])

        def box_encoding_fn(boxes, anchors):
            return self.box_coder.encode(boxes, anchors)

        targets_list = []
        for class_name, anchor_dict in anchors_dict.items():
            mask = np.array([c == class_name for c in gt_names], dtype=bool)
            feature_map_size = anchor_dict["anchors"].shape[:3]
            targets_list.append(create_target_np(
                anchor_dict["anchors"].reshape(-1, self.box_coder.code_size),
                gt_boxes[mask], similarity_fn, box_encoding_fn,
                gt_classes=gt_classes[mask],
                matched_threshold=anchor_dict["matched_thresholds"],
                unmatched_threshold=anchor_dict["unmatched_thresholds"],
                positive_fraction=self.positive_fraction,
                rpn_batch_size=self.sample_size,
                box_code_size=self.box_coder.code_size))
        cs = self.box_coder.code_size
        bbox_targets = np.concatenate(
            [t["bbox_targets"].reshape(*feature_map_size, -1, cs) for t in targets_list],
            axis=-2).reshape(-1, cs)
        labels = np.concatenate(
            [t["labels"].reshape(*feature_map_size, -1) for t in targets_list],
            axis=-1).reshape(-1)
        weights = np.concatenate(
            [t["bbox_outside_weights"].reshape(*feature_map_size, -1) for t in targets_list],
            axis=-1).reshape(-1)
        return {"labels": labels, "bbox_targets": bbox_targets, "bbox_outside_weights": weights}


def build_target_assigner(target_assigner_cfg, box_coder_cfg) -> TargetAssigner:
    """From the reference schema: a target_assigner dict with its
    anchor_generators list, and a box_coder dict."""
    box_coder = build_box_coder(box_coder_cfg)
    gens = []
    for g in target_assigner_cfg["anchor_generators"]:
        g = dict(g)
        kind = g.pop("type", "anchor_generator_range")
        if kind != "anchor_generator_range":
            raise NotImplementedError(kind)
        gens.append(AnchorGeneratorRange(
            anchor_ranges=g["anchor_ranges"], sizes=g["sizes"],
            rotations=g.get("rotations", (0, np.pi / 2)), velocities=g.get("velocities"),
            class_name=g["class_name"], match_threshold=g["matched_threshold"],
            unmatch_threshold=g["unmatched_threshold"]))
    sim = target_assigner_cfg.get("region_similarity_calculator",
                                  {"type": "nearest_iou_similarity"})["type"]
    return TargetAssigner(
        box_coder=box_coder, anchor_generators=gens, region_similarity=sim,
        positive_fraction=target_assigner_cfg.get("sample_positive_fraction"),
        sample_size=target_assigner_cfg.get("sample_size", 512))
