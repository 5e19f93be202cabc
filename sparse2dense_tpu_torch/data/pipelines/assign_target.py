"""Anchor target assignment (the SECOND path, host-side NumPy): the port's
copy of ``sparse2dense_tpu/data/pipelines/assign_target.py`` (det3d's
``AssignTarget`` stage). Per task it gives:

- anchors:     (A, nd) float32 (the same every frame, so computed once);
- labels:      (A,) int32: -1 ignore, 0 background, else the class id;
- reg_targets: (A, code_size) float32 box-coder deltas;
- reg_weights: (A,) float32;

with A = prod(feature_map_size) * anchors a location. In "train" mode it
assigns the frame's gt boxes; otherwise it gives the anchors only.
"""
from __future__ import annotations

import numpy as np

from ...core import box_np_ops
from ...core.anchors import TargetAssigner, build_target_assigner


class AssignTarget:
    def __init__(self, cfg=None, **kwargs):
        assigner_cfg = cfg if cfg is not None else kwargs["cfg"]
        ta_cfg = dict(assigner_cfg["target_assigner"])
        full = build_target_assigner(ta_cfg, assigner_cfg["box_coder"])
        # one assigner per task, over that task's classes' generators
        self.target_assigners = []
        flag = 0
        for task in ta_cfg["tasks"]:
            n = task["num_class"]
            self.target_assigners.append(TargetAssigner(
                box_coder=full.box_coder, anchor_generators=full.anchor_generators[flag:flag + n],
                positive_fraction=full.positive_fraction, sample_size=full.sample_size))
            flag += n
        self.out_size_factor = assigner_cfg["out_size_factor"]
        self._anchor_cache = None

    def _anchors(self, grid_size):
        key = tuple(int(g) for g in grid_size[:2])
        if self._anchor_cache is not None and self._anchor_cache[0] == key:
            return self._anchor_cache[1:]
        feature_map_size = [1, key[1] // self.out_size_factor, key[0] // self.out_size_factor]
        anchors_by_task, dicts_by_task = [], []
        for t in self.target_assigners:
            d = t.generate_anchors_dict(feature_map_size)
            a = t.generate_anchors(feature_map_size)
            anchors_by_task.append(a["anchors"].reshape(-1, a["anchors"].shape[-1]))
            dicts_by_task.append(d)
        self._anchor_cache = (key, anchors_by_task, dicts_by_task)
        return anchors_by_task, dicts_by_task

    def __call__(self, res, info):
        anchors_by_task, dicts_by_task = self._anchors(res["lidar"]["voxels"]["shape"])
        example = {"anchors": anchors_by_task}

        if res["mode"] == "train":
            gt_dict = res["lidar"]["annotations"]
            task_boxes, task_classes, task_names = [], [], []
            flag = 0
            for class_names in [t.classes for t in self.target_assigners]:
                sel_b, sel_c, sel_n = [], [], []
                for local_i, _ in enumerate(class_names):
                    m = np.where(gt_dict["gt_classes"] == local_i + 1 + flag)
                    sel_b.append(gt_dict["gt_boxes"][m][:, [0, 1, 2, 3, 4, 5, -1]])
                    sel_c.append(gt_dict["gt_classes"][m] - flag)
                    sel_n.append(gt_dict["gt_names"][m])
                boxes = np.concatenate(sel_b, axis=0)
                boxes[:, -1] = box_np_ops.limit_period(boxes[:, -1], offset=0.5,
                                                       period=np.pi * 2)
                task_boxes.append(boxes)
                task_classes.append(np.concatenate(sel_c))
                task_names.append(np.concatenate(sel_n))
                flag += len(class_names)

            labels, reg_targets, reg_weights = [], [], []
            for idx, t in enumerate(self.target_assigners):
                td = t.assign_v2(dicts_by_task[idx], task_boxes[idx],
                                 gt_classes=task_classes[idx], gt_names=task_names[idx])
                labels.append(td["labels"])
                reg_targets.append(td["bbox_targets"])
                reg_weights.append(td["bbox_outside_weights"])
            example.update(labels=labels, reg_targets=reg_targets, reg_weights=reg_weights)

        res["lidar"]["targets"] = example
        return res, info
