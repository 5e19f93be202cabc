"""CenterNet label assignment (host-side, NumPy): the port's copy of
``sparse2dense_tpu/data/pipelines/assign_label.py``.

Rebuild of det3d's ``AssignLabel`` pipeline stage
(det3d/datasets/pipelines/preprocess.py:479-653). Produces, per task:

- hm:        (H, W, C) float32 gaussian heatmap (NHWC — note det3d
             stores (C, H, W); the content is identical)
- anno_box:  (max_objs, 10) [dx, dy, z, log dims(3), vx, vy, sin r, cos r]
- ind:       (max_objs,) int32 flat y*W+x center index
- mask:      (max_objs,) uint8 validity
- cat:       (max_objs,) int32 class id within task

Waymo gt boxes are 9-dof [x, y, z, w, l, h, vx, vy, rot]; nuScenes likewise
with rot at index 8. Boxes whose integer center falls off the feature map are
skipped, as in det3d.
"""
from __future__ import annotations

import numpy as np

from ...core.center_utils import gaussian_radius, draw_gaussian


def limit_period(val, offset=0.5, period=np.pi * 2):
    return val - np.floor(val / period + offset) * period


class AssignLabel:
    def __init__(self, cfg=None, **kwargs):
        assigner_cfg = cfg if cfg is not None else kwargs["cfg"]
        self.out_size_factor = assigner_cfg["out_size_factor"]
        self.tasks = assigner_cfg["target_assigner"]["tasks"]
        self.gaussian_overlap = assigner_cfg["gaussian_overlap"]
        self._max_objs = assigner_cfg["max_objs"]
        self._min_radius = assigner_cfg["min_radius"]

    def __call__(self, res, info):
        max_objs = self._max_objs
        class_names_by_task = [t["class_names"] for t in self.tasks]

        grid_size = res["lidar"]["voxels"]["shape"]
        pc_range = res["lidar"]["voxels"]["range"]
        voxel_size = res["lidar"]["voxels"]["size"]
        fm_w, fm_h = (np.array(grid_size[:2]) // self.out_size_factor).astype(int)

        example = {}
        if res["mode"] == "train":
            gt_dict = res["lidar"]["annotations"]

            # split gt by task, remapping class ids to be task-local 1-based
            task_boxes, task_classes, task_names = [], [], []
            flag = 0
            for class_names in class_names_by_task:
                sel_boxes, sel_classes, sel_names = [], [], []
                for local_i, name in enumerate(class_names):
                    m = np.where(gt_dict["gt_classes"] == local_i + 1 + flag)
                    sel_boxes.append(gt_dict["gt_boxes"][m])
                    sel_classes.append(gt_dict["gt_classes"][m] - flag)
                    sel_names.append(gt_dict["gt_names"][m])
                task_boxes.append(np.concatenate(sel_boxes, axis=0))
                task_classes.append(np.concatenate(sel_classes))
                task_names.append(np.concatenate(sel_names))
                flag += len(class_names)

            for tb in task_boxes:
                if len(tb):
                    tb[:, -1] = limit_period(tb[:, -1], offset=0.5, period=np.pi * 2)

            gt_dict["gt_classes"] = task_classes
            gt_dict["gt_names"] = task_names
            gt_dict["gt_boxes"] = task_boxes

            hms, anno_boxs, inds, masks, cats = [], [], [], [], []
            for idx, class_names in enumerate(class_names_by_task):
                num_cls = len(class_names)
                hm = np.zeros((fm_h, fm_w, num_cls), dtype=np.float32)
                anno_box = np.zeros((max_objs, 10), dtype=np.float32)
                ind = np.zeros((max_objs,), dtype=np.int32)
                mask = np.zeros((max_objs,), dtype=np.uint8)
                cat = np.zeros((max_objs,), dtype=np.int32)

                boxes = gt_dict["gt_boxes"][idx]
                classes = gt_dict["gt_classes"][idx]
                num_objs = min(boxes.shape[0], max_objs)
                for k in range(num_objs):
                    cls_id = int(classes[k]) - 1
                    w, l = boxes[k][3], boxes[k][4]
                    w_fm = w / voxel_size[0] / self.out_size_factor
                    l_fm = l / voxel_size[1] / self.out_size_factor
                    if w_fm <= 0 or l_fm <= 0:
                        continue
                    radius = gaussian_radius((l_fm, w_fm), min_overlap=self.gaussian_overlap)
                    radius = max(self._min_radius, int(radius))

                    x, y, z = boxes[k][0], boxes[k][1], boxes[k][2]
                    coor_x = (x - pc_range[0]) / voxel_size[0] / self.out_size_factor
                    coor_y = (y - pc_range[1]) / voxel_size[1] / self.out_size_factor
                    ct = np.array([coor_x, coor_y], dtype=np.float32)
                    cx, cy = int(ct[0]), int(ct[1])
                    if not (0 <= cx < fm_w and 0 <= cy < fm_h):
                        continue

                    draw_gaussian(hm[..., cls_id], ct, radius)
                    cat[k] = cls_id
                    ind[k] = cy * fm_w + cx
                    mask[k] = 1
                    vx, vy = boxes[k][6:8]
                    rot = boxes[k][-1]
                    anno_box[k] = np.concatenate(
                        (
                            ct - (cx, cy),
                            [z],
                            np.log(boxes[k][3:6]),
                            [vx, vy, np.sin(rot), np.cos(rot)],
                        ),
                        axis=None,
                    )

                hms.append(hm)
                anno_boxs.append(anno_box)
                inds.append(ind)
                masks.append(mask)
                cats.append(cat)

            # flattened gt for the two-stage ROI head
            all_boxes = np.concatenate(gt_dict["gt_boxes"], axis=0)
            flag2, merged_cls = 0, []
            for idx in range(len(class_names_by_task)):
                merged_cls.append(gt_dict["gt_classes"][idx] + flag2)
                flag2 += len(class_names_by_task[idx])
            merged_cls = np.concatenate(merged_cls)
            gt_boxes_and_cls = np.zeros((max_objs, 10), dtype=np.float32)
            if len(all_boxes):
                bc = np.concatenate(
                    (all_boxes, merged_cls.reshape(-1, 1).astype(np.float32)), axis=1
                )
                # reorder to x,y,z,w,l,h,rot,vx,vy,cls
                bc = bc[:, [0, 1, 2, 3, 4, 5, 8, 6, 7, 9]]
                n = min(len(bc), max_objs)
                gt_boxes_and_cls[:n] = bc[:n]

            example.update(
                {
                    "gt_boxes_and_cls": gt_boxes_and_cls,
                    "hm": hms,
                    "anno_box": anno_boxs,
                    "ind": inds,
                    "mask": masks,
                    "cat": cats,
                }
            )

        res["lidar"]["targets"] = example
        return res, info
