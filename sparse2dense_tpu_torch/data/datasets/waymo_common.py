"""Waymo detection output: the port's copy of
``sparse2dense_tpu/data/datasets/waymo_common.py`` (det3d's
datasets/waymo/waymo_common.py:57-120). Writes the devkit's
``metrics_pb2.Objects`` proto when ``waymo_open_dataset`` is importable,
else a pickle of the detections (``detection_pred.pkl``): the official
metrics come from the devkit's own tool, as in the reference.
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

LABEL_TO_TYPE = {0: 1, 1: 2, 2: 4}  # VEHICLE, PEDESTRIAN, CYCLIST
logger = logging.getLogger("sparse2dense_tpu_torch")


def reorganize_info(infos):
    return {info["token"]: info for info in infos}


def create_pd_detection(detections, infos, result_path, tracking=False) -> str:
    """Write ``detections`` (token -> box3d_lidar, scores, label_preds) under
    ``result_path``; returns the file's path."""
    try:
        from waymo_open_dataset import label_pb2
        from waymo_open_dataset.protos import metrics_pb2
    except ImportError:
        out = os.path.join(result_path, "detection_pred.pkl")
        with open(out, "wb") as f:
            pickle.dump(detections, f)
        logger.info(f"waymo devkit unavailable; wrote the detections to {out}")
        return out

    objects = metrics_pb2.Objects()
    for token, detection in detections.items():
        info = infos[token]
        anno = info["anno"] if "anno" in info else info
        box3d = np.asarray(detection["box3d_lidar"])
        scores = np.asarray(detection["scores"])
        labels = np.asarray(detection["label_preds"])
        for i in range(box3d.shape[0]):
            det = box3d[i]
            o = metrics_pb2.Object()
            o.context_name = anno["scene_name"] if "scene_name" in anno else info["context"]
            o.frame_timestamp_micros = int(anno.get("frame_id", info.get("timestamp", 0)))
            box = label_pb2.Label.Box()
            box.center_x, box.center_y, box.center_z = map(float, det[:3])
            box.width, box.length, box.height = map(float, det[3:6])
            box.heading = float(det[-1])
            o.object.box.CopyFrom(box)
            o.score = float(scores[i])
            o.object.type = LABEL_TO_TYPE[int(labels[i])]
            objects.objects.append(o)
    path = os.path.join(result_path, "tracking_pred.bin" if tracking else "detection_pred.bin")
    with open(path, "wb") as f:
        f.write(objects.SerializeToString())
    logger.info(f"wrote the waymo detection bin to {path}")
    return path
