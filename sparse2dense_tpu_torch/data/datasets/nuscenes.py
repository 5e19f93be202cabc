"""NuScenesDataset: the port's copy of
``sparse2dense_tpu/data/datasets/nuscenes.py`` (det3d's
datasets/nuscenes/nuscenes.py:30-327). It loads the pickled sample infos
(``lidar_path``, ``sweeps`` with their ``lidar_path``, ``transform_matrix``
and ``time_lag``, ``gt_boxes`` 9-dof, ``gt_names``, ``gt_boxes_velocity``,
``token``), keeps every ``load_interval``-th and runs the pipeline on a
sample, drawing from the sample's own generator (``waymo.SeededDataset``).

``evaluation`` writes the detections as the nuScenes results json
(``infos_pred_nusc.json``) and runs the devkit's evaluation
(``nusc_eval.eval_main``) where the devkit is installed; without it, it
says so and returns (None, None).
"""
from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np

from .waymo import SeededDataset


class NuScenesDataset(SeededDataset):
    NumPointFeatures = 5  # x, y, z, intensity, ring -> 4 used + time

    DefaultAttribute = {
        "car": "vehicle.parked",
        "pedestrian": "pedestrian.moving",
        "trailer": "vehicle.parked",
        "truck": "vehicle.parked",
        "bus": "vehicle.moving",
        "motorcycle": "cycle.without_rider",
        "construction_vehicle": "vehicle.parked",
        "bicycle": "cycle.without_rider",
        "barrier": "",
        "traffic_cone": "",
    }

    def __init__(self, info_path, root_path, pipeline=None, class_names=None,
                 test_mode=False, nsweeps=1, load_interval=1, version="v1.0-trainval",
                 **kwargs):
        self._info_path = info_path
        self._root_path = root_path
        self._class_names = class_names
        self.test_mode = test_mode
        self.nsweeps = nsweeps
        self.load_interval = load_interval
        self.version = version
        self.pipeline = pipeline
        self._infos = None
        self._num_point_features = 4   # the reference's metadata value

    @property
    def infos(self):
        if self._infos is None:
            with open(self._info_path, "rb") as f:
                infos = pickle.load(f)
            if isinstance(infos, dict):   # some info pkls store {"infos": ...}
                infos = infos.get("infos", infos)
            self._infos = infos[::self.load_interval]
        return self._infos

    def __len__(self):
        return len(self.infos)

    def get(self, idx: int, rng: np.random.RandomState):
        """The pipeline's example of sample ``idx`` (a list of 4 bundles
        under double flip), drawing from ``rng``."""
        info = self.infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None, "annotations": None,
                      "nsweeps": self.nsweeps},
            "metadata": {"image_prefix": self._root_path,
                         "num_point_features": self._num_point_features,
                         "token": info["token"]},
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
            "type": "NuScenesDataset",
            "painted": False,
            "rng": rng,
        }
        data, _ = self.pipeline(res, info)
        return data

    def evaluation(self, detections, output_dir=None, testset=False):
        """The detections (token -> "box3d_lidar" (N, 9), "scores",
        "label_preds", optionally "valid") as ``<output_dir>/
        infos_pred_nusc.json``; then the devkit's evaluation where it is
        installed: (its metrics, None), else (None, None)."""
        nusc_annos = {"results": {}, "meta": {"use_camera": False, "use_lidar": True,
                                              "use_radar": False, "use_map": False,
                                              "use_external": False}}
        for token, det in detections.items():
            boxes = np.asarray(det["box3d_lidar"])
            scores = np.asarray(det["scores"])
            labels = np.asarray(det["label_preds"])
            valid = np.asarray(det.get("valid", np.ones(len(scores), bool)))
            annos = []
            for i in np.where(valid)[0]:
                name = self._class_names[int(labels[i])]
                vel = boxes[i, 6:8].tolist() if boxes.shape[-1] > 7 else [0.0, 0.0]
                annos.append({
                    "sample_token": token,
                    "translation": boxes[i, :3].tolist(),
                    "size": boxes[i, 3:6].tolist(),
                    "rotation": _yaw_to_quaternion(float(boxes[i, -1])),
                    "velocity": vel,
                    "detection_name": name,
                    "detection_score": float(scores[i]),
                    "attribute_name": self.DefaultAttribute.get(name, ""),
                })
            nusc_annos["results"][token] = annos

        os.makedirs(output_dir or ".", exist_ok=True)
        res_path = os.path.join(output_dir or ".", "infos_pred_nusc.json")
        with open(res_path, "w") as f:
            json.dump(nusc_annos, f)
        try:
            from nuscenes import NuScenes  # noqa: F401
        except ImportError:
            print(f"nuscenes devkit unavailable; wrote results to {res_path}")
            return None, None
        from .nusc_eval import eval_main

        return eval_main(self._root_path, self.version, res_path, "val", output_dir), None


def _yaw_to_quaternion(yaw: float):
    """(w, x, y, z) of the rotation by ``yaw`` about z, as the reference
    writes it."""
    half = yaw / 2
    return [math.cos(half), 0.0, 0.0, math.sin(half)]
