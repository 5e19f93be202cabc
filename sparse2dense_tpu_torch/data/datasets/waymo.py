"""WaymoDataset: the port's copy of ``sparse2dense_tpu/data/datasets/waymo.py``
(det3d's datasets/waymo/waymo.py:19-108). It loads the pickled frame infos,
keeps every ``load_interval``-th ("20% Waymo" is interval 5) and runs the
pipeline on a frame. ``evaluation`` writes the detections
(``waymo_common``) and computes the local BEV mAP (``core/eval.py``).

Every draw of a sample comes from its own ``np.random.RandomState``, made
from the key (seed, epoch, index) (:func:`sample_rng`; ``dataset[i]`` is
``dataset[0, 0, i]``): the loader passes the run's seed and the epoch, so a
sample is the same whichever input worker makes it.
"""
from __future__ import annotations

import pickle

import numpy as np


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The generator of one sample: MT19937 seeded by the key's three
    integers (as ``np.random.seed([seed, epoch, index])``)."""
    return np.random.RandomState([seed, epoch, index])


class SeededDataset:
    """``ds[key]`` for ``key`` an index or a (seed, epoch, index) triple:
    ``ds.get(index, sample_rng(seed, epoch, index))``."""

    def __getitem__(self, key):
        seed, epoch, index = key if isinstance(key, tuple) else (0, 0, key)
        return self.get(int(index), sample_rng(seed, epoch, index))


class WaymoDataset(SeededDataset):
    NumPointFeatures = 5  # x, y, z, intensity, elongation

    def __init__(self, info_path, root_path, pipeline=None, class_names=None,
                 test_mode=False, nsweeps=1, load_interval=1, **kwargs):
        self.load_interval = load_interval
        self.nsweeps = nsweeps
        self.test_mode = test_mode
        self._root_path = root_path
        self._info_path = info_path
        self._class_names = class_names
        self._num_point_features = (self.NumPointFeatures if nsweeps == 1
                                    else self.NumPointFeatures + 1)
        self.pipeline = pipeline
        self._infos = None

    def load_infos(self):
        with open(self._info_path, "rb") as f:
            infos = pickle.load(f)
        self._infos = infos[::self.load_interval]

    @property
    def infos(self):
        if self._infos is None:
            self.load_infos()
        return self._infos

    def __len__(self):
        return len(self.infos)

    def get(self, idx: int, rng: np.random.RandomState):
        """The pipeline's example of frame ``idx``, drawing from ``rng``."""
        info = self.infos[idx]
        if "gt_signs" not in info:
            info["gt_signs"] = None
        res = {
            "lidar": {"type": "lidar", "points": None, "annotations": None,
                      "nsweeps": self.nsweeps, "signs": info["gt_signs"]},
            "metadata": {"image_prefix": self._root_path,
                         "num_point_features": self._num_point_features,
                         "token": info["token"]},
            "calib": None,
            "cam": {},
            "mode": "val" if self.test_mode else "train",
            "type": "WaymoDataset",
            "rng": rng,
        }
        data, _ = self.pipeline(res, info)
        return data

    def evaluation(self, detections, output_dir=None, testset=False):
        """Write the detections (the devkit's proto bin, or a pickle without
        the devkit), then compute the local BEV mAP against the infos' boxes
        (``core.eval.evaluate_detections``): ({"local_bev_mAP", "per_class",
        "results"}, None), or (None, None) for the test set or with no
        ground truth."""
        from ...core.eval import evaluate_detections
        from .waymo_common import create_pd_detection, reorganize_info

        infos = reorganize_info(self.infos)
        create_pd_detection(detections, infos, output_dir)
        if testset or not self._class_names:
            return None, None
        gts = {}
        for token, info in infos.items():
            boxes = info.get("gt_boxes")
            if boxes is None or len(boxes) == 0:
                continue
            names = np.asarray(info.get("gt_names"))
            classes = np.asarray([self._class_names.index(n) + 1 if n in self._class_names else 0
                                  for n in names])
            sel = classes > 0
            gts[token] = {"gt_boxes": np.asarray(boxes)[sel], "gt_classes": classes[sel]}
        if not gts:
            return None, None
        res = evaluate_detections(gts, detections, list(self._class_names))
        summary = ", ".join(f"{k}: {v['ap']:.4f}" for k, v in res.items()
                            if isinstance(v, dict) and "ap" in v)
        return {"local_bev_mAP": res.get("mAP"), "per_class": res, "results": summary}, None
