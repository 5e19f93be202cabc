"""The Reformat stage and the pipeline builder: the port's copy of
``sparse2dense_tpu/data/pipelines/formating.py`` (det3d's
datasets/pipelines/formating.py:14-117). ``Reformat`` turns a pipeline
result into a flat example dict: the voxel streams, the points and the
head's targets. With ``double_flip``, outside training, it returns the
list of 4 bundles [orig, yflip, xflip, double] of a frame, which ``collate``
flattens into consecutive batch rows.
"""
from __future__ import annotations


class Reformat:
    def __init__(self, distillation=False, **kwargs):
        self.distillation = distillation
        self.double_flip = kwargs.get("double_flip", False)

    def __call__(self, res, info):
        lidar = res["lidar"]
        voxels = lidar["voxels"]
        bundle = dict(metadata=res.get("metadata"), points=lidar["points"],
                      voxels=voxels["voxels"], shape=voxels["shape"],
                      num_points=voxels["num_points"], num_voxels=voxels["num_voxels"],
                      coordinates=voxels["coordinates"])
        if self.distillation:
            dense = lidar["dense_voxels"]
            bundle.update(dense_points=lidar["dense_points"], dense_voxels=dense["voxels"],
                          dense_num_points=dense["num_points"],
                          dense_num_voxels=dense["num_voxels"],
                          dense_coordinates=dense["coordinates"],
                          reconstruction_points=lidar["reconstruction_points"])
            for tag in ("", "_2", "_4"):
                rv = lidar[f"reconstruction_voxels{tag}"]
                bundle[f"reconstruction_voxels{tag}"] = rv["voxels"]
                bundle[f"reconstruction_coordinates{tag}"] = rv["coordinates"]
                bundle[f"reconstruction_num_voxels{tag}"] = rv["num_voxels"]
                bundle[f"reconstruction_num_points{tag}"] = rv["num_points"]
        if res["mode"] in ("train", "val") and "targets" in lidar:
            bundle.update(lidar["targets"])
        if self.double_flip and res["mode"] != "train":
            views = (lidar[f"{key}_voxels"] for key in ("yflip", "xflip", "double_flip"))
            flips = [dict(metadata=res.get("metadata"), voxels=v["voxels"], shape=v["shape"],
                          num_points=v["num_points"], num_voxels=v["num_voxels"],
                          coordinates=v["coordinates"]) for v in views]
            return [bundle] + flips, info
        return bundle, info


class Empty:
    """No-op stage (reference configs emit dict(type="Empty") where a
    test-time stage is off)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        return res, info


class Compose:
    """The stages in order, threading (res, info)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, res, info):
        for t in self.transforms:
            res, info = t(res, info)
            if res is None:
                return None, None
        return res, info


def build_pipeline(stage_cfgs):
    """A Compose of the reference's pipeline stage dicts."""
    from .assign_label import AssignLabel
    from .assign_target import AssignTarget
    from .loading import LoadPointCloudAnnotations, LoadPointCloudFromFile
    from .preprocess import DoubleFlip, Preprocess, Voxelization

    registry = {
        "LoadPointCloudFromFile": LoadPointCloudFromFile,
        "LoadPointCloudAnnotations": LoadPointCloudAnnotations,
        "Preprocess": Preprocess,
        "Voxelization": Voxelization,
        "AssignLabel": AssignLabel,
        "AssignTarget": AssignTarget,
        "DoubleFlip": DoubleFlip,
        "Empty": Empty,
        "Reformat": Reformat,
    }
    stages = []
    for cfg in stage_cfgs:
        cfg = dict(cfg)
        kind = cfg.pop("type")
        if kind not in registry:
            raise KeyError(f"unknown pipeline stage {kind}")
        stages.append(registry[kind](**cfg))
    return Compose(stages)
