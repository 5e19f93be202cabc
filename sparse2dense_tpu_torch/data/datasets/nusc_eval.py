"""The nuScenes devkit's detection evaluation (counterpart of
``sparse2dense_tpu/data/datasets/nusc_eval.py``; det3d's
datasets/nuscenes/nusc_common.py:509 ``eval_main``). It needs the devkit
(``nuscenes``), which ``NuScenesDataset.evaluation`` imports only where it
is installed."""
from __future__ import annotations


def eval_main(root_path, version, res_path, eval_set, output_dir):
    from nuscenes import NuScenes
    from nuscenes.eval.detection.config import config_factory
    from nuscenes.eval.detection.evaluate import NuScenesEval

    nusc = NuScenes(version=version, dataroot=root_path, verbose=False)
    cfg = config_factory("detection_cvpr_2019")
    nusc_eval = NuScenesEval(nusc, config=cfg, result_path=res_path, eval_set=eval_set,
                             output_dir=output_dir, verbose=False)
    return nusc_eval.main(plot_examples=0, render_curves=False)
