"""The seven nuScenes recipe configs against their zoo rows, and the
nuScenes recipes' command lines on the CPU: ``tools/train.py`` on a config
whose one detector is ``model`` (as the recipes'), then ``tools/test.py
--batch_size 2`` of its checkpoint over nuScenes-layout records with
double-flip test-time augmentation."""
import json
import os

import pytest

from sparse2dense_tpu import zoo
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.tools import test as test_cli
from sparse2dense_tpu_torch.tools import train as train_cli
from sparse2dense_tpu_torch.training.synthetic import write_nusc_records
from sparse2dense_tpu_torch.utils.config import NUSC_PP, NUSC_VOXELNET, ConfigDict, detector_cfg

from tests.test_torch_nusc_data import TINY_RANGE
from tests.test_torch_nusc_model import NUSC_TASKS, TINY
from tests.test_torch_pp import _plain


def test_nusc_configs_against_the_zoo():
    """Each config is its zoo row key for key (``pretrained`` and the data
    paths too); the served and the trained recipe, and the circle-NMS
    pillar recipe, build at full width."""
    paths = {**{f"nusc/voxelnet/nusc_centerpoint_voxelnet_{v}": p
                for v, p in NUSC_VOXELNET.items()},
             **{"nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_10sweep"
                + ("" if v == "base" else f"_{v}"): p for v, p in NUSC_PP.items()}}
    assert len(paths) == 7 and sorted(paths) == sorted(k for k in zoo.VARIANTS
                                                      if k.startswith("nusc/"))
    for key, path in paths.items():
        fn, variant = zoo.VARIANTS[key]
        want, got = fn(variant), ConfigDict.fromfile(path)
        assert sorted(got) == sorted(want), key
        for k, v in got.items():
            assert repr(_plain(v)) == repr(_plain(want[k])), (key, k)
        assert "S_model" not in got and detector_cfg(got) is got["model"]
    for path in (NUSC_VOXELNET["0075voxel_dcn_flip"], NUSC_VOXELNET["0075voxel_dcn"],
                 NUSC_PP["circular_nms"]):
        cfg = ConfigDict.fromfile(path)
        model = build_detector(detector_cfg(cfg), test_cfg=cfg.test_cfg,
                               voxel_generator=cfg.voxel_generator, device="cpu")
        head = model.bbox_head
        assert len(head.tasks) == 6
        if detector_cfg(cfg)["bbox_head"].get("dcn_head"):
            assert type(head.task_0).__name__ == "DCNSepHead"
        del model


APPEND = """
tasks = {tasks!r}
class_names = [n for t in tasks for n in t["class_names"]]
target_assigner["tasks"] = tasks
S_model["bbox_head"].update(tasks=tasks, dataset="nuscenes", weight=0.25, dcn_head=True,
                            code_weights=[1.0] * 6 + [0.2, 0.2, 1.0, 1.0],
                            common_heads={{"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                                          "rot": (2, 2), "vel": (2, 2)}})
test_cfg.update(double_flip=True, score_threshold=0.0)
voxel_generator["double_flip"] = True
model = S_model
del S_model
data = {data!r}
data["val"]["pipeline"][4]["cfg"] = voxel_generator
"""


@pytest.fixture(scope="module")
def nusc_cfg(tmp_path_factory):
    """voxelnet_tiny as a nuScenes recipe (``model``, six tasks, DCN heads,
    double flip) with the 0075voxel_dcn_flip recipe's data block on records
    of 3 samples (no loader workers)."""
    tmp = tmp_path_factory.mktemp("nusc_cli")
    info = write_nusc_records(str(tmp), 3, 600, sweep_points=300, n_obj=5, pc_range=TINY_RANGE)
    data = _plain(dict(ConfigDict.fromfile(NUSC_VOXELNET["0075voxel_dcn_flip"]).data))
    data["workers_per_gpu"] = 0
    data["val"].update(info_path=info, ann_file=info, root_path=str(tmp))
    assert data["val"]["pipeline"][4]["type"] == "Voxelization"
    path = tmp / "nusc_tiny.py"
    with open(TINY) as f:
        path.write_text(f.read() + APPEND.format(tasks=NUSC_TASKS, data=data))
    return str(path), tmp


def test_nusc_train_then_test_cli(nusc_cfg):
    """``tools/train.py --synthetic`` trains the ``model``-keyed config (no
    ``S_model``); ``tools/test.py --batch_size 2`` evaluates its checkpoint
    over the records under double flip: one token a sample, the results
    json written, and (None, None) without the nuScenes devkit."""
    path, tmp = nusc_cfg
    work = str(tmp / "work")
    trainer = train_cli.main([path, "--synthetic", "2", "--batch_size", "2", "--epochs", "1",
                              "--work_dir", work, "--device", "cpu"])
    assert trainer.global_iter == 1 and os.path.exists(os.path.join(work, "latest"))
    evald = str(tmp / "eval")
    detections, result, _ = test_cli.main([path, "--checkpoint", os.path.join(work, "latest"),
                                           "--work_dir", evald, "--batch_size", "2",
                                           "--device", "cpu"])
    assert result == (None, None)
    assert sorted(detections) == ["sample_0", "sample_1"]   # 3 samples, batches of 2
    with open(os.path.join(evald, "infos_pred_nusc.json")) as f:
        results = json.load(f)["results"]
    assert sorted(results) == sorted(detections)
    assert all(len(v) == len(detections[k]["scores"]) > 0 for k, v in results.items())
