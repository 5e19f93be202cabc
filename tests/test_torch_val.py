"""Validation and the CLIs on records, on the CPU: ``Trainer.val``,
``Trainer.run``'s validation epochs, ``tools/train.py`` on ``cfg.data`` and
``tools/test.py``, over Waymo-layout records written by
``tests/test_data_pipeline.py``'s ``_write_synthetic_waymo`` (the dense
object sets under ``<root>/{train,val}/gt`` as the recipe reads them).

``Trainer.val`` on the tiny VoxelNet: its detections (written by
``WaymoDataset.evaluation``) are the model's own ``predict`` on the same
batches, valid-masked and keyed by token. ``Trainer.run`` validates at the
epochs the JAX package's ``Trainer.run`` does. The CLIs: the tiny
distillation config (window engine) with a data block in the recipe's
schema trains from the records for an epoch, and ``tools/test.py``
evaluates its checkpoint; what the port leaves to later slices raises and
names its ROADMAP item.

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the CLIs on records,
``tests/test_torch_val_cli.py``; the last two validation schedules,
``tests/test_torch_val_epochs.py``."""
import os
import pickle

import numpy as np
import pytest
import torch

from sparse2dense_tpu.training.trainer import Trainer as JaxTrainer
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.tools import train as train_cli
from sparse2dense_tpu_torch.training.trainer import Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict
from tests.test_data_pipeline import _write_synthetic_waymo
from tests.test_gtaug_distill_pipeline import _write_gt_objects

N_FRAMES, N_OBJ = 4, 3
DATA = """
test_cfg["score_threshold"] = 0.0   # random weights: keep some detections
log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook")])
voxel_generator["distillation"] = DISTILL
train_preprocessor = dict(mode="train", shuffle_points=True,
                          global_rot_noise=[-0.78539816, 0.78539816],
                          global_scale_noise=[0.95, 1.05], db_sampler=None,
                          class_names=class_names, distillation=DISTILL)
val_preprocessor = dict(mode="val", shuffle_points=False, distillation=DISTILL)
train_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset="WaymoDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=train_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat", distillation=DISTILL),
]
test_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset="WaymoDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=val_preprocessor),
    dict(type="Voxelization", cfg=voxel_generator),
    dict(type="AssignLabel", cfg=assigner),
    dict(type="Reformat"),
]
data = dict(
    samples_per_gpu=2, workers_per_gpu=0,
    train=dict(type="WaymoDataset", root_path=ROOT, info_path=INFOS, nsweeps=1,
               class_names=class_names, pipeline=train_pipeline),
    val=dict(type="WaymoDataset", root_path=ROOT, info_path=INFOS, test_mode=True,
             nsweeps=1, class_names=class_names, pipeline=test_pipeline),
)
total_epochs = 1
"""
WINDOW = """
for _m in (model, S_model):
    _m["backbone"].update(engine="window", dense_from_stage=1, dense_compute_dtype=None)
del _m
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_val"))
    info_path = _write_synthetic_waymo(root, n_frames=N_FRAMES, n_obj=N_OBJ)
    rng = np.random.RandomState(2)
    ids = [f"obj_{i}_{j}" for i in range(N_FRAMES) for j in range(N_OBJ)]
    for split in ("train", "val"):
        _write_gt_objects(os.path.join(root, split, "gt"), ids, rng)
    return root, info_path


def _config(records, tmp, base, distill, extra=""):
    root, info_path = records
    text = (open(base).read() + extra + DATA.replace("DISTILL", str(distill))
            .replace("ROOT", repr(root)).replace("INFOS", repr(info_path)))
    path = os.path.join(str(tmp), os.path.basename(base))
    with open(path, "w") as f:
        f.write(text)
    return path


def test_trainer_val_detections_are_the_models_predict(records, tmp_path):
    cfg = ConfigDict.fromfile(_config(records, tmp_path, "configs/tests/voxelnet_tiny.py",
                                      False))
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, OneCycleAdam(model.parameters(), cfg.optimizer, cfg.lr_config, 4),
                      work_dir=str(tmp_path), hooks=[])
    dataset = tloader.build_dataset(cfg.data["val"])
    loader = tloader.InputPipeline(dataset, 2, 256, shuffle=False, device="cpu")
    model.train()
    result, _ = trainer.val(loader, dataset, output_dir=str(tmp_path / "val"))
    assert model.training
    with open(tmp_path / "val" / "detection_pred.pkl", "rb") as f:
        detections = pickle.load(f)
    model.eval()
    want = {}
    with torch.no_grad():
        for batch in loader:
            out = model.predict(model(batch), example=batch)
            for b, meta in enumerate(batch["metadata"]):
                m = out["valid"][b]
                want[meta["token"]] = {k: out[k][b][m].numpy()
                                       for k in ("box3d_lidar", "scores", "label_preds")}
    assert sorted(detections) == sorted(want) == [f"frame_{i}" for i in range(N_FRAMES)]
    for token, det in want.items():
        for k, v in det.items():
            np.testing.assert_array_equal(detections[token][k], v, err_msg=f"{token} {k}")
    assert sum(len(d["scores"]) for d in detections.values()) > 0
    assert 0.0 <= result["local_bev_mAP"] <= 1.0 and set(result["per_class"]) >= {"VEHICLE"}


VAL_SCHEDULES = [(5, 2, 0), (5, 0, 0), (4, 1, 0), (6, 4, 0), (7, 3, 4)]


@pytest.mark.parametrize("max_epochs,interval,start", VAL_SCHEDULES[:3])
def test_run_validates_at_the_reference_epochs(max_epochs, interval, start):
    check_run_validates(max_epochs, interval, start)


def check_run_validates(max_epochs, interval, start):
    """``Trainer.run`` validates at the JAX trainer's epochs."""
    def val_epochs(cls):
        t = object.__new__(cls)
        t.epoch, calls = start, []
        t.call_hook = lambda name: None

        def train_epoch(loader):
            t.epoch += 1

        t.train_epoch = train_epoch
        t.val = lambda loader, dataset: calls.append((t.epoch, loader, dataset))
        cls.run(t, "train", max_epochs, val_loader="val", val_dataset="ds",
                val_interval=interval)
        return calls

    got = val_epochs(Trainer)
    assert got == val_epochs(JaxTrainer)
    assert all(c[1:] == ("val", "ds") for c in got) and (got[-1][0] == max_epochs
                                                        if interval else not got)


@pytest.fixture(scope="module")
def trained(records, tmp_path_factory):
    """tools/train.py on the tiny distillation config's data block (window
    engine, seeded teacher), 1 epoch of 2 steps."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _config(records, tmp, "configs/tests/distill_tiny.py", True, WINDOW)
    work = str(tmp / "work")
    trainer = train_cli.main([cfg, "--work_dir", work, "--device", "cpu"])
    return cfg, work, trainer


