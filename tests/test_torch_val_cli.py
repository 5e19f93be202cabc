"""The CLIs on records (moved from ``tests/test_torch_val.py``, whose records
and ``trained`` fixture they use): ``tools/train.py`` on the tiny distillation
config's data block (window engine) for an epoch, ``tools/test.py`` on its
checkpoint, and the stages of later slices: what the port leaves to them
raises and names itself, what they ported builds."""
import os

import numpy as np
import pytest

from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.data.pipelines.formating import Reformat, build_pipeline
from sparse2dense_tpu_torch.data.pipelines.loading import LoadPointCloudFromFile
from sparse2dense_tpu_torch.data.pipelines.preprocess import Voxelization
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.tools import test as test_cli
from sparse2dense_tpu_torch.training.trainer import predict
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_val import N_FRAMES, one_thread, records, trained  # noqa: F401 (fixtures)


def test_train_cli_on_records(trained):
    cfg, work, trainer = trained
    assert (trainer.epoch, trainer.global_iter) == (1, 2)
    assert type(trainer).__name__ == "TS_Trainer"
    history = trainer.log_buffer.val_history
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    assert min(history["grad_norm"]) > 0
    assert sorted(os.listdir(work)) == ["epoch_1", "latest"]


def test_test_cli_evaluates_the_checkpoint(trained, tmp_path):
    cfg, work, trainer = trained
    out = str(tmp_path / "eval")
    detections, (result, _), times = test_cli.main(
        [cfg, "--checkpoint", os.path.join(work, "latest"), "--work_dir", out,
         "--device", "cpu", "--speed_test"])
    assert sorted(detections) == [f"frame_{i}" for i in range(N_FRAMES)]
    assert len(times) == N_FRAMES - 2
    assert os.path.exists(os.path.join(out, "detection_pred.pkl"))
    assert 0.0 <= result["local_bev_mAP"] <= 1.0
    # the student evaluated is the checkpoint's
    c = ConfigDict.fromfile(cfg)
    model = build_detector(c.S_model, test_cfg=c.test_cfg, voxel_generator=c.voxel_generator,
                           device="cpu")
    model.load_state_dict(trainer.model.state_dict())
    want = predict(model, tloader.InputPipeline(tloader.build_dataset(c.data["val"]), 1, 512,
                                                shuffle=False, device="cpu"))
    assert sorted(want) == sorted(detections)
    for token, det in want.items():
        for k, v in det.items():
            np.testing.assert_array_equal(detections[token][k], v, err_msg=f"{token} {k}")


def test_later_slices_raise_and_name_their_item(trained, tmp_path, monkeypatch):
    cfg = trained[0]
    # data parallelism is ported: without torchrun's environment it raises
    # and names what is missing
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                                           "MASTER_PORT not set"):
        test_cli.main([cfg, "--device", "cpu", "--launcher", "pytorch"])
    # the nuScenes stages are ported (the nuScenes families' slice): they
    # build; a dataset the port does not know raises and names itself
    stages = build_pipeline([dict(type="DoubleFlip"), dict(type="Reformat", double_flip=True)])
    assert [type(t).__name__ for t in stages.transforms] == ["DoubleFlip", "Reformat"]
    assert Reformat(double_flip=True).double_flip
    assert Voxelization(cfg=dict(ConfigDict.fromfile(cfg).voxel_generator,
                                 double_flip=True)).double_flip
    assert LoadPointCloudFromFile(dataset="NuScenesDataset").type == "NuScenesDataset"
    nusc = tloader.build_dataset(dict(type="NuScenesDataset", pipeline=[],
                                      info_path=str(tmp_path / "infos.pkl"),
                                      root_path=str(tmp_path)))
    assert type(nusc).__name__ == "NuScenesDataset"
    with pytest.raises(NotImplementedError, match="KittiDataset"):
        LoadPointCloudFromFile(dataset="KittiDataset")
    with pytest.raises(NotImplementedError, match="KittiDataset"):
        tloader.build_dataset(dict(type="KittiDataset", pipeline=[]))
