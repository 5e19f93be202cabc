"""The pillar recipe: BatchNorm's pillar count as the reference's, the recipe
configs against the zoo, and the CLI chain teacher -> distil on
``configs/tests/pp_tiny.py``."""
import copy
import os

import numpy as np
import pytest
import torch

from sparse2dense_tpu import zoo
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.utils.config import ConfigDict, PP, PP_DENSE

from tests.test_torch_pp import CFG, _plain, models  # noqa: F401 (fixtures)


def test_pillar_batchnorm_counts_pillars_as_the_reference(models):
    """The reference's pillar net sums its BatchNorm statistics over every
    point slot of the real pillars but divides by the number of pillars (its
    mask is one value a pillar), so its mean is P times the slot mean; the
    port copies it (the pillar net's statistics above equal JAX's)."""
    reader = copy.deepcopy(models["student"].reader).train()
    batch = models["batch"]
    norm = reader.pfn_0.norm
    seen = []
    hook = norm.register_forward_hook(lambda m, a, out: seen.append(a[0].detach()))
    before = norm.running_mean.clone()
    with torch.no_grad():
        reader(batch["voxels"], batch["num_points"], batch["coordinates"])
    hook.remove()
    x, real = seen[0], (batch["num_points"] > 0)[..., None, None].float()
    mean = (x * real).sum((0, 1, 2)) / real.sum()
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               (0.99 * before + 0.01 * mean).numpy(), rtol=1e-5, atol=1e-6)
    assert batch["voxels"].shape[2] == 8 and bool((mean.abs() > 0).all())


@pytest.mark.parametrize("variant,path", [("dense_interval_5", PP_DENSE),
                                          ("distill_interval_5", PP)])
def test_pp_recipe_configs_against_the_zoo(variant, path):
    """The port's two pillar configs are the reference zoo rows, key for
    key, the data layer's entries included; the one exemption is the
    distillation's teacher checkpoint, which is not in the repository. At
    full width they build the recipe's models."""
    want, got = zoo.waymo_pp(variant), ConfigDict.fromfile(path)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None
    assert (variant == "distill_interval_5") == bool(got["distillation"])
    model = build_detector(got.S_model, test_cfg=got.test_cfg,
                           voxel_generator=got.voxel_generator, device="cpu")
    assert model.backbone.grid_shape == (468, 468)
    assert [getattr(model.reader, f"pfn_{i}").linear.weight.shape for i in (0, 1)] == \
        [(32, 10), (64, 64)]
    assert model.neck.block_2.down.conv.weight.shape == (256, 128, 3, 3)
    assert model.bbox_head.shared_conv.weight.shape[1] == 384


def test_cli_runs_the_pp_recipe_chain(tmp_path):
    """``tools/train.py`` on the tiny pair: the dense teacher writes
    ``epoch_1``, the distillation loads it (``--load_from``), trains and is
    resumed from ``latest``."""
    from sparse2dense_tpu_torch.tools import train as cli
    from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint

    base = open(CFG).read()
    dense = tmp_path / "pp_dense.py"
    dense.write_text(base + "\nS_model['reader']['num_filters'] = [32, 64]\n"
                     "S_model['backbone']['num_input_features'] = 64\n"
                     "S_model['neck']['num_input_features'] = 64\n")
    distil = tmp_path / "pp_distill.py"
    distil.write_text(dense.read_text() + "\nimport copy\nmodel = copy.deepcopy(S_model)\n"
                      "S_model['type'] = 'KD_PointPillars'\n"
                      "S_model['backbone']['type'] = 'PointPillarsScatter_S2D'\n"
                      "distillation = True\n")
    common = ["--device", "cpu", "--max_voxels", "256", "--batch_size", "1"]
    trainer = cli.main([str(dense), "--work_dir", str(tmp_path / "d"), "--synthetic", "1",
                        "--epochs", "1"] + common)
    assert trainer.epoch == 1
    ckpt = str(tmp_path / "d" / "epoch_1")
    work = tmp_path / "s"
    trainer = cli.main([str(distil), "--work_dir", str(work), "--load_from", ckpt,
                        "--synthetic", "2", "--epochs", "1"] + common)
    assert trainer.branch == "pp" and trainer.global_iter == 2
    saved, teacher = load_checkpoint(ckpt)[0]["model"], trainer.teacher.state_dict()
    assert sorted(saved) == sorted(teacher)
    assert all(torch.equal(teacher[k], v) for k, v in saved.items())
    resumed = cli.main([str(distil), "--work_dir", str(work), "--load_from", ckpt,
                        "--synthetic", "2", "--epochs", "2",
                        "--resume_from", str(work / "latest")] + common)
    assert resumed.epoch == 2 and resumed.global_iter == 4
    assert os.readlink(work / "latest") == "epoch_2"
