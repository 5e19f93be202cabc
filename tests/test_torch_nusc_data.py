"""The nuScenes data layer against the JAX package's, on nuScenes-layout
records written here (``training/synthetic.write_nusc_records``: 3 samples,
a key frame of 600 points and 10 sweeps of 300, float32 ``.bin`` rows of
5, infos with 9-dof boxes, one with NaN velocities): ``NuScenesDataset``'s
examples (train, with the augmentations; the double-flip val pipeline's 4
bundles) and their ``collate`` bit-equal; ``evaluation``'s results json
equal; and the double-flip keying of ``Trainer.val``.

The sweeps a sample reads are drawn without replacement; the reference
draws them from NumPy's global generator, so it is seeded with the port's
sample key before each of its samples (``tests/test_torch_data.py``'s
rule), and both read the same sweeps in the same order."""
import copy
import json

import numpy as np
import pytest

from sparse2dense_tpu.data import loader as jloader
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.data import loader as tloader
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import NUSC_CLASSES, write_nusc_records
from sparse2dense_tpu_torch.training.trainer import Trainer
from sparse2dense_tpu_torch.utils.config import NUSC_VOXELNET, ConfigDict

from tests.test_torch_data import SeededJaxDataset, assert_same
from tests.test_torch_nusc_model import TINY, nusc_tiny, tiny_variables

N_SAMPLES = 3
TINY_RANGE = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)   # voxelnet_tiny's


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    info = write_nusc_records(root, N_SAMPLES, 600, sweep_points=300, n_obj=5,
                              pc_range=TINY_RANGE)
    return dict(root=root, info_path=info)


def _data_cfg(records, split, voxel_generator=None):
    """The 0075voxel_dcn_flip recipe's ``data[split]`` on the records (with
    another voxel generator, if given, in its Voxelization stage)."""
    cfg = copy.deepcopy(dict(ConfigDict.fromfile(NUSC_VOXELNET["0075voxel_dcn_flip"]).data[split]))
    cfg.update(info_path=records["info_path"], root_path=records["root"])
    if voxel_generator is not None:
        for stage in cfg["pipeline"]:
            if stage["type"] == "Voxelization":
                stage["cfg"] = voxel_generator
    return cfg


@pytest.mark.parametrize("split", ["train", "val"])
def test_nusc_dataset_examples_and_collate_bit_equal(records, split):
    cfg = _data_cfg(records, split)
    port = tloader.build_dataset(copy.deepcopy(cfg))
    jax_side = SeededJaxDataset(jloader.build_dataset(copy.deepcopy(cfg)))
    examples = [port[i] for i in range(N_SAMPLES)]
    want = [jax_side[i] for i in range(N_SAMPLES)]
    for i, (got, ref) in enumerate(zip(examples, want)):
        assert_same(got, ref, f"{split} sample {i}")
    batch = tloader.collate(examples, 3000)
    assert_same(batch, jloader.collate(want, 3000), "collate")
    if split == "train":
        assert "hm" in batch and batch["voxels"].shape[0] == N_SAMPLES
        assert max(np.abs(a[..., 6:8]).max() for a in batch["anno_box"]) > 0.5
    else:   # 4 views a sample, each view's metadata its sample's
        assert isinstance(examples[0], list) and len(examples[0]) == 4
        assert batch["voxels"].shape[0] == 4 * N_SAMPLES
        assert [m["token"] for m in batch["metadata"]] == [
            f"sample_{i}" for i in range(N_SAMPLES) for _ in range(4)]
        coords = batch["coordinates"]
        assert (coords[0] >= 0).all(-1).sum() > 1000
    # the key frame (time lag 0) and 9 of the 10 sweeps, each within 1 m
    # of the sensor in x and y removed
    pts = (examples[0] if split == "train" else examples[0][0])["points"]
    assert pts.shape[1] == 5 and len(np.unique(pts[:, 4])) == 10


def test_nusc_evaluation_json_equal_to_jax(records, tmp_path):
    """The results json of the same detections (valid masks, 9-dof boxes)
    from both packages, and (None, None) without the devkit."""
    cfg = _data_cfg(records, "val")
    port = tloader.build_dataset(copy.deepcopy(cfg))
    jax_ds = jloader.build_dataset(copy.deepcopy(cfg))
    rng = np.random.RandomState(0)
    dets = {}
    for info in port.infos:
        n = 7
        dets[info["token"]] = {
            "box3d_lidar": rng.uniform(-5, 5, (n, 9)).astype(np.float32),
            "scores": rng.uniform(0, 1, n).astype(np.float32),
            "label_preds": rng.randint(0, len(NUSC_CLASSES), n),
            "valid": rng.rand(n) > 0.3}
    out = {}
    for name, ds in (("port", port), ("jax", jax_ds)):
        d = tmp_path / name
        assert ds.evaluation(dets, output_dir=str(d)) == (None, None)
        with open(d / "infos_pred_nusc.json") as f:
            out[name] = json.load(f)
    assert out["port"] == out["jax"]
    results = out["port"]["results"]
    assert sorted(results) == sorted(dets)
    assert sum(len(v) for v in results.values()) == sum(int(d["valid"].sum())
                                                        for d in dets.values())


def test_trainer_val_keys_each_double_flip_frame(records, tmp_path):
    """``Trainer.val`` over two frames a batch under double flip (8 views,
    merged to 2 rows) gives each frame its own token, and each token's
    detections equal that frame's alone (batch 1), within 1e-6. The
    reference keys row b
    by ``metadata[b]``, so it would key both rows by the first frame's
    token (ROADMAP Queue 3)."""
    cfg = nusc_tiny(ConfigDict.fromfile(TINY))
    vg = dict(cfg.voxel_generator, double_flip=True)
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg, voxel_generator=vg,
                           device="cpu")
    model.load_state_dict(from_flax(tiny_variables(model, seed=5), model))
    dataset = tloader.build_dataset(_data_cfg(records, "val", vg))
    # an even count; the copy draws its own sweeps (its sample key differs)
    dataset.infos.append(dict(dataset.infos[0], token="sample_3"))
    trainer = Trainer(model, OneCycleAdam(model.parameters(), cfg.optimizer, cfg.lr_config, 4),
                      work_dir=str(tmp_path), hooks=[])
    got = {}
    for batch_size in (2, 1):
        loader = tloader.InputPipeline(dataset, batch_size, 512, shuffle=False, device="cpu")
        trainer.val(loader, dataset, output_dir=str(tmp_path / f"val{batch_size}"))
        with open(tmp_path / f"val{batch_size}" / "infos_pred_nusc.json") as f:
            got[batch_size] = json.load(f)["results"]
    tokens = [f"sample_{i}" for i in range(N_SAMPLES + 1)]
    assert sorted(got[2]) == sorted(got[1]) == tokens
    for token in tokens:   # numbers within 1e-6: the CPU's convs round 8 views otherwise than 4
        assert len(got[2][token]) == len(got[1][token]) > 0, token
        for a, b in zip(got[2][token], got[1][token]):
            assert sorted(a) == sorted(b) and a["sample_token"] == b["sample_token"] == token
            for k, v in a.items():
                if isinstance(v, str):
                    assert v == b[k], (token, k)
                else:
                    np.testing.assert_allclose(v, b[k], rtol=1e-6, atol=1e-6,
                                               err_msg=f"{token} {k}")

    def boxes(token):
        return [{k: v for k, v in d.items() if k != "sample_token"} for d in got[1][token]]

    assert boxes("sample_0") != boxes("sample_1")   # the frames' own detections


def jax_double_flip_keys(batch_size=2):
    """The JAX package's ``Trainer.val`` over the double-flip val records
    (``nusc_pp_tiny`` with double flip, seeded weights) at ``batch_size``
    frames a batch: the tokens it keys its detections by."""
    import tempfile

    import jax
    import optax

    from sparse2dense_tpu.models import build_detector as jax_build_detector
    from sparse2dense_tpu.training.train_state import TrainState
    from sparse2dense_tpu.training.trainer import Trainer as JaxTrainer
    from sparse2dense_tpu.utils import Config

    root = tempfile.mkdtemp()
    records = dict(root=root, info_path=write_nusc_records(
        root, 4, 600, sweep_points=300, n_obj=5, pc_range=TINY_RANGE))
    cfg = Config.fromfile("configs/tests/nusc_pp_tiny.py")
    cfg.test_cfg.update(double_flip=True)
    vg = dict(cfg.voxel_generator, double_flip=True)
    model = jax_build_detector(cfg.S_model, test_cfg=cfg.test_cfg)
    dataset = jloader.build_dataset(_data_cfg(records, "val", vg))
    loader = jloader.InputPipeline(dataset, batch_size=batch_size, max_voxels=512,
                                   shuffle=False, to_device=False)
    sample = next(iter(loader))
    sample.pop("metadata")
    variables = model.init(jax.random.PRNGKey(0), sample, train=False)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats", {}), tx=optax.sgd(0.0))
    trainer = JaxTrainer(model, state, work_dir=root, hooks=[])
    trainer.val(jloader.InputPipeline(dataset, batch_size=batch_size, max_voxels=512,
                                      shuffle=False), dataset)
    with open(f"{root}/eval/infos_pred_nusc.json") as f:
        return sorted(json.load(f)["results"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_nusc_data
    print("JAX Trainer.val, 4 double-flip frames, batch 2:", jax_double_flip_keys(2))
    print("JAX Trainer.val, 4 double-flip frames, batch 1:", jax_double_flip_keys(1))
