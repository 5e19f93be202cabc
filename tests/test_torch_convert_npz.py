"""The JAX package's checkpoints in the port, on the CPU: a JAX
``save_checkpoint`` (an Orbax directory) goes through the README's lines
(``load_checkpoint``, a flatten, ``np.savez``) into ``convert.from_npz``,
which must give ``from_flax`` of the live tree to the bit; and the
two-stage tree's names (``single_det/...``, ``roi_head/...``) are the
reference's init, so ``from_flax`` carries a two-stage tree over, a frozen
KD first stage's PCR generators kept from the model."""
import numpy as np
import torch

import jax

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.training.checkpoint import load_checkpoint, save_checkpoint
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax, from_npz, is_pcr_key
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import flax_shapes, rand_variables


def readme_npz(ckpt_dir, out_path):
    """README, "JAX checkpoints": the lines that flatten a JAX checkpoint
    to the ``.npz`` that ``from_npz`` reads (run where JAX runs)."""
    tree, _ = load_checkpoint(ckpt_dir)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(out_path, **flat)


def test_from_npz_of_a_jax_checkpoint_equals_from_flax(tmp_path):
    """distill_tiny's teacher: its Flax tree saved as the JAX trainer saves
    one (params, batch_stats, an optimizer state, the step), flattened by
    the README's lines, read by ``from_npz``: the ``state_dict`` equals
    ``from_flax`` of the tree to the bit, the optimizer's entries left
    out."""
    cfg = ConfigDict.fromfile("configs/tests/distill_tiny.py")
    teacher = build_detector(cfg.model, test_cfg=cfg.test_cfg,
                             voxel_generator=cfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(teacher), seed=9)
    opt = jax.tree_util.tree_map(lambda a: np.zeros_like(a) + 0.5, variables["params"])
    save_checkpoint(str(tmp_path), "epoch_1", dict(variables, opt_state={"mu": opt},
                                                  step=np.int32(7)), meta={"epoch": 1})
    readme_npz(str(tmp_path / "latest"), tmp_path / "teacher.npz")
    assert any(k.startswith("opt_state/") for k in np.load(tmp_path / "teacher.npz").files)
    got, want = from_npz(str(tmp_path / "teacher.npz"), teacher), from_flax(variables, teacher)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    teacher.load_state_dict(got)


def test_two_stage_tree_is_the_reference_init():
    """two_stage_tiny with a KD_PointPillars first stage (the S2D scatter):
    ``flax_shapes`` of the port's model equals ``jax.eval_shape`` of the
    reference's eval-mode init leaf for leaf (no PCR generators: the frozen
    first stage runs in eval), and ``from_flax`` of such a tree fills every
    entry but those generators, which keep the model's values."""
    path = "configs/tests/two_stage_tiny.py"
    jcfg, tcfg = Config.fromfile(path), ConfigDict.fromfile(path)
    for cfg in (jcfg, tcfg):
        cfg.S_model["first_stage_cfg"]["type"] = "KD_PointPillars"
        cfg.S_model["first_stage_cfg"]["backbone"]["type"] = "PointPillarsScatter_S2D"
    jm = jax_build_detector(jcfg.S_model, train_cfg=jcfg.train_cfg, test_cfg=jcfg.test_cfg,
                            voxel_generator=jcfg.voxel_generator)
    batch = jax_make_batch(jcfg, 1, max_voxels=64, n_points=300, n_obj=2, with_targets=False)
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, train=False))
    model = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                           voxel_generator=tcfg.voxel_generator, device="cpu")

    def flat(tree):
        return [(jax.tree_util.keystr(p), tuple(leaf.shape))
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]

    shapes = flax_shapes(model)
    assert flat(shapes) == flat({k: want[k] for k in ("params", "batch_stats")})
    assert "roi_head" in shapes["params"] and "single_det" in shapes["batch_stats"]
    assert not any("second_stage" in k for k, _ in flat(shapes))
    state = from_flax(rand_variables(shapes, seed=2), model)
    before = model.state_dict()
    pcr = [k for k in before if is_pcr_key(k.split("."))]
    assert pcr and all(k.startswith("single_det.backbone.gen") for k in pcr)
    for k, v in state.items():
        assert torch.equal(v, before[k]) == (k in pcr or "num_batches" in k), k
    model.load_state_dict(state)
