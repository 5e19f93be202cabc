"""The det3d checkpoint converter (``tools/convert_checkpoint.py``) against
the JAX package's converter followed by ``convert.from_flax``, on the CPU.

A det3d-layout state dict is made from each rule of the JAX converter that
lands on a leaf of the model's Flax tree (its torch shape by inverting the
rule's layout transform; values from a seeded numpy generator), plus keys
no rule matches, a ``module.`` prefix, a BatchNorm's ``num_batches_tracked``
and an entry of the wrong shape. The port's converter must give the same
``state_dict`` to the bit, the same unmatched keys and the same skipped
paths as JAX's ``convert_state_dict`` + ``apply_to_variables`` + the
port's ``from_flax``; the command line writes a checkpoint that
``--load_from`` / ``--checkpoint``'s loader reads back; a two-stage config
maps its first stage's keys onto ``single_det``."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu.tools import convert_checkpoint as jconv
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.tools import convert_checkpoint as tconv
from sparse2dense_tpu_torch.training.checkpoint import load_checkpoint, merge_params
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_convert_checkpoint import _fake_torch_key
from tests.test_torch_layers import flax_shapes, rand_variables

# the det3d layout of a Flax leaf, by the transform its rule applies
_TORCH_SHAPE = {
    "t_conv2d": lambda s: (s[3], s[2], s[0], s[1]),
    "t_convt2d": lambda s: (s[2], s[3], s[0], s[1]),
    "t_linear": lambda s: (s[1], s[0]),
    "t_spconv": lambda s: {27: (3, 3, 3), 3: (3, 1, 1), 1: (1, 1, 1)}[s[0]] + tuple(s[1:]),
    "t_id": lambda s: tuple(s),
}


def det3d_state_dict(model_cfg, variables, seed=0):
    """A det3d ``state_dict`` (NumPy) with one entry for each rule
    instance that lands on a leaf of ``variables``, then the odd ones."""
    leaves = {}
    for coll, tree in variables.items():
        stack = [((coll,), tree)]
        while stack:
            path, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((path + (k,), v))
                else:
                    leaves[path + (k,)] = np.shape(v)
    rng = np.random.RandomState(seed)
    sd = {}
    for pat, path_tpl, tf in jconv.rules_for_model(dict(model_cfg)):
        for groups in [(str(i),) for i in range(4)]:
            key = _fake_torch_key(pat, groups)
            path = tuple(seg.format(*groups) if "{" in seg else seg for seg in path_tpl)
            if path not in leaves or key in sd:
                continue
            w = rng.randn(*_TORCH_SHAPE[tf.__name__](leaves[path])).astype(np.float32)
            assert tf(w).shape == leaves[path], (key, path)
            sd[key] = w
    assert len(sd) > 20
    first = sorted(sd)[0]
    sd["module." + first] = sd.pop(first)                    # DataParallel's prefix
    sd["roi_head.shared_fc_layer.0.weight"] = rng.randn(4, 3).astype(np.float32)
    sd["backbone.unknown.weight"] = rng.randn(2).astype(np.float32)
    sd["neck.blocks.0.2.num_batches_tracked"] = np.asarray(5)
    wrong = sorted(k for k in sd if k.endswith("bias"))[0]   # matched, wrong shape
    sd[wrong] = np.zeros(sd[wrong].shape[0] + 1, np.float32)
    return sd


@pytest.fixture(scope="module", params=["voxelnet_tiny.py", "pp_tiny.py", "second_tiny.py"])
def case(request):
    cfg = ConfigDict.fromfile(f"configs/tests/{request.param}")
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(model), seed=3)
    model.load_state_dict(from_flax(variables, model))
    return cfg, model, variables, det3d_state_dict(cfg.S_model, variables)


def test_converter_equals_jax_converter_then_from_flax(case):
    cfg, model, variables, sd = case
    nested, j_unmatched = jconv.convert_state_dict(sd, cfg.S_model)
    j_vars, j_skipped = jconv.apply_to_variables(variables, nested)
    want = from_flax(j_vars, model)
    got, unmatched, skipped = tconv.convert_state_dict(sd, cfg.S_model, model)
    assert unmatched == j_unmatched and len(unmatched) >= 2
    assert skipped == j_skipped and len(skipped) == 1
    assert sorted(got) == sorted(model.state_dict())
    moved = 0
    for k, v in got.items():
        w = want.get(k, model.state_dict()[k])
        assert v.dtype == w.dtype and torch.equal(v, w), k
        moved += not torch.equal(v, model.state_dict()[k])
    assert moved >= len(sd) - len(unmatched) - 3


def test_cli_writes_a_checkpoint_that_load_from_reads(tmp_path):
    """``main``: a det3d ``.pth`` ({"state_dict", "meta"}) of voxelnet_tiny
    -> ``<out>/converted`` in the port's format (meta "source"), read by
    ``load_checkpoint`` + ``merge_params`` into the model as the converter
    gives it; with a two-stage config (two_stage_tiny, a pillar first
    stage) the same keys, with or without det3d's ``single_det.`` prefix,
    land on ``single_det``."""
    path = "configs/tests/voxelnet_tiny.py"
    cfg = ConfigDict.fromfile(path)
    model = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu")
    sd = det3d_state_dict(cfg.S_model, rand_variables(flax_shapes(model), seed=4))
    pth = tmp_path / "epoch_30.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "meta": {"epoch": 30, "config": "..."}}, pth)
    out = tconv.main([path, str(pth), str(tmp_path / "out")])
    state, meta = load_checkpoint(out)
    assert meta == {"source": str(pth)} and out.endswith("converted")
    fresh = build_detector(cfg.S_model, test_cfg=cfg.test_cfg,
                           voxel_generator=cfg.voxel_generator, device="cpu")
    fresh.load_state_dict(merge_params(fresh.state_dict(), state["model"]))
    want = tconv.convert_state_dict(sd, cfg.S_model, model)[0]
    assert all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())

    two = ConfigDict.fromfile("configs/tests/two_stage_tiny.py")
    ts = build_detector(two.S_model, test_cfg=two.test_cfg,
                        voxel_generator=two.voxel_generator, device="cpu")
    single = ts.single_det
    pp_sd = det3d_state_dict(two.S_model["first_stage_cfg"],
                             rand_variables(flax_shapes(single), seed=5))
    alone = tconv.convert_state_dict(pp_sd, two.S_model["first_stage_cfg"], single)
    prefixed = {(k.replace("module.", "module.single_det.") if k.startswith("module.")
                 else "single_det." + k): v for k, v in pp_sd.items()}
    for det3d in (pp_sd, prefixed):
        got, unmatched, skipped = tconv.convert_state_dict(det3d, two.S_model, ts)
        assert len(unmatched) == len(alone[1]) and len(skipped) == len(alone[2]) == 1
        for k, v in alone[0].items():
            assert torch.equal(got["single_det." + k], v), k
        assert all(torch.equal(v, ts.state_dict()[k]) for k, v in got.items()
                   if not k.startswith("single_det."))
