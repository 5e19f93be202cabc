"""The pillar student built from ``configs/tests/pp_tiny.py``
(``tests/test_torch_pp.py``'s ``models``): the builder's pillar grid, no PCR
in eval mode, and ``from_flax`` on its eval and train trees."""
import numpy as np
import pytest
import torch

import jax

from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.training.distill import branch_of

from tests.test_torch_layers import rand_variables
from tests.test_torch_pp import models  # noqa: F401 (fixtures)


def test_builder_sets_the_pillar_grid(models):
    teacher, student = models["teacher"], models["student"]
    assert teacher.backbone.grid_shape == student.backbone.grid_shape == (32, 32)
    assert teacher.backbone.bev_channels == student.backbone.bev_channels == 64
    assert student.pc_range_full == tuple(models["tcfg"].voxel_generator["range"])
    assert branch_of(models["tcfg"].model) == "pp"


def test_kd_point_pillars_eval_has_no_pcr(models):
    with torch.no_grad():
        out = models["student"].eval()(models["batch"])
    assert out["gen_offset"] is None and out["gen_mask"] is None
    assert out["f_s_a"].shape == (2, 32, 32, 64)


@pytest.mark.parametrize("train", [False, True], ids=["eval_tree", "train_tree"])
def test_from_flax_on_the_student(models, train):
    """An eval-mode tree lacks the S2D scatter's train-only PCR generators
    (they keep the model's own values); a train-mode tree maps every key.
    The PFN's Dense kernels (in, out) become Linear weights (out, in)."""
    js, student = models["jstudent"], models["student"]
    variables = rand_variables(
        lambda: js.init(jax.random.PRNGKey(2), models["jbatch"], train=train), seed=21)
    gens = {"generator_a", "generator_b", "gen_out", "gen_mask_a", "gen_mask_b"}
    assert (gens <= set(variables["params"]["backbone"])) == train
    sd = from_flax(variables, student)
    own = student.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        if k.startswith("backbone.") and k.split(".")[1] in gens:
            assert torch.equal(v, own[k]) != train, k
    kernel = variables["params"]["reader"]["pfn_0"]["linear"]["kernel"]
    np.testing.assert_array_equal(sd["reader.pfn_0.linear.weight"].numpy(),
                                  np.asarray(kernel).T)
