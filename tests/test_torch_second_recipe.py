"""The SECOND recipe configs against the zoo's rows."""
import pytest

from sparse2dense_tpu import zoo
from sparse2dense_tpu_torch.core.box_coder import build_box_coder
from sparse2dense_tpu_torch.utils.config import ConfigDict, SECOND, SECOND_DENSE

from tests.test_torch_second import _plain


@pytest.mark.parametrize("variant,path", [("dense_interval_5", SECOND_DENSE),
                                          ("distill_interval_5", SECOND)])
def test_second_recipe_configs_against_the_zoo(variant, path):
    """The port's two SECOND configs are the reference zoo rows, key for
    key, the data layer's entries included; the one exemption is the
    distillation's teacher checkpoint, which is not in the repository. The
    heads' box coder is its config dict in the port."""
    want, got = zoo.waymo_second(variant), ConfigDict.fromfile(path)
    for key in ("model", "S_model"):
        if key in got:
            head = got[key]["bbox_head"]
            head["box_coder"] = build_box_coder(head["box_coder"])
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None
    assert (variant == "distill_interval_5") == bool(got["distillation"])
