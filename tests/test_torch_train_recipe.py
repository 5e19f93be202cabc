"""The flagship recipe's two configs against the zoo's rows."""
import pytest

from sparse2dense_tpu import zoo
from sparse2dense_tpu_torch.utils.config import ConfigDict, DENSE_TEACHER, FLAGSHIP

from tests.test_torch_train_runtime import _plain


@pytest.mark.parametrize("variant,path", [("3x_dense_interval_5", DENSE_TEACHER),
                                          ("3x_distill_interval_5", FLAGSHIP)])
def test_recipe_configs_against_the_zoo(variant, path):
    """The port's two recipe configs are the reference zoo rows, key for
    key, the data layer's entries and the voxel generator's data-pipeline
    flag included; the one exemption is the flagship's teacher checkpoint,
    which is not in the repository."""
    want, got = zoo.waymo_voxelnet(variant), ConfigDict.fromfile(path)
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if key != "load_from":
            assert repr(_plain(value)) == repr(_plain(want[key])), key
    assert got["load_from"] is None
