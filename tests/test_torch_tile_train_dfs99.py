"""``tests/test_torch_tile_train_backbone.py``'s tests of the tile backbone
in train mode against the gather engine, at ``dense_from_stage`` 99."""
import pytest

from tests.test_torch_tile_train_backbone import (  # noqa: F401 (tests)
    make_backbones, test_tile_train_backends_agree_bit_for_bit,
    test_tile_train_bev_and_statistics_match_gather, test_tile_train_counters_are_zero,
    test_tile_train_gradients_match_gather)


@pytest.fixture(scope="module", params=[99], ids=["dfs99"])
def backbones(request):
    return make_backbones(request.param)
