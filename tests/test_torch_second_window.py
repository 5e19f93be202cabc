"""``tests/test_torch_second_backbone.py``'s tests of SpMiddleFHD in train
mode against JAX, on the window engine at the shipped ``dense_from_stage``
1 (subm0 and down1 on the window pass, their residual rows within budget)."""
import pytest

from tests.test_torch_second_backbone import (  # noqa: F401 (tests)
    make_backbone, test_spmiddlefhd_telemetry, test_spmiddlefhd_train_batchnorm_statistics,
    test_spmiddlefhd_train_bev)


@pytest.fixture(scope="module", params=[("window", 1)], ids=["window"])
def backbone(request):
    return make_backbone(*request.param)
