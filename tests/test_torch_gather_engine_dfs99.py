"""``tests/test_torch_gather_engine.py``'s backbone tests with
``dense_from_stage`` 99 (every stage sparse, ``extra_conv`` too): the stages' modules, and the
BEV map (and in training the BN running statistics and a gradient) against
JAX in eval and in train mode."""
import pytest

from tests.test_torch_gather_engine import (  # noqa: F401 (fixtures and tests)
    frame, jax_refs, make_backbone, test_gather_backbone_against_jax,
    test_gather_modules_by_stage)


@pytest.fixture(scope="module", params=[99], ids=lambda d: f"dfs{d}")
def backbone(request):
    return make_backbone(request.param)
