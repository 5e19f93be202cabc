"""Rematerialisation on against off (``tests/test_torch_remat.py``'s ``runs``):
the gradients equal, and the BatchNorm running statistics moved once a step."""
import pytest

from tests.test_torch_remat import _close, one_thread, runs  # noqa: F401 (fixtures)


@pytest.mark.parametrize("tag", ["ts", "teacher"])
def test_remat_gradients_equal(runs, tag):
    _close(runs[True][tag]["grads"], runs[False][tag]["grads"], "gradients")


@pytest.mark.parametrize("tag", ["ts", "teacher"])
def test_remat_bn_statistics_move_once(runs, tag):
    _close(runs[True][tag]["stats"], runs[False][tag]["stats"], "running statistics")
