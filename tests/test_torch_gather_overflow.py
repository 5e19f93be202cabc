"""The gather oracle's strided active sets bit-exact against JAX when the
active set overflows its budget of 60 (``tests/test_torch_gather_oracle.py``'s
scenes)."""
import pytest

from tests.test_torch_gather_oracle import STRIDED, check_downsample


@pytest.mark.parametrize("stride,padding,ksize", STRIDED)
@pytest.mark.parametrize("budget", [60])   # the active set overflows
def test_downsample_bit_exact(stride, padding, ksize, budget):
    check_downsample(stride, padding, ksize, budget)
