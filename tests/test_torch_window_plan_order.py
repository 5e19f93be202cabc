"""The plan order B1's window search relies on, for subm, strided and z-only
plans."""
import pytest
import torch

from sparse2dense_tpu_torch.ops import window_conv as WC

from tests.test_torch_window_layout import _plans


@pytest.mark.parametrize("kind", ["subm", "strided", "z-only"])
def test_plan_order_the_search_relies_on(kind):
    plan = _plans()[kind]
    lin = plan.lin[plan.lin < WC.MISS]
    assert bool((lin[1:] > lin[:-1]).all())                     # sorted, unique
    off = plan.offsets.reshape(3, 3, 3)                          # (dy, dx, dz)
    assert torch.equal(off - off[:, :, :1], torch.arange(3).int().expand(3, 3, 3))
    kb = plan.kbase.view(-1, plan.block, 3)
    gated = kb == WC.GATE
    assert bool(gated.any()) and bool((~gated).any())           # both kinds of rows
    for g in range(3):
        for j in range(9):
            t = kb[:, :, g] + plan.offsets[g, j]
            for b in range(kb.shape[0]):
                row = t[b][~gated[b, :, g]]
                assert bool((row[1:] > row[:-1]).all()), (kind, g, j, b)
