"""Host side of the window-pass kernel (csrc/window_pass.cu): its weight
layout (window_kernel.window_weights) goes back to (27, Cin, Cout) bit for
bit and is zero past Cin, and the plans of ops/window_conv.py have the order
its search relies on: window keys sorted and unique, and the three dz taps
of a (dy, dx) run on consecutive keys. The test also records that each tap's
targets rise with the row inside a block, GATE rows aside: the kernel does
not use this (it searches each row), but a merge of its searches along the
rows would."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import window_conv as WC
from sparse2dense_tpu_torch.ops import window_kernel as WK

GRID = (9, 40, 40)


@pytest.mark.parametrize("cin,cout", [(5, 16), (16, 16), (16, 32), (32, 32)])
def test_window_weights_round_trip(cin, cout):
    w = torch.from_numpy(np.random.RandomState(cin + cout).randn(27, cin, cout)
                         .astype(np.float32)).to(torch.bfloat16)
    wl = WK.window_weights(w)
    pad = WK.cin_pad(cin)
    assert wl.shape == (27, cout, pad + 8) and wl.is_contiguous()
    assert torch.equal(wl[:, :, :cin].transpose(1, 2), w)
    assert not wl[:, :, cin:].any()
    # the kernel's byte address of weight (k, ci, co): rows of (pad + 8) bf16
    k, ci, co = np.meshgrid(np.arange(27), np.arange(cin), np.arange(cout), indexing="ij")
    at = (k * cout + co) * (pad + 8) + ci
    assert torch.equal(wl.reshape(-1)[torch.from_numpy(at.reshape(-1))], w.reshape(-1))


def _plans():
    rng = np.random.RandomState(7)
    d, h, w = GRID
    cells = rng.choice(d * h * w, 1500, replace=False)
    coords = np.stack([cells // (h * w), (cells // w) % h, cells % w], -1)
    coords = np.concatenate([coords, -np.ones((37, 3), dtype=coords.dtype)])  # padding
    feats = torch.zeros(len(coords), 4)
    _, tc, lin = WC.sort_rows(feats, torch.from_numpy(coords).int(), GRID)
    plans = {"subm": WC.make_subm_plan_presorted(lin, tc, GRID, window=128)}
    for name, stride, pad, ks in (("strided", (2, 2, 2), (1, 1, 1), (3, 3, 3)),
                                  ("z-only", (2, 1, 1), (0, 0, 0), (3, 1, 1))):
        g_out = tuple((n + 2 * p - k) // s + 1 for n, p, k, s in zip(GRID, pad, ks, stride))
        oc, ol = WC.downsample_active_set_yxz(tc, (tc >= 0).all(-1), GRID, g_out, stride, pad,
                                              ks, 2000)
        plans[name] = WC.make_strided_plan(lin, ol, oc, GRID, g_out, stride, pad, ks,
                                           window=128)
    return plans


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
