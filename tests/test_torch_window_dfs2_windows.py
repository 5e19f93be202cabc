"""The window engine's per-stage plan windows (a 4-tuple ``win_window``) as the
reference's ``_stage_windows`` assigns them, and the window pass at Cin 32
-> Cout 64 on the card (``tests/test_torch_window_dfs2.py``'s frame)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparse2dense_tpu.models.backbones.scn import _stage_windows
from sparse2dense_tpu.ops import window_conv as JWC
from sparse2dense_tpu_torch.models.backbones.scn import SpMiddleResNetFHD
from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops import window_kernel as TWK

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_window_dfs2 import (  # noqa: F401 (fixtures)
    GRID, WINDOWS, frame, one_thread, seeded_weights)

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_stage_windows_as_the_reference(frame, monkeypatch):
    """A 4-tuple ``win_window``: each stage's plans take the reference's
    ``_stage_windows`` entry (conv1 0, conv2_down and conv2 1, conv3_down
    2), and each subm plan equals JAX's plan at that window."""
    wins = _stage_windows(WINDOWS)
    subm, strided = [], []
    make_subm, make_strided = TWC.make_subm_plan_presorted, TWC.make_strided_plan

    def rec_subm(lin, coords, grid, **kw):
        subm.append((lin, coords, tuple(grid), kw["window"]))
        return make_subm(lin, coords, grid, **kw)

    def rec_strided(*args, **kw):
        strided.append(kw["window"])
        return make_strided(*args, **kw)

    monkeypatch.setattr(TWC, "make_subm_plan_presorted", rec_subm)
    monkeypatch.setattr(TWC, "make_strided_plan", rec_strided)
    mod = SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                            dense_from_stage=2, win_window=WINDOWS)
    mod.load_state_dict(seeded_weights(mod, 41))
    with torch.no_grad():
        mod.eval()(*frame)
    assert mod.wins == wins
    assert [w for *_, w in subm] == [wins[0]] * 2 + [wins[1]] * 2   # a plan a sample
    assert strided == [wins[1]] * 2 + [wins[2]] * 2
    for lin, coords, grid, window in (subm[0], subm[2]):
        jp = JWC.make_subm_plan_presorted(jnp.asarray(lin.numpy()), jnp.asarray(coords.numpy()),
                                          grid, window=window)
        tp = make_subm(lin, coords, grid, window=window)
        for field in ("ws", "kbase", "resid_rows", "n_resid"):
            np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                          np.asarray(getattr(jp, field)), err_msg=field)
    with pytest.raises(ValueError, match="4 per-stage windows"):
        SpMiddleResNetFHD(num_input_features=5, sparse_shape=GRID, engine="window",
                          win_window=(384, 384))


@pytest.mark.cuda
def test_window_pass_cuda_32_to_64_matches_plain(frame):
    """The CUDA kernel at Cin 32 -> Cout 64 on a strided plan against its
    plain version on bf16-rounded inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, coords = frame
    c = coords[0].cuda()
    lin = TWC.yxz_lin(c, GRID)
    order = torch.argsort(lin, stable=True)
    c, lin = c[order], lin[order]
    down = ((2, 2, 2), (1, 1, 1), (3, 3, 3))
    g_out = (13, 16, 16)
    oc, ol = TWC.downsample_active_set_yxz(c, (c >= 0).all(-1), GRID, g_out, *down,
                                           c.shape[0])
    plan = TWC.make_strided_plan(lin, ol, oc, GRID, g_out, *down, window=128,
                                 resid_budget=c.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = torch.randn((c.shape[0], 32), device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn((27, 32, 64), device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    got = TWK.window_pass(f, plan, w)
    want = TWC.window_pass_plain(f.float(), plan, w.float())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
