"""B1's host side at the widths the window engine's stages past conv3_down
need (``dense_from_stage`` 3 and 99): the weight layout at 64->64,
64->128 and 128->128, whose taps the kernel streams one slice a tap, goes
back to (27, Cin, Cout) bit for bit (``tests/test_torch_window_layout.py``'s
check), and the kernel takes every (width, window) the frame settings give
those stages, on both backbones."""
import pytest

from sparse2dense_tpu_torch.ops import window_kernel as WK
from sparse2dense_tpu_torch.utils.config import DFS3_FRAME_SETTINGS, DFS99_FRAME_SETTINGS

from tests.test_torch_window_layout import check_round_trip


@pytest.mark.parametrize("cin,cout", WK.STREAMED)
def test_streamed_weights_round_trip(cin, cout):
    assert WK.streamed(cin, cout)
    check_round_trip(cin, cout)


def test_kernel_takes_the_deep_frame_settings():
    """Every window pass of the window engine at 3 and 99 on both backbones,
    at the frame settings' plan windows: (stage k whose window it takes,
    Cin, Cout) by plan; windows at the reference's granule of 128 rows."""
    plans = {3: [(0, 5, 16), (0, 16, 16), (1, 16, 32), (1, 32, 32), (2, 32, 64), (2, 64, 64),
                 (3, 64, 128), (3, 64, 64)]}
    plans[99] = plans[3] + [(3, 128, 128)]
    for dfs, settings in ((3, DFS3_FRAME_SETTINGS), (99, DFS99_FRAME_SETTINGS)):
        wins = settings["win_window"]
        for k, cin, cout in plans[dfs]:
            assert WK.unsupported(WK.BLOCK, cin, cout, wins[k]) is None, (dfs, k, cin, cout)
    # one window buffer where two do not fit, and the widest windows
    assert WK.window_buffers(128, 128, 256) == 2 and WK.window_buffers(128, 128, 512) == 1
    assert WK.unsupported(WK.BLOCK, 128, 128, 640) is not None
    assert WK.unsupported(WK.BLOCK, 64, 128, 1280) is None
    assert "Cout" in WK.unsupported(WK.BLOCK, 128, 64, 384)
