"""Host side of the redesigned gather probes (sparse2dense_tpu_torch/ops/gather_probes.py,
csrc/gather_probes.cu) and of their bench tool (tools/bench_gather_probes.py):
the window each block of the window-take kernel stages and the rows it
picks; the bench's cases and the timers' floors on the CPU; the cold
timer's flush; the wrapper's ``load``. No JAX here: the
probes' parity with the Pallas kernels is tests/test_torch_microbench.py's.

Split into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the window-take rows and
the refusals, ``tests/test_torch_gather_window_rows.py``; the clamped
schedules, the bench and the cold timer,
``tests/test_torch_gather_bench.py``."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import gather_probes as GP

CPU = torch.device("cpu")


SCHEDULES = [   # (v, n, blk, w)
    (1 << 17, 1 << 17, 256, 512),       # the reference shapes
    (1 << 17, 1 << 17, 512, 1024),
    (1 << 17, 1 << 16, 256, 512),       # n < V: no window clamped
    (100003, 128000, 64, 640),          # n > V: clamped tail, V - w unaligned
    (1024, 1024, 128, 1024),            # w = V: every window clamped
    (1 << 15, 1 << 15, 256, 128),       # w < blk
]


@pytest.mark.parametrize("v,n,blk,w", SCHEDULES[:4])
def test_window_schedule_covers_each_output_block_from_its_window(v, n, blk, w):
    check_window_schedule(v, n, blk, w)


def check_window_schedule(v, n, blk, w):
    """Block b of the window-take kernel writes output block b from the
    window it stages, rows [s_b, s_b + w): every output block is written
    once, every row it selects lies in that window and the window in the
    table, the clamped tail included."""
    starts = GP.window_starts(v, n, blk, w)
    assert starts.shape == (n // blk,)                     # a block an output block
    assert bool((starts >= 0).all()) and bool((starts + w <= v).all())
    assert bool((starts == torch.minimum(torch.arange(n // blk) * blk,
                                         torch.tensor(v - w))).all())
    local = torch.from_numpy(np.random.RandomState(0).randint(0, w, size=(n,)).astype(np.int32))
    local[::blk], local[blk - 1::blk] = 0, w - 1           # each window's first and last row
    rows = GP.window_index(v, local, blk, w).view(-1, blk)
    assert bool((rows >= starts[:, None]).all()) and bool((rows < starts[:, None] + w).all())
    clamped = (torch.arange(n // blk) * blk > v - w).nonzero().flatten()
    assert bool((starts[clamped] == v - w).all())
    if n > v - w + blk:
        assert clamped.numel() > 0                          # the tail is exercised


