"""Host side of the redesigned gather probes (sparse2dense_tpu_torch/ops/gather_probes.py,
csrc/gather_probes.cu) and of their bench tool (tools/bench_gather_probes.py):
the window each block of the window-take kernel stages and the rows it
picks; the bench's cases and the timers' floors on the CPU; the cold
timer's flush; the wrapper's ``load``. No JAX here: the
probes' parity with the Pallas kernels is tests/test_torch_microbench.py's."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import gather_probes as GP
from sparse2dense_tpu_torch.tools import bench_gather_probes as BG
from sparse2dense_tpu_torch.tools import microbench as MB

CPU = torch.device("cpu")


@pytest.mark.parametrize("v,n,blk,w", [
    (1 << 17, 1 << 17, 256, 512),       # the reference shapes
    (1 << 17, 1 << 17, 512, 1024),
    (1 << 17, 1 << 16, 256, 512),       # n < V: no window clamped
    (100003, 128000, 64, 640),          # n > V: clamped tail, V - w unaligned
    (1024, 1024, 128, 1024),            # w = V: every window clamped
    (1 << 15, 1 << 15, 256, 128),       # w < blk
])
def test_window_schedule_covers_each_output_block_from_its_window(v, n, blk, w):
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


@pytest.mark.parametrize("blk,offset", [(100, 0), (256, 1), (6, 3)])
def test_window_take_rows_are_the_windows_rows_at_any_blk_and_offset(blk, offset):
    """window_take on the CPU picks row ``min(b*blk, V - w) +
    local[b*blk + r]`` for any blk and for indices that start anywhere in
    their buffer (the card's kernel asks blk a multiple of 4 and aligned
    indices; its rows are chip_smoke.py's to check)."""
    v, c, w, n = 1000, 8, 3 * blk, 1200 if blk == 100 else 16 * blk
    rng = np.random.RandomState(blk)
    feat = torch.from_numpy(rng.randn(v, c).astype(np.float32))
    local = torch.from_numpy(rng.randint(0, w, size=(n + offset,)).astype(np.int32))[offset:]
    got = GP.window_take(feat, local, blk, w)
    want = torch.stack([feat[min(k // blk * blk, v - w) + int(local[k])] for k in range(n)])
    assert torch.equal(got, want)


def test_window_starts_and_the_cuda_wrapper_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of blk"):
        GP.window_starts(1024, 1000, 64, 128)
    with pytest.raises(ValueError, match="0 < w"):
        GP.window_starts(1024, 1024, 64, 2048)
    with pytest.raises(ValueError, match="CUDA"):
        GP.window_take_cuda(torch.zeros(1024, 16), torch.zeros(1024, dtype=torch.int32), 64, 128)


def test_bench_cases_and_floors_build_on_the_cpu(capsys):
    class Plain:        # a source whose wrappers are the plain versions
        take_cuda = staticmethod(GP.take_plain)
        window_take_cuda = staticmethod(GP.window_take_plain)
        run_gather_cuda = staticmethod(GP.run_gather_plain)

    names = []
    for name, per_frame, call, want, tol in BG.cases(CPU, v=4096, c=16):
        got = call(Plain)
        assert per_frame == 0 and tol == 0.0
        assert got.shape == want.shape and torch.equal(got, want), name
        names.append(name)
    assert names == ["take V=4096 C=16", "window_take BLK=256 W=512", "window_take BLK=512 W=1024",
                     "run_gather R=1", "run_gather R=8",
                     "run_gather R=64", "timer floor: empty kernel",
                     "copy floor: copy_ V=4096 C=16"]
    rows = MB.bench_timer_floor(CPU, v=1024, c=16, reps=2)
    assert [r["nbytes"] for r in rows] == [0.0, 2.0 * 1024 * 16 * 4]
    assert all(r["ms"] > 0 and "cold_ms" not in r for r in rows)
    assert "copy floor: copy_ V=1024 C=16 warm" in capsys.readouterr().out
    assert MB.SUITES["timer_floor"] is MB.bench_timer_floor


def test_cold_timer_flushes_clean_and_the_wrapper_loads_a_library(monkeypatch):
    """timed_cold runs :func:`microbench.flush_l2` (write the buffer, read it
    back) before every call it times, warm-up calls excepted; the wrapper's
    ``_library`` loads through ``load``."""
    order = []

    class Event:
        def __init__(self, enable_timing):
            pass

        def record(self):
            order.append("event")

        def elapsed_time(self, end):
            return 2.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: order.append("sleep"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(MB, "FLUSH_BYTES", 4096)
    monkeypatch.setattr(MB, "_flush", None)
    real_flush = MB.flush_l2
    monkeypatch.setattr(MB, "flush_l2", lambda dev: order.append("flush") or real_flush(dev))
    assert MB.timed_cold(lambda i: order.append(f"step {i}"), CPU, reps=2, warmup=1) == 2e-3
    assert order == ["step 0", "flush", "sleep", "event", "step 1", "event",
                     "flush", "sleep", "event", "step 2", "event"]
    assert MB._flush.numel() == 1024 and not bool(MB._flush.any())   # written by the flush

    loaded = []
    monkeypatch.setattr(GP, "_lib", None)
    monkeypatch.setattr(GP, "build", lambda: "")
    monkeypatch.setattr(GP, "load", lambda path: loaded.append(path) or "lib")
    assert GP._library() == "lib" and loaded == [GP.LIBRARY]
    GP.empty(torch.zeros(1))          # the CPU: nothing to launch
    assert loaded == [GP.LIBRARY]
