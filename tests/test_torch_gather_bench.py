"""The window-take schedule where windows clamp (w = V, w < blk), the gather
bench's cases and floors built on the CPU, and the cold timer's flush and
the wrapper's library load."""
import pytest
import torch

from sparse2dense_tpu_torch.ops import gather_probes as GP
from sparse2dense_tpu_torch.tools import bench_gather_probes as BG
from sparse2dense_tpu_torch.tools import microbench as MB

from tests.test_torch_gather_schedule import CPU, SCHEDULES, check_window_schedule


@pytest.mark.parametrize("v,n,blk,w", SCHEDULES[4:])
def test_window_schedule_covers_each_output_block_from_its_window(v, n, blk, w):
    check_window_schedule(v, n, blk, w)


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
