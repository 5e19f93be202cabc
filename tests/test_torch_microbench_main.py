"""The microbench tool on the CPU: the B4 suites and the gather suite run
small, ``main`` needs CUDA unless the CPU is asked for, and the probe
kernels against their plain versions on the card."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import gather_probes as GP
from sparse2dense_tpu_torch.tools import microbench as MB

from tests.test_torch_microbench import C, CPU, V, _run_starts, _table


def test_b4_suites_and_gather_run_on_the_cpu(capsys):
    rows = (MB.bench_pallas_take(CPU, v=V, c=C)
            + MB.bench_pallas_onehot(CPU, v=V, c=C, shapes=((64, 128), (128, 256)))
            + MB.bench_pallas_dma(CPU, 1, v=V, c=C)
            + MB.bench_pallas_run(CPU, v=V, c=C))
    assert [r["kernel"] for r in rows] == ["take", "window_take", "window_take", "run_gather",
                                           "run_gather", "run_gather"]
    for r in rows:
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["library_ms"] > 0
        assert r["launches"] == 0       # the plain versions on the CPU
        assert "cold_ms" not in r       # L2-cold timing is the card's only
    # bound bytes: only the distinct rows (runs) the seeded indices name are read
    out_idx = V * C * 4
    rng = np.random.RandomState(0)
    rng.randn(V, C)
    take_rows = len(np.unique(rng.randint(0, V, size=(V,))))
    assert rows[0]["nbytes"] == take_rows * C * 4 + out_idx + V * 4
    for r, run_len in zip(rows[3:], (1, 8, 64)):
        rng = np.random.RandomState(0)
        rng.randn(V, C)
        n = V // run_len
        runs = len(np.unique(rng.randint(0, n, size=(n,))))
        assert r["nbytes"] == runs * run_len * C * 4 + out_idx + n * 4
        assert r["n"] == n
    for r in rows[1:3]:             # overlapping windows: fewer rows than V, more than half
        assert out_idx + V * 4 + V * C * 2 < r["nbytes"] < out_idx + V * 4 + V * C * 4
    MB.bench_gather(CPU, v=V, channels=(16,))
    out = capsys.readouterr().out
    for case in ("take V=1024", "window_take BLK=128 W=256", "run_gather R=64",
                 "torch gather V=1024 C=16", "gather_conv 27tap"):
        assert case in out


def test_main_needs_cuda_or_the_cpu_asked_for(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MB.main(["pallas_take"])
    with pytest.raises(SystemExit):
        MB.main(["--device", "cpu", "no_such_suite"])
    monkeypatch.setattr(MB, "SUITES", {"pallas_take": lambda dev: MB.bench_pallas_take(dev, v=V)})
    assert MB.main(["--device", "cpu", "pallas_take"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu") and "--- pallas_take ---" in out


@pytest.mark.cuda
def test_probe_kernels_cuda_match_plain():
    """Each probe kernel bit-equal to its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    feat = torch.from_numpy(_table()).to(dev)
    rng = np.random.RandomState(4)
    idx = torch.from_numpy(rng.randint(0, V, size=(V,)).astype(np.int32)).to(dev)
    assert torch.equal(GP.take_cuda(feat, idx), GP.take_plain(feat, idx))
    for blk, w in ((64, 128), (128, 1024)):
        local = torch.from_numpy(rng.randint(0, w, size=(V,)).astype(np.int32)).to(dev)
        assert torch.equal(GP.window_take_cuda(feat, local, blk, w),
                           GP.window_take_plain(feat, local, blk, w))
    for run_len in (1, 8, 64):
        starts = torch.from_numpy(_run_starts(rng, run_len)).to(dev)
        assert torch.equal(GP.run_gather_cuda(feat, starts, run_len),
                           GP.run_gather_plain(feat, starts, run_len))
