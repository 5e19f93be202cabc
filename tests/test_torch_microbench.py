"""The gather probes' plain versions (sparse2dense_tpu_torch/ops/gather_probes.py)
against the TPU probe kernels of sparse2dense_tpu/tools/microbench.py, run in
Pallas interpret mode on the CPU, equal with no tolerance; against the
reference's numpy formulas; and the port's tools/microbench.py suites for
the probes and the gather on the CPU at small sizes.

The kernel bodies below are copies of the reference's (microbench.py:203-205,
:285-295, :358-377): they are closures there and cannot be imported."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparse2dense_tpu_torch.ops import gather_probes as GP
from sparse2dense_tpu_torch.ops import window_kernel as WK
from sparse2dense_tpu_torch.tools import microbench as MB

V, C = 1024, 16
CPU = torch.device("cpu")


def _table(seed=0):
    return np.random.RandomState(seed).randn(V, C).astype(np.float32)


def _pallas_take(feat, idx):
    """bench_pallas_take's whole-table form (microbench.py:229-236)."""
    def k_tala2d(idx_ref, feat_ref, out_ref):
        # Mosaic gather contract: operand/indices/output all same shape
        out_ref[:] = jnp.take_along_axis(feat_ref[:], idx_ref[:], axis=0)

    return pl.pallas_call(
        k_tala2d, out_shape=jax.ShapeDtypeStruct((V, C), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )(jnp.broadcast_to(idx[:, None], (V, C)), feat)


def _pallas_onehot(feat, lidx, BLK, W):
    """bench_pallas_onehot's kernel (microbench.py:285-317)."""
    def kernel(lidx_ref, feat_hbm, out_ref, win, sem):
        i = pl.program_id(0)
        start = jnp.minimum(i * BLK, V - W)  # clamp window at the tail
        dma = pltpu.make_async_copy(feat_hbm.at[pl.ds(start, W), :], win, sem)
        dma.start()
        dma.wait()
        onehot = (lidx_ref[:] == jax.lax.broadcasted_iota(jnp.int32, (BLK, W), 1))
        out_ref[:] = jnp.dot(onehot.astype(jnp.float32), win[:],
                             preferred_element_type=jnp.float32)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(V // BLK,),
        in_specs=[pl.BlockSpec((BLK, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((BLK, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((W, C), jnp.float32), pltpu.SemaphoreType.DMA(())])
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((V, C), jnp.float32),
                          grid_spec=grid_spec, interpret=True)(lidx, feat)


def _pallas_dma(feat, idx, run_len, NSLOT=16):
    """bench_pallas_dma's kernel (microbench.py:358-394)."""
    N = V // run_len

    def kernel(idx_ref, feat_hbm, out_ref, sems):
        def get(i):
            return pltpu.make_async_copy(
                feat_hbm.at[pl.ds(idx_ref[i], run_len), :],
                out_ref.at[pl.ds(i * run_len, run_len), :],
                sems.at[i % NSLOT])

        def body(i, _):
            @pl.when(i >= NSLOT)
            def _():
                get(i - NSLOT).wait()
            get(i).start()
            return 0

        jax.lax.fori_loop(0, N, body, 0)

        def drain(i, _):
            get(i).wait()
            return 0
        jax.lax.fori_loop(N - NSLOT, N, drain, 0)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,), in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.SemaphoreType.DMA((NSLOT,))])
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((V, C), jnp.float32),
                          grid_spec=grid_spec, interpret=True,
                          compiler_params=pltpu.CompilerParams(has_side_effects=True))(idx, feat)


def _run_starts(rng, run_len):
    return (rng.randint(0, V // run_len, size=(V // run_len,)) * run_len).astype(np.int32)


def test_take_plain_equals_pallas_kernel():
    feat = _table()
    idx = np.random.RandomState(1).randint(0, V, size=(V,)).astype(np.int32)
    want = np.asarray(_pallas_take(jnp.asarray(feat), jnp.asarray(idx)))
    got = GP.take_plain(torch.from_numpy(feat), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), feat[idx])            # microbench.py:199
    assert torch.equal(GP.take(torch.from_numpy(feat), torch.from_numpy(idx)), got)


def test_window_take_plain_equals_pallas_kernel():
    blk, w = 64, 128
    feat = _table()
    local = np.random.RandomState(2).randint(0, w, size=(V // blk, blk)).astype(np.int32)
    want = np.asarray(_pallas_onehot(jnp.asarray(feat), jnp.asarray(local.reshape(V, 1)), blk, w))
    got = GP.window_take_plain(torch.from_numpy(feat), torch.from_numpy(local.reshape(-1)), blk, w)
    np.testing.assert_array_equal(got.numpy(), want)   # every row, the clamped tail included
    assert (V // blk - 1) * blk > V - w                # the last blocks' windows are clamped
    # the reference's own check wraps the window modulo V: rows [:V - W] only
    gidx = (np.arange(V // blk)[:, None] * blk + local) % V      # microbench.py:281-282
    np.testing.assert_array_equal(got.numpy()[:V - w], feat[gidx.reshape(-1)][:V - w])
    assert torch.equal(GP.window_take(torch.from_numpy(feat), torch.from_numpy(local.reshape(-1)),
                                      blk, w), got)


@pytest.mark.parametrize("run_len", [1, 8, 64])
def test_run_gather_plain_equals_pallas_kernel(run_len):
    feat = _table()
    idx = _run_starts(np.random.RandomState(3), run_len)
    want = np.asarray(_pallas_dma(jnp.asarray(feat), jnp.asarray(idx), run_len))
    got = GP.run_gather_plain(torch.from_numpy(feat), torch.from_numpy(idx), run_len)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(                                # microbench.py:398-399
        got.numpy(), np.concatenate([feat[i:i + run_len] for i in idx]))
    assert torch.equal(GP.run_gather(torch.from_numpy(feat), torch.from_numpy(idx), run_len), got)


def test_plain_versions_refuse_what_the_kernels_do_not_take():
    feat = torch.from_numpy(_table())
    with pytest.raises(ValueError, match="multiple of 8"):
        GP.run_gather_plain(feat, torch.tensor([3], dtype=torch.int32), 8)      # not aligned
    with pytest.raises(ValueError, match="multiple of 8"):
        GP.run_gather_plain(feat, torch.tensor([V], dtype=torch.int32), 8)      # overruns V
    with pytest.raises(ValueError, match="multiple of 64"):
        GP.run_gather_plain(feat, torch.tensor([V - 32], dtype=torch.int32), 64)
    assert GP.run_gather_plain(feat, torch.tensor([V - 8], dtype=torch.int32), 8).shape == (8, C)
    with pytest.raises(ValueError, match="out of"):
        GP.take_plain(feat, torch.tensor([V], dtype=torch.int32))
    with pytest.raises(ValueError, match="out of"):
        GP.window_take_plain(feat, torch.full((64,), 128, dtype=torch.int32), 64, 128)
    with pytest.raises(ValueError, match="multiple of blk"):
        GP.window_take_plain(feat, torch.zeros(60, dtype=torch.int32), 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        GP.take_cuda(feat, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        GP.run_gather_cuda(feat, torch.zeros(4, dtype=torch.int32), 1)


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


def test_window_kernel_admission():
    """The window-pass kernel's own admission rules, which the microbench
    prints for the cases the kernel does not take."""
    assert WK.unsupported(WK.BLOCK, 16, 16, 384) is None
    assert WK.unsupported(WK.BLOCK, 32, 32, 768) is None
    assert "plan block 256" in WK.unsupported(256, 16, 16, 512)
    assert "Cout 64" in WK.unsupported(WK.BLOCK, 64, 64, 384)
    assert "window 200" in WK.unsupported(WK.BLOCK, 16, 16, 200)
    assert "window 8192" in WK.unsupported(WK.BLOCK, 32, 32, 8192)


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
