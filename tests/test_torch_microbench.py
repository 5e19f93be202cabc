"""The gather probes' plain versions (sparse2dense_tpu_torch/ops/gather_probes.py)
against the TPU probe kernels of sparse2dense_tpu/tools/microbench.py, run in
Pallas interpret mode on the CPU, equal with no tolerance; against the
reference's numpy formulas; and the port's tools/microbench.py suites for
the probes and the gather on the CPU at small sizes.

The kernel bodies below are copies of the reference's (microbench.py:203-205,
:285-295, :358-377): they are closures there and cannot be imported.

Split into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the run gather,
``tests/test_torch_microbench_runs.py``; the suites and ``main``,
``tests/test_torch_microbench_main.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparse2dense_tpu_torch.ops import gather_probes as GP
from sparse2dense_tpu_torch.ops import window_kernel as WK

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


def test_window_kernel_admission():
    """The window-pass kernel's own admission rules, which the microbench
    prints for the cases the kernel does not take."""
    assert WK.unsupported(WK.BLOCK, 16, 16, 384) is None
    assert WK.unsupported(WK.BLOCK, 32, 32, 768) is None
    assert "plan block 256" in WK.unsupported(256, 16, 16, 512)
    assert WK.unsupported(WK.BLOCK, 64, 64, 384) is None   # streamed weights
    assert "Cout 64" in WK.unsupported(WK.BLOCK, 128, 64, 384)
    assert "window 200" in WK.unsupported(WK.BLOCK, 16, 16, 200)
    assert "window 8192" in WK.unsupported(WK.BLOCK, 32, 32, 8192)


