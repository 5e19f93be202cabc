"""Host side of the kernel benches' shared runner
(sparse2dense_tpu_torch/tools/bench_variants.py): another checkout given as a
variant is imported as a package of its own, so its kernels are built in
that checkout and run through its own wrappers and host-side layouts, and
the runner refuses to run without a GPU."""
import os
import shutil
import sys

import pytest

from sparse2dense_tpu_torch.ops import tile_block_kernel as TBK
from sparse2dense_tpu_torch.tools import bench_variants as BV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_checkout_variant_runs_its_own_wrapper(tmp_path):
    shutil.copytree(os.path.join(ROOT, BV.PACKAGE), tmp_path / BV.PACKAGE,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    try:
        mod = BV._checkout_wrapper(str(tmp_path), "copy", "tile_block_kernel")
        assert mod.__name__ == "_bench_copy.ops.tile_block_kernel"
        assert mod is not TBK and mod.tile_subm_cuda is not TBK.tile_subm_cuda
        assert mod.SOURCE == str(tmp_path / BV.PACKAGE / "csrc" / "tile_subm.cu")
        assert mod.LIBRARY.startswith(str(tmp_path))
        assert sys.modules["_bench_copy.ops.cuda_build"].BUILD_DIR.startswith(str(tmp_path))
        assert sys.modules["_bench_copy.ops.plane_kernel"].wgmma_weights is mod.wgmma_weights
    finally:
        for name in [n for n in sys.modules if n.startswith("_bench_copy")]:
            del sys.modules[name]


@pytest.mark.skipif(BV.torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_sources_need_a_gpu():
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        BV.sources(TBK, [], "tile")
