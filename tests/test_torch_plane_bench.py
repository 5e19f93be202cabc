"""Host side of the plane kernel's tooling: the tile counts of
tools/bench_plane_subm.tap_tiles against a direct count, and the kernel
build's dependence on the shared headers of csrc/ (ops/cuda_build)."""
import os

import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops import cuda_build
from sparse2dense_tpu_torch.ops import plane_conv as TPK
from sparse2dense_tpu_torch.tools.bench_plane_subm import tap_tiles


@pytest.mark.parametrize("seed", [0, 1])
def test_tap_tiles_match_a_direct_count(seed):
    rng = np.random.RandomState(seed)
    t1p = 2 * TPK.BLK
    tgt = rng.randint(0, t1p, size=(t1p // TPK.BLK, 32, TPK.BLK))
    tgt[rng.rand(*tgt.shape) < 0.6] = TPK.SENTINEL
    mask = (rng.rand(t1p, 16) < 0.3).astype(np.float32)
    mask[8:16] = 0                      # two whole dead groups of 4
    got = tap_tiles(torch.from_numpy(mask), torch.from_numpy(tgt.astype(np.int32)))

    def tap_live(p, k):  # a source cell of tap k lies in a present plane
        rows = set(TPK.TAP_ROWS[k])
        return 27 in rows or any(0 <= tgt[p // TPK.BLK, r, p % TPK.BLK] < t1p for r in rows)

    plane = mask.any(1)
    per_plane = sum(tap_live(p, k) for p in range(t1p) if plane[p] for k in range(27))
    per_group = sum(4 for g in range(t1p // 4) if plane[4 * g:4 * g + 4].any()
                    for k in range(27) if any(tap_live(p, k) for p in range(4 * g, 4 * g + 4)))
    assert got == dict(tiles_no_skip=27 * int(plane.sum()), tiles_skip_per_plane=per_plane,
                       tiles_skip_per_group=per_group)
    assert per_plane <= per_group


def test_kernels_rebuild_when_a_shared_header_is_newer(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    source, header, library = (tmp_path / n for n in ("k.cu", "async_copy.cuh", "libk.so"))
    for f, t in ((source, 100), (library, 200), (header, 150)):
        f.write_bytes(b"")
        os.utime(f, (t, t))
    assert not cuda_build._stale(str(source), str(library))
    os.utime(header, (300, 300))
    assert cuda_build._stale(str(source), str(library))
    assert cuda_build._stale(str(source), str(tmp_path / "missing.so"))
