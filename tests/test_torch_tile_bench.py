"""Host side of the tile kernel's tooling: the unit-of-work counts of
tools/bench_tile_subm.unit_counts (halo rows gathered, rows with a present
source, 16-row tiles multiplied) against a direct loop over planes, layers
and taps."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.ops.tile_kernel import BLK, SENTINEL, dir_row
from sparse2dense_tpu_torch.tools.bench_tile_subm import unit_counts


def _tile_set(seed, tz, t1p):
    """A seeded plan and mask: scattered live cells, and runs of live
    z-neighbours in some columns (where the layers of a column are shared)."""
    rng = np.random.RandomState(seed)
    tgt = rng.randint(0, t1p, size=(t1p // BLK, 32, BLK))
    tgt[rng.rand(*tgt.shape) < 0.5] = SENTINEL
    tgt[0, 5, :7] = -3                                   # out of range reads zero too
    mask = (rng.rand(tz, t1p, 16) < 0.01).astype(np.float32)
    for t in rng.choice(t1p, t1p // 3, replace=False):
        z0 = rng.randint(tz)
        mask[z0:z0 + rng.randint(1, tz + 1), t, rng.randint(16)] = 1
    return mask, tgt.astype(np.int32)


def _direct(mask, tgt, tz):
    t1p = mask.shape[1]

    def present(dz, dy, dx, t):
        if (dz, dy, dx) == (0, 0, 0):
            return True
        r = tgt[t // BLK, dir_row(dz, dy, dx), t % BLK]
        return 0 <= r < t1p

    def side(v, n):
        return -1 if v < 0 else (1 if v >= n else 0)

    def tap_live(z, t, k):
        kz, ky, kx = k // 9, (k // 3) % 3, k % 3
        return any(present(side(z + kz - 1, tz), side(c // 4 + ky - 1, 4),
                           side(c % 4 + kx - 1, 4), t) for c in range(16))

    def reads(t, zz):
        return sum(present(side(zz, tz), side(h // 6 - 1, 4), side(h % 6 - 1, 4), t)
                   for h in range(36))

    live = mask.any(-1)
    taps = {(z, t): {k for k in range(27) if tap_live(z, t, k)}
            for z in range(tz) for t in range(t1p)}

    def groups(planes, share):
        rows = rd = tiles = 0
        for g in planes:
            layers = [(t, z + kz - 1) for z, t in g for kz in range(3)]
            if share:
                layers = set(layers)
            rows += 36 * len(layers)
            rd += sum(reads(t, zz) for t, zz in layers)
            tiles += 4 * len(set().union(*(taps[p] for p in g)))
        return dict(groups=len(planes), halo_rows=rows, halo_reads=rd, tiles=tiles)

    def chunks(seq):
        return [seq[i:i + 4] for i in range(0, len(seq), 4)]

    z_major = [(z, t) for z in range(tz) for t in range(t1p) if live[z, t]]
    col_major = [(z, t) for t in range(t1p) for z in range(tz) if live[z, t]]
    cols = [t for t in range(t1p) if live[:, t].any()]
    per_col = [g for t in cols for g in chunks([(z, t) for z in range(tz) if live[z, t]])]
    c = dict(groups=len(range(0, tz, 4)) * len(cols),
             halo_rows=(tz + 2) * 36 * len(cols),
             halo_reads=sum(reads(t, zz) for t in cols for zz in range(-1, tz + 1)),
             tiles=sum(4 * len(set().union(*(taps[(z, t)] for z in range(z0, min(z0 + 4, tz)))))
                       for t in cols for z0 in range(0, tz, 4)))
    return dict(tz=tz, t1p=t1p, live_planes=len(z_major), columns=len(cols),
                tiles_per_plane=sum(len(taps[p]) for p in z_major),
                a=groups(chunks(z_major), False), b=groups(per_col, True),
                b_cross=groups(chunks(col_major), True), c=c)


@pytest.mark.parametrize("seed,tz,t1p", [(0, 4, 128), (1, 6, 256)])
def test_unit_counts_match_a_direct_loop(seed, tz, t1p):
    mask, tgt = _tile_set(seed, tz, t1p)
    got = unit_counts(torch.from_numpy(mask), torch.from_numpy(tgt))
    want = _direct(mask, tgt, tz)
    assert got == want
    # sharing the layers of a column never gathers more than a halo a plane
    assert got["b_cross"]["halo_rows"] <= got["a"]["halo_rows"]
    assert got["b"]["halo_rows"] <= got["a"]["halo_rows"]
