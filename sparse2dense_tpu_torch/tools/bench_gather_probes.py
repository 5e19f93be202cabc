"""Times the gather probes (B4a take, B4b window take, B4c run gather;
``csrc/gather_probes.cu``) at the microbench's sizes, for this tree's source
and for variants of it, beside the timers' floors, on one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.bench_gather_probes [--rounds 2] [name=path ...]

The cases, each bit-equal to its plain version and launched 0 times a
frame: B4a at V = 2^17, C = 16; B4b at (blk, w) = (256, 512) and
(512, 1024); B4c at R = 1, 8 and 64; and the timers' two floors
(``microbench.floor_cases``: an empty kernel, a copy of the table). A
variant is a copy of the source (``name=path.cu``: ablations live in such
copies) or another checkout of the repo (``name=dir``, e.g. the parent
commit unpacked by ``git archive``); ``bench_variants`` builds, times
(L2-warm over 20 launches, and L2-cold after ``microbench.flush_l2``) and
checks each.
"""
from __future__ import annotations

import torch

from ..ops import gather_probes as GP
from . import bench_variants as BV
from . import microbench as MB

V, C = 1 << 17, 16
WINDOW_SHAPES = ((256, 512), (512, 1024))
RUN_LENS = (1, 8, 64)


def cases(dev, v=V, c=C):
    """The bench's cases (``bench_variants.Case``), called through each
    source's own wrapper (``take_cuda``, ``window_take_cuda``,
    ``run_gather_cuda``); the floors call this tree's."""
    feat, (idx, _) = MB.take_data(dev, v, c)
    yield (f"take V={v} C={c}", 0, lambda m: m.take_cuda(feat, idx),
           GP.take_plain(feat, idx), 0.0)
    feat, data = MB.window_take_data(dev, v, c, WINDOW_SHAPES)
    for blk, w, (local, _) in data:
        yield (f"window_take BLK={blk} W={w}", 0,
               lambda m, local=local, blk=blk, w=w: m.window_take_cuda(feat, local, blk, w),
               GP.window_take_plain(feat, local, blk, w), 0.0)
    for run_len in RUN_LENS:
        rfeat, var = MB.run_gather_data(dev, run_len, v, c)
        yield (f"run_gather R={run_len}", 0,
               lambda m, rfeat=rfeat, s=var[0], r=run_len: m.run_gather_cuda(rfeat, s, r),
               GP.run_gather_plain(rfeat, var[0], run_len), 0.0)
    (empty_case, empty, _), (copy_case, copy, _) = MB.floor_cases(dev, v, c)
    nothing = torch.empty(0, device=dev)
    yield empty_case, 0, lambda m: empty(0) or nothing, nothing, 0.0
    yield copy_case, 0, lambda m: copy(0), copy(0), 0.0


def main() -> None:
    args = BV.parser(__doc__).parse_args()
    srcs = BV.sources(GP, args.variants, "gather")
    dev = torch.device("cuda")
    print(MB.device_line(dev), flush=True)
    BV.run(srcs, cases(dev), args.rounds, reps=20)


if __name__ == "__main__":
    main()
