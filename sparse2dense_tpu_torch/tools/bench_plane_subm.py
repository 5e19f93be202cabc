"""Times the bfloat16 plane subm kernel (B2, ``csrc/plane_subm.cu``) on the
conv2 / conv3 / conv4 planes of a flagship frame, for this tree's source and
for variants of it, on one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.bench_plane_subm [--rounds 2] [name=path.cu ...]

The frame is ``profile_flagship``'s on the plane engine (``FRAME_BUDGETS``).
Each variant source is compiled as the repo's is (``cuda_build.build_all``,
the headers of ``csrc/`` on the include path) into ``_build/bench/`` and
called through the same wrapper. Every round times each source on each conv
(CUDA events over 10 launches, L2-warm, with the residual and ReLU of the
blocks) and counts its outputs beyond one bf16 step of ``plane_subm_plain``;
the sources take turns within a round, so drift over the call falls on all
alike. Prints a JSON line per (conv, source), and one per conv with the
16-row tiles that a tap skip per group of 4 planes (the ``wgmma`` kernel's
unit) multiplies, against a skip per plane (a warp's own) and no skip.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..ops import cuda_build
from ..ops import plane_conv as PK
from ..ops import plane_kernel as PKK
from .microbench import BF16_FLOOR, BF16_STEP, timed

PLANE_STAGES = (("conv2", 32), ("conv3", 64), ("conv4", 128))
BENCH_DIR = os.path.join(cuda_build.BUILD_DIR, "bench")


def plane_stage_data(batch, model):
    """(state, mask, sets, grid, plan) of conv2..conv4 of the plane flagship
    frame: the stage outputs of one backbone forward, with their plans."""
    bb = model.backbone
    with torch.inference_mode():
        feats = model.reader(batch["voxels"], batch["num_points"])
        _, multi_scale, _ = bb(feats, batch["coordinates"])
    out = []
    for k, (name, _) in enumerate(PLANE_STAGES):
        (state, mask, sets), grid = multi_scale[name]
        plan = PK.make_plane_plan_batched(sets, PK.t1p_of(bb.plane_budgets[k]),
                                          *bb.plane_wins[k])
        out.append((state.clone(), mask.clone(), sets, grid, plan))
    return out


def tap_tiles(mask: torch.Tensor, tgt: torch.Tensor) -> dict:
    """(plane, tap) tiles of 16 rows a kernel multiplies on this mask and
    plan: skipping a tap per plane (16 rows) or per group of 4 planes (64
    rows), against all 27 taps of every live plane. A tap is live where one
    of its 16 source cells lies in a present plane; a plane (group) is live
    where one of its cells (of its 64) is unmasked."""
    t1p = mask.shape[0]
    tg = tgt.permute(1, 0, 2).reshape(32, t1p)
    present = torch.cat([(tg[:27] >= 0) & (tg[:27] < t1p),
                         torch.ones((1, t1p), dtype=torch.bool, device=tg.device)])
    rows = torch.tensor(PK.TAP_ROWS, device=tg.device)                  # (27, 16)
    tap = present[rows].any(1)                                          # (27, T1p)
    plane = (mask != 0).any(1)
    group = plane.view(-1, 4).any(1)
    return dict(tiles_no_skip=27 * int(plane.sum()),
                tiles_skip_per_plane=int((tap & plane).sum()),
                tiles_skip_per_group=4 * int((tap.view(27, -1, 4).any(2) & group).sum()))


def main() -> None:
    from .profile_flagship import _flagship

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help="name=path.cu: a variant source of the kernel")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_plane_subm needs a CUDA GPU")
    os.makedirs(BENCH_DIR, exist_ok=True)
    pairs = [(PKK.SOURCE, PKK.LIBRARY)]
    names = ["this tree"]
    for v in args.variants:
        name, path = v.split("=", 1)
        pairs.append((os.path.abspath(path), os.path.join(BENCH_DIR, f"lib{name}.so")))
        names.append(name)
    logs = cuda_build.build_all(pairs)
    for library, log in logs.items():
        print(json.dumps({"built": library, "ptxas": [line for line in log.splitlines()
                                                      if "registers" in line or "spill" in line]}))
    libs = {name: PKK.load(library) for name, (_, library) in zip(names, pairs)}

    model, batch = _flagship("plane")
    stages = plane_stage_data(batch, model)
    del model
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    times = {}
    for (conv, c), (state, mask, _, _, plan) in zip(PLANE_STAGES, stages):
        print(json.dumps(dict(conv=conv, **tap_tiles(mask, plan.tgt))), flush=True)
        w = torch.randn((27, c, c), device=dev, generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        st = state.to(torch.bfloat16)
        call = (st, plan.tgt, w.to(torch.bfloat16), scale, shift,
                PK.expand_mask(mask, c).to(torch.bfloat16))
        want = PK.plane_subm_plain(*call, residual=st).float()
        tol = BF16_STEP * want.abs() + BF16_FLOOR * want.abs().max()
        for _ in range(args.rounds):
            for name, lib in libs.items():
                PKK._lib = lib
                got = PKK.plane_subm_cuda(*call, residual=st).float()
                bad = int(((got - want).abs() > tol).sum())
                ms = timed(lambda i: PKK.plane_subm_cuda(*call, residual=st), dev) * 1e3
                rec = times.setdefault((conv, name), dict(conv=conv, source=name, ms=[], n_bad=0))
                rec["ms"].append(ms)
                rec["n_bad"] = max(rec["n_bad"], bad)
        for name in names:
            print(json.dumps(times[(conv, name)]), flush=True)
    PKK._lib = None


if __name__ == "__main__":
    main()
