"""Times the bfloat16 plane subm kernel (B2, ``csrc/plane_subm.cu``) on the
conv2 / conv3 / conv4 planes of a flagship frame, for this tree's source and
for variants of it, on one NVIDIA GPU.

    python3 -m sparse2dense_tpu_torch.tools.bench_plane_subm [--rounds 2] [name=path ...]

The frame is ``profile_flagship``'s on the plane engine (``FRAME_BUDGETS``).
A variant is a copy of the source (``name=path.cu``) or another checkout of
the repo (``name=dir``); ``bench_variants`` builds, times (L2-warm and cold,
with the residual and ReLU of the blocks) and checks each against one bf16
step of ``plane_subm_plain``. Before each conv's times a JSON line gives the
16-row tiles that a tap skip per group of 4 planes (the ``wgmma`` kernel's
unit) multiplies, against a skip per plane (a warp's own) and no skip.
"""
from __future__ import annotations

import json

import torch

from ..ops import plane_conv as PK
from ..ops import plane_kernel as PKK
from . import bench_variants as BV
from .microbench import BF16_FLOOR, BF16_STEP

PLANE_STAGES = (("conv2", 32), ("conv3", 64), ("conv4", 128))
LAUNCHES = 4   # of each conv a frame on the plane engine's main path


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


def cases(stages, gen):
    """The bench's cases (``bench_variants.Case``) on the conv2..conv4
    planes, with the residual and ReLU of the blocks; prints each conv's
    ``tap_tiles`` first."""
    dev = torch.device("cuda")
    for (conv, c), (state, mask, _, _, plan) in zip(PLANE_STAGES, stages):
        print(json.dumps(dict(case=conv, **tap_tiles(mask, plan.tgt))), flush=True)
        w = torch.randn((27, c, c), device=dev, generator=gen) * (27 * c) ** -0.5
        scale = 1 + 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        shift = 0.1 * torch.randn((1, 16 * c), device=dev, generator=gen)
        st = state.to(torch.bfloat16)
        call = (st, plan.tgt, w.to(torch.bfloat16), scale, shift,
                PK.expand_mask(mask, c).to(torch.bfloat16))
        want = PK.plane_subm_plain(*call, residual=st).float()
        tol = BF16_STEP * want.abs() + BF16_FLOOR * want.abs().max()
        yield conv, LAUNCHES, lambda m: m.plane_subm_cuda(*call, residual=st), want, tol


def main() -> None:
    from .profile_flagship import _flagship

    args = BV.parser(__doc__).parse_args()
    srcs = BV.sources(PKK, args.variants, "plane")
    model, batch = _flagship("plane")
    stages = plane_stage_data(batch, model)
    del model
    BV.run(srcs, cases(stages, torch.Generator(device="cuda").manual_seed(1)), args.rounds)


if __name__ == "__main__":
    main()
