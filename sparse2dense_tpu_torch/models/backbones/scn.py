"""SpMiddleResNetFHD, window, plane and tile engines (counterpart of
``sparse2dense_tpu/models/backbones/scn.py``).

With ``engine="window"`` and ``"plane"``, the conv1 stage (conv_input,
conv1_0, conv1_1) and the strided conv2_down run as windowed sparse convs on
voxel rows (``ops/window_conv.py``; the window pass is the hand-written CUDA
kernel on the card). With ``engine="window"``, the stages from
``dense_from_stage`` on run as masked dense 3D convs: one ``F.conv3d``
followed by the occupancy mask is the operator the reference's z-packed /
z-decomposed TPU convs compute. With ``engine="plane"``, conv2 to conv4 run as
fused submanifold convs over the occupied (by, bx, z) planes of 4x4 BEV tiles
(``ops/plane_conv.py``; the conv is the hand-written CUDA kernel on the
card), and the strided transitions and ``extra_conv`` in the chunk-planes
layout (``ops/tile_planes.py``). With ``engine="tile"`` (``tile_backend=
"pallas"``), every stage before ``dense_from_stage`` runs on z-chunked 4x4
BEV tiles: the subm convs as fused tile convs (``ops/tile_kernel.py``; the
conv is the hand-written CUDA kernel on the card), the strided convs in the
chunk-planes layout; the rest is dense. Rows are (B, V, C); dense tensors
are NCDHW with a (B, 1, D, H, W) occupancy mask; plane state is (B * T1p,
16C), tile state (tz, B * T1p, 16C). 3D conv weights are stored as Conv3d
weights (Cout, Cin, kz, ky, kx) in every stage, so the names and shapes of
the parameters do not depend on the engine.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import plane_conv as PK
from ...ops import tile_conv as TLC
from ...ops import tile_kernel as TKK
from ...ops import tile_planes as TP
from ...ops import window_conv as WC
from ...ops.sparse_conv import conv_out_grid, scatter_to_dense
from ..norm import BatchNorm


def _kernel(cin: int, cout: int, ksize=(3, 3, 3)) -> nn.Parameter:
    return nn.Parameter(torch.empty((cout, cin) + tuple(ksize)))


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return getattr(torch, name) if name else None


def _taps(w: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (Cout, Cin, kz, ky, kx) -> (kz*ky*kx, Cin, Cout) taps,
    z-major (the reference's checkpoint layout)."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 4, 1, 0).reshape(-1, cin, cout)


def _for_autograd(plans: List[WC.ConvPlan]) -> List[WC.ConvPlan]:
    """Plans with their reader tables when gradients will flow (one table a
    plan for every conv that shares it), else as they are."""
    return [WC.with_readers(p) for p in plans] if torch.is_grad_enabled() else plans


def _win_conv(feats, plans, w, b=None, ksize=(3, 3, 3)):
    wd = WC.taps_zyx_to_dyx(w)
    return torch.stack([WC.window_conv(f, p, wd, b, ksize=ksize)
                        for f, p in zip(feats, plans)])


class WinSubMStage(nn.Module):
    """n x [windowed subm conv (no bias) + BN + ReLU] on voxel rows."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}_weight", _kernel(cin, ch))
            setattr(self, f"norm_{i}", BatchNorm(ch, channel_dim=-1))
            cin = ch

    def forward(self, feats, valid, plans):
        m = valid[..., None]
        for i in range(self.n):
            feats = _win_conv(feats, plans, getattr(self, f"conv_{i}_weight"))
            feats = F.relu(getattr(self, f"norm_{i}")(feats, mask=m)) * m.to(feats.dtype)
        return feats


class WinBasicBlock(nn.Module):
    """Residual block of two windowed subm convs."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1_weight = _kernel(cin, planes)
        self.conv1_bias = nn.Parameter(torch.zeros(planes))
        self.bn1 = BatchNorm(planes, channel_dim=-1)
        self.conv2_weight = _kernel(planes, planes)
        self.conv2_bias = nn.Parameter(torch.zeros(planes))
        self.bn2 = BatchNorm(planes, channel_dim=-1)

    def forward(self, feats, valid, plans):
        mb = valid[..., None]
        m = mb.to(feats.dtype)
        out = _win_conv(feats, plans, self.conv1_weight, self.conv1_bias)
        out = F.relu(self.bn1(out, mask=mb)) * m
        out = _win_conv(out, plans, self.conv2_weight, self.conv2_bias)
        out = self.bn2(out, mask=mb)
        return F.relu(out + feats) * m


class WinDownsample(nn.Module):
    """Strided windowed sparse conv + BN + ReLU: computes the coarse active
    set in (y, x, z) order and its strided plan."""

    def __init__(self, cin: int, out_channels: int, grid_in, stride, padding,
                 ksize=(3, 3, 3), out_budget: Optional[int] = None,
                 window: int = 512, resid_budget: int = 1024):
        super().__init__()
        self.grid_in, self.stride, self.padding = tuple(grid_in), tuple(stride), tuple(padding)
        self.ksize, self.out_budget = tuple(ksize), out_budget
        self.window, self.resid_budget = window, resid_budget
        self.conv_weight = _kernel(cin, out_channels, ksize)
        self.norm = BatchNorm(out_channels, channel_dim=-1)

    def forward(self, feats, coords, lin):
        grid_out = conv_out_grid(self.grid_in, self.stride, self.padding, self.ksize)
        budget = self.out_budget or feats.shape[1]
        ocs, ols, plans = [], [], []
        for c, il in zip(coords, lin):
            oc, ol = WC.downsample_active_set_yxz(
                c, (c >= 0).all(-1), self.grid_in, grid_out, self.stride,
                self.padding, self.ksize, budget)
            plans.append(WC.make_strided_plan(
                il, ol, oc, self.grid_in, grid_out, self.stride, self.padding,
                self.ksize, window=self.window, resid_budget=self.resid_budget))
            ocs.append(oc)
            ols.append(ol)
        oc, ol, plans = torch.stack(ocs), torch.stack(ols), _for_autograd(plans)
        out = _win_conv(feats, plans, self.conv_weight, ksize=self.ksize)
        ovalid = (oc >= 0).all(-1)
        out = F.relu(self.norm(out, mask=ovalid[..., None])) * ovalid[..., None].to(out.dtype)
        return out, oc, ol, ovalid, grid_out, plans


def dense_subm_conv(x, mask, w, b=None, compute_dtype=None):
    """Submanifold conv on a dense NCDHW grid: a same-padded 3D conv whose
    output is masked back to the active set (inactive inputs are zero).
    ``compute_dtype`` casts the conv inputs; the result keeps x's dtype."""
    cd = compute_dtype or x.dtype
    pad = tuple(k // 2 for k in w.shape[2:])
    y = F.conv3d(x.to(cd), w.to(cd), padding=pad).to(x.dtype)
    if b is not None:
        y = y + b.view(1, -1, 1, 1, 1)
    return y * mask


def dense_strided_conv(x, mask, w, stride, padding, compute_dtype=None):
    """Strided sparse conv on a dense grid: the conv plus the kernel-footprint
    dilation of the occupancy mask (a max pool with the conv's kernel,
    stride and padding; the pool pads with -inf like the reference's
    reduce_window)."""
    cd = compute_dtype or x.dtype
    y = F.conv3d(x.to(cd), w.to(cd), stride=tuple(stride), padding=tuple(padding)).to(x.dtype)
    new_mask = F.max_pool3d(mask.float(), tuple(w.shape[2:]), tuple(stride), tuple(padding))
    new_mask = (new_mask > 0).to(x.dtype)
    return y * new_mask, new_mask


class DenseSubMStage(nn.Module):
    """n x [masked dense conv (no bias) + BN + ReLU] (names of WinSubMStage)."""

    def __init__(self, cin: int, channels: Sequence[int], compute_dtype: Optional[str] = None):
        super().__init__()
        self.n, self.cd = len(channels), _dtype(compute_dtype)
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}_weight", _kernel(cin, ch))
            setattr(self, f"norm_{i}", BatchNorm(ch))
            cin = ch

    def forward(self, x, mask):
        for i in range(self.n):
            x = dense_subm_conv(x, mask, getattr(self, f"conv_{i}_weight"), None, self.cd)
            x = F.relu(getattr(self, f"norm_{i}")(x, mask=mask)) * mask
        return x


class DenseBasicBlock(nn.Module):
    """Residual block of two masked dense convs (names of WinBasicBlock)."""

    def __init__(self, cin: int, planes: int, compute_dtype: Optional[str] = None):
        super().__init__()
        self.cd = _dtype(compute_dtype)
        self.conv1_weight = _kernel(cin, planes)
        self.conv1_bias = nn.Parameter(torch.zeros(planes))
        self.bn1 = BatchNorm(planes)
        self.conv2_weight = _kernel(planes, planes)
        self.conv2_bias = nn.Parameter(torch.zeros(planes))
        self.bn2 = BatchNorm(planes)

    def forward(self, x, mask):
        out = dense_subm_conv(x, mask, self.conv1_weight, self.conv1_bias, self.cd)
        out = F.relu(self.bn1(out, mask=mask)) * mask
        out = dense_subm_conv(out, mask, self.conv2_weight, self.conv2_bias, self.cd)
        out = self.bn2(out, mask=mask)
        return F.relu(out + x) * mask


class DenseDownsample(nn.Module):
    """Strided conv + BN + ReLU on the dense grid (names of WinDownsample)."""

    def __init__(self, cin: int, out_channels: int, stride, padding,
                 ksize=(3, 3, 3), compute_dtype: Optional[str] = None):
        super().__init__()
        self.stride, self.padding, self.cd = tuple(stride), tuple(padding), _dtype(compute_dtype)
        self.conv_weight = _kernel(cin, out_channels, ksize)
        self.norm = BatchNorm(out_channels)

    def forward(self, x, mask):
        y, new_mask = dense_strided_conv(x, mask, self.conv_weight, self.stride,
                                         self.padding, self.cd)
        return F.relu(self.norm(y, mask=new_mask)) * new_mask, new_mask


class PlaneKBlock(nn.Module):
    """Residual block of two fused plane subm convs (names of
    DenseBasicBlock). Bias, inference BatchNorm, ReLU, the residual and the
    occupancy mask fold into the conv's epilogue; inference only."""

    engine = "plane"
    conv = staticmethod(PK.pk_subm_conv)

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.planes = planes
        self.conv1_weight = _kernel(cin, planes)
        self.conv1_bias = nn.Parameter(torch.zeros(planes))
        self.bn1 = BatchNorm(planes)
        self.conv2_weight = _kernel(planes, planes)
        self.conv2_bias = nn.Parameter(torch.zeros(planes))
        self.bn2 = BatchNorm(planes)

    def _fold(self, bias, bn):
        return PK.fold_epilogue(self.planes, bias=bias, bn_scale=bn.weight, bn_bias=bn.bias,
                                bn_mean=bn.running_mean, bn_var=bn.running_var, eps=bn.eps)

    def forward(self, state, mask, plan):
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__} runs inference only; the {self.engine} engine's "
                "training half comes with the training slice")
        mask16 = PK.expand_mask(mask, self.planes).to(state.dtype)
        sc1, sh1 = self._fold(self.conv1_bias, self.bn1)
        sc2, sh2 = self._fold(self.conv2_bias, self.bn2)
        out = self.conv(state, plan, _taps(self.conv1_weight), sc1, sh1, mask16, relu=True)
        return self.conv(out, plan, _taps(self.conv2_weight), sc2, sh2, mask16,
                         residual=state, relu=True)


class TileKBlock(PlaneKBlock):
    """Residual block of two fused tile subm convs on z-major tile state
    (tz, B * T1p, 16C) (names of DenseBasicBlock); inference only."""

    engine = "tile"
    conv = staticmethod(TKK.tk_subm_conv)


class TileKStage(nn.Module):
    """n x [fused tile subm conv (no bias) + BN + ReLU] (names of
    WinSubMStage); inference only. The weights keep the true input width;
    their taps get zero rows for the state's channel padding."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}_weight", _kernel(cin, ch))
            setattr(self, f"norm_{i}", BatchNorm(ch))
            cin = ch

    def forward(self, state, mask, plan: TKK.TKPlan):
        if self.training:
            raise NotImplementedError(
                "TileKStage runs inference only; the tile engine's training half (the XLA "
                "tile engine) comes with the training slice")
        for i, ch in enumerate(self.channels):
            w = _taps(getattr(self, f"conv_{i}_weight"))
            w = F.pad(w, (0, 0, 0, state.shape[-1] // 16 - w.shape[1]))
            bn = getattr(self, f"norm_{i}")
            sc, sh = PK.fold_epilogue(ch, bn_scale=bn.weight, bn_bias=bn.bias,
                                      bn_mean=bn.running_mean, bn_var=bn.running_var,
                                      eps=bn.eps)
            mask16 = TKK.expand_mask(mask, ch).to(state.dtype)
            state = TKK.tk_subm_conv(state, plan, w, sc, sh, mask16, relu=True)
        return state


class TileDownsample(nn.Module):
    """Strided (2, 2, 2) conv + BN + ReLU in the chunk-planes layout (names
    of DenseDownsample)."""

    def __init__(self, cin: int, out_channels: int, tz: int, tz_out: int, budget_out: int,
                 padding, ksize=(3, 3, 3), compute_dtype: Optional[str] = None):
        super().__init__()
        self.tz, self.tz_out, self.budget_out = tz, tz_out, budget_out
        self.padding, self.ksize, self.cd = tuple(padding), tuple(ksize), _dtype(compute_dtype)
        self.conv_weight = _kernel(cin, out_channels, ksize)
        self.norm = BatchNorm(out_channels, channel_dim=-1)

    def forward(self, ys, masks, sets, grid):
        """Per sample: chunk planes (N, 4, 4, C), mask (N, 4, 4, 1), chunk
        TileSet. Returns (y (B, N', 4, 4, Co), mask (B, N', 4, 4, 1), output
        TileSets, output grid)."""
        w = _taps(self.conv_weight)
        outs = [TP.downsample(y, m, ts, grid, w, self.ksize, self.padding, self.tz,
                              self.tz_out, self.budget_out, self.cd)
                for y, m, ts in zip(ys, masks, sets)]
        y = torch.stack([o[0] for o in outs])
        mout = torch.stack([o[1] for o in outs])
        y = F.relu(self.norm(y, mask=mout)) * mout.to(y.dtype)
        return y, mout, [o[2] for o in outs], outs[0][3]


class TileZConv(nn.Module):
    """extra_conv in the chunk-planes layout: (3, 1, 1) stride (2, 1, 1) conv
    + BN + ReLU inside a single z-chunk (names of DenseDownsample)."""

    def __init__(self, cin: int, out_channels: int, d: int, tz: int,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.d, self.tz, self.cd = d, tz, _dtype(compute_dtype)
        self.conv_weight = _kernel(cin, out_channels, (3, 1, 1))
        self.norm = BatchNorm(out_channels, channel_dim=-1)

    def forward(self, ys, masks):
        w = _taps(self.conv_weight)
        outs = [TP.zconv(y, m, w, self.d, self.tz, self.cd) for y, m in zip(ys, masks)]
        y = torch.stack([o[0] for o in outs])
        m = torch.stack([o[1] for o in outs])
        return F.relu(self.norm(y, mask=m)) * m.to(y.dtype), m


def densify(feats, coords, valid, grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows -> (dense (B, C, D, H, W), occupancy mask (B, 1, D, H, W))."""
    dense = torch.stack([scatter_to_dense(f, c, v, grid) for f, c, v in zip(feats, coords, valid)])
    ones = valid[..., None].to(feats.dtype)
    mask = torch.stack([scatter_to_dense(o, c, v, grid) for o, c, v in zip(ones, coords, valid)])
    return dense.permute(0, 4, 1, 2, 3).contiguous(), mask.permute(0, 4, 1, 2, 3).contiguous()


def dense_to_bev(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> NHWC (B, H, W, C*D) with channel index c*D + d
    (the torch ``view(N, C*D, H, W)`` layout)."""
    b, c, d, h, w = x.shape
    return x.reshape(b, c * d, h, w).permute(0, 2, 3, 1)


_STAGES = [  # (name, channels, down stride, down padding, down ksize)
    ("conv2", 32, (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("conv3", 64, (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("conv4", 128, (2, 2, 2), (0, 1, 1), (3, 3, 3)),
]


class SpMiddleResNetFHD(nn.Module):
    """CenterPoint residual sparse backbone, window, plane or tile engine.

    forward(voxel_features (B, V, C), coords (B, V, 3) zyx)
      -> (bev NHWC (B, H/8, W/8, 128*2), multi_scale, telemetry)
    where telemetry maps each counter to (per-sample counts (B,), budget):
    the window plan groups ("conv1", "conv2_down") to their residual rows
    and budget; with the plane engine "plane_drop", "planek_miss",
    "plane_chunk_drop" and "down_drop", with the tile engine
    "conv1_tile_drop", "tilek_miss" and "down_drop" (each summed over the
    stages) to budget 0. The result is exact while every count is within its
    budget.

    ``engine="window"``: ``dense_from_stage`` 1 runs conv1 and conv2_down
    sparse and the rest dense (the shipped setting); 0 runs every stage
    dense. ``engine="plane"`` runs conv1 and conv2_down on the window engine
    and conv2..conv4 as fused plane convs (inference only), with the
    reference's plane knobs: per-stage z-chunk heights ``tile_tz``, chunk
    budgets ``tile_budgets``, plane budgets ``plane_budgets`` (conv2..conv4)
    and plan windows ``plane_window`` (an int, or per stage an int or a
    (w0, wy) pair); ``dense_from_stage`` is not read. ``engine="tile"`` with
    ``tile_backend="pallas"`` (inference only) runs the stages before
    ``dense_from_stage`` (1 to 4; above 4 also ``extra_conv``) on z-chunked
    4x4 BEV tiles (``tile_size``) of per-stage heights ``tile_tz`` within
    the tile budgets ``tile_budgets``, with plan windows ``tilek_window`` (an
    int, or per stage (conv1..conv4) an int or a (w0, wz) pair).
    """

    def __init__(self, num_input_features: int = 128,
                 sparse_shape: Tuple[int, int, int] = (41, 1504, 1504),
                 stage_budgets: Optional[Tuple[int, int, int, int]] = None,
                 dense_from_stage: Optional[int] = 2, engine: str = "gather",
                 win_window: int = 384, win_resid_budget: int = 16384,
                 dense_compute_dtype: Optional[str] = None,
                 tile_size: Tuple[int, int] = (4, 4),
                 tile_tz: Tuple[int, int, int, int] = (8, 4, 2, 6),
                 tile_budgets: Tuple[int, int, int, int] = (72000, 36000, 14000, 2400),
                 tile_backend: str = "xla", tilek_window=256,
                 plane_budgets: Tuple[int, int, int] = (80000, 26000, 6400),
                 plane_window=128):
        super().__init__()
        dfs = 99 if dense_from_stage is None else dense_from_stage
        if engine not in ("window", "plane", "tile"):
            raise NotImplementedError(
                f"engine={engine!r}: this port runs engine='window', 'plane' and 'tile'; "
                "'gather' and 'column' come in a later slice")
        if engine == "tile" and tile_backend != "pallas":
            raise NotImplementedError(
                f"tile_backend={tile_backend!r}: this port runs the tile engine's fused "
                "inference backend 'pallas'; the trainable XLA tile engine comes with the "
                "training slice")
        if engine == "tile" and dfs <= 0:
            raise NotImplementedError(
                "dense_from_stage=0 with the tile engine (a dense conv1 fed from the tile "
                "state) comes in a later slice")
        if engine == "tile" and tuple(tile_size) != (4, 4):
            raise ValueError(f"the tile kernel needs 4x4 BEV tiles, got {tile_size}")
        if engine == "window" and dfs not in (0, 1):
            raise NotImplementedError(
                f"dense_from_stage={dense_from_stage}: sparse stages past conv2_down "
                "need a window kernel for 64/128 channels, a later slice")
        self.engine = engine
        self.sparse_shape = tuple(sparse_shape)
        self.stage_budgets = stage_budgets
        self.dfs = 1 if engine == "plane" else dfs
        self.win_window, self.win_resid_budget = win_window, win_resid_budget
        self.tile_tz, self.tile_budgets = tuple(tile_tz), tuple(tile_budgets)
        self.tile_wins = _stage_wins(tilek_window, 4)
        self.plane_budgets = tuple(plane_budgets)
        self.plane_wins = _stage_wins(plane_window, 3)
        cd = dense_compute_dtype
        self.cd = _dtype(cd)
        cin = num_input_features
        if engine == "tile":
            _check_tile_chain(self.sparse_shape, self.tile_tz)
            self.conv_input = TileKStage(cin, (16,))
            self.conv1_0 = TileKBlock(16, 16)
            self.conv1_1 = TileKBlock(16, 16)
        elif self.dfs == 0:
            self.conv_input = DenseSubMStage(cin, (16,), compute_dtype=cd)
            self.conv1_0 = DenseBasicBlock(16, 16, compute_dtype=cd)
            self.conv1_1 = DenseBasicBlock(16, 16, compute_dtype=cd)
        else:
            self.conv_input = WinSubMStage(cin, (16,))
            self.conv1_0 = WinBasicBlock(16, 16)
            self.conv1_1 = WinBasicBlock(16, 16)
        cin, grid = 16, self.sparse_shape
        for k, (name, ch, stride, pad, ksz) in enumerate(_STAGES, start=1):
            if engine == "tile" and k <= self.dfs or engine == "plane" and k > 1:
                down = TileDownsample(cin, ch, tz=self.tile_tz[k - 1], tz_out=self.tile_tz[k],
                                      budget_out=self.tile_budgets[k], padding=pad,
                                      ksize=ksz, compute_dtype=cd)
            elif k <= self.dfs:
                budget = stage_budgets[k - 1] if stage_budgets else None
                down = WinDownsample(cin, ch, grid, stride, pad, ksz, out_budget=budget,
                                     window=win_window, resid_budget=win_resid_budget)
            else:
                down = DenseDownsample(cin, ch, stride, pad, ksz, compute_dtype=cd)
            setattr(self, f"{name}_down", down)
            if engine == "plane":
                block = PlaneKBlock
            elif engine == "tile" and k < self.dfs:
                block = TileKBlock
            else:
                block = partial(DenseBasicBlock, compute_dtype=cd)
            setattr(self, f"{name}_0", block(ch, ch))
            setattr(self, f"{name}_1", block(ch, ch))
            cin, grid = ch, conv_out_grid(grid, stride, pad, ksz)
        if engine == "plane" or engine == "tile" and self.dfs > 4:
            self.extra_conv = TileZConv(128, 128, d=grid[0], tz=self.tile_tz[3],
                                        compute_dtype=cd)
        else:
            self.extra_conv = DenseDownsample(128, 128, (2, 1, 1), (0, 0, 0), (3, 1, 1),
                                              compute_dtype=cd)

    def _dense_stream(self, feats, coords, valid, grid):
        """Densify in the dense stages' storage dtype (cast before the
        scatter, so no f32 dense grid is built)."""
        if self.cd is not None:
            feats = feats.to(self.cd)
        return densify(feats, coords, valid, grid)

    def _window_stages(self, feats, coords, grid, telemetry, multi_scale):
        """conv1 stage and the strided conv2_down on the window engine."""
        rows = [WC.sort_rows(f, c, grid) for f, c in zip(feats, coords)]
        feats, coords, lin = (torch.stack(t) for t in zip(*rows))
        valid = lin < WC.MISS
        plans = _for_autograd([WC.make_subm_plan_presorted(l, c, grid, window=self.win_window)
                               for l, c in zip(lin, coords)])
        telemetry["conv1"] = (torch.stack([p.n_resid for p in plans]),
                              plans[0].resid_rows.shape[0])
        feats = self.conv_input(feats, valid, plans)
        feats = self.conv1_1(self.conv1_0(feats, valid, plans), valid, plans)
        multi_scale["conv1"] = ((feats, coords, valid), grid)
        feats, coords, lin, valid, grid, plans = self.conv2_down(feats, coords, lin)
        telemetry["conv2_down"] = (torch.stack([p.n_resid for p in plans]),
                                   self.win_resid_budget)
        return feats, coords, valid, grid

    def forward(self, voxel_features, coords):
        coords = coords.to(torch.int32)
        valid0 = (coords >= 0).all(-1)
        feats = voxel_features * valid0[..., None].to(voxel_features.dtype)
        grid = self.sparse_shape
        telemetry: Dict[str, Tuple[torch.Tensor, int]] = {}
        multi_scale: Dict[str, tuple] = {}
        if self.engine == "plane":
            return self._plane_forward(feats, coords, grid, telemetry, multi_scale)
        if self.engine == "tile":
            return self._tile_forward(feats, coords, grid, telemetry, multi_scale)

        if self.dfs == 0:
            x, mask = self._dense_stream(feats, coords, valid0, grid)
            x = self.conv_input(x, mask)
            x = self.conv1_1(self.conv1_0(x, mask), mask)
            multi_scale["conv1"] = (x, grid)
        else:
            feats, coords, valid, grid = self._window_stages(feats, coords, grid, telemetry,
                                                             multi_scale)
            x, mask = self._dense_stream(feats, coords, valid, grid)

        for k, (name, _, stride, pad, ksz) in enumerate(_STAGES, start=1):
            if k > self.dfs:
                x, mask = getattr(self, f"{name}_down")(x, mask)
                grid = conv_out_grid(grid, stride, pad, ksz)
            x = getattr(self, f"{name}_0")(x, mask)
            x = getattr(self, f"{name}_1")(x, mask)
            multi_scale[name] = (x, grid)
        x, mask = self.extra_conv(x, mask)
        return dense_to_bev(x), multi_scale, telemetry

    def _chunk_planes(self, state, mask, sets, grid, tz, budget_t, counts):
        """Plane rows -> chunk planes of the chunk sets that cover the planes
        (a row permutation). Returns (planes, masks, chunk sets) per sample."""
        b = len(sets)
        t1p = state.shape[0] // b
        sb = state.reshape(b, t1p, -1)
        mb = mask.reshape(b, t1p, 16).to(state.dtype)
        cts = [PK.chunk_set_of_planes(t, grid, tz, budget_t) for t in sets]
        counts["plane_chunk_drop"] += torch.stack([c.n_drop for c in cts])
        pocs = [PK.plane_ranks_of_chunks(c, t, grid, tz, t1p - 1) for c, t in zip(cts, sets)]
        pch = [PK.plane_state_to_planes(s, po, tz) for s, po in zip(sb, pocs)]
        mch = [PK.plane_state_to_planes(m, po, tz) for m, po in zip(mb, pocs)]
        return pch, mch, cts

    def _plane_down(self, k, name, state, mask, sets, grid, counts):
        """Strided transition between plane stages: plane rows -> chunk
        planes, chunk-layout strided conv, -> the next stage's plane set and
        state."""
        tz, tz_out = self.tile_tz[k], self.tile_tz[k + 1]
        tbud_out, pbud_out = self.tile_budgets[k + 1], self.plane_budgets[k]
        pch, mch, cts = self._chunk_planes(state, mask, sets, grid, tz, self.tile_budgets[k],
                                           counts)
        y, mo, tso, grid_out = getattr(self, f"{name}_down")(pch, mch, cts, grid)
        counts["down_drop"] += torch.stack([t.n_drop for t in tso])
        t1p_out = PK.t1p_of(pbud_out)
        pts = [PK.plane_set_from_chunk_mask(m, t, grid_out, tz_out, pbud_out)
               for m, t in zip(mo, tso)]
        counts["plane_drop"] += torch.stack([t.n_drop for t in pts])
        cr = [PK.chunk_ranks_of_planes(p, t, grid_out, tz_out, tbud_out)
              for p, t in zip(pts, tso)]
        state = torch.cat([PK.planes_to_plane_state(yy, c, t1p_out) for yy, c in zip(y, cr)])
        mask = torch.cat([PK.planes_to_plane_state(m, c, t1p_out) for m, c in zip(mo, cr)])
        return state, mask, pts, grid_out

    def _plane_forward(self, feats, coords, grid, telemetry, multi_scale):
        """conv1 + conv2_down on the window engine; conv2..conv4 as fused
        plane convs over the batch flattened to (B * T1p) plane rows, with
        the strided transitions and extra_conv in the chunk-planes layout."""
        out_dtype = feats.dtype
        feats, coords, valid, grid = self._window_stages(feats, coords, grid, telemetry,
                                                         multi_scale)
        cd = self.cd or feats.dtype
        b = feats.shape[0]
        counts = {k: torch.zeros(b, dtype=torch.int32, device=feats.device)
                  for k in ("plane_drop", "planek_miss", "plane_chunk_drop", "down_drop")}
        state = mask = sets = None
        for k, (name, _, _, _, _) in enumerate(_STAGES):
            t1p = PK.t1p_of(self.plane_budgets[k])
            if k == 0:
                sets = [PK.build_plane_set(c, grid, self.plane_budgets[0])[0] for c in coords]
                counts["plane_drop"] += torch.stack([t.n_drop for t in sets])
                st = [PK.build_plane_state(f.to(cd), c, t, grid, t1p)
                      for f, c, t in zip(feats, coords, sets)]
                state = torch.cat([s_[0] for s_ in st])
                mask = torch.cat([s_[1] for s_ in st])
            else:
                state, mask, sets, grid = self._plane_down(k, name, state, mask, sets, grid,
                                                           counts)
            plan = PK.make_plane_plan_batched(sets, t1p, *self.plane_wins[k])
            counts["planek_miss"] += plan.n_miss
            state = getattr(self, f"{name}_0")(state, mask, plan)
            state = getattr(self, f"{name}_1")(state, mask, plan)
            multi_scale[name] = ((state, mask, sets), grid)

        pch, mch, cts = self._chunk_planes(state, mask, sets, grid, self.tile_tz[3],
                                           self.tile_budgets[3], counts)
        y, _ = self.extra_conv(pch, mch)                      # (B, T1, d2, 4, 4, C)
        g4 = ((grid[0] - 3) // 2 + 1, grid[1], grid[2])
        dense = torch.stack([TLC.tiles_to_dense(yy, t, g4, yy.shape[1])
                             for yy, t in zip(y, cts)])        # (B, D, H, W, C)
        telemetry.update({k: (v, 0) for k, v in counts.items()})
        return dense_to_bev(dense.to(out_dtype).permute(0, 4, 1, 2, 3)), multi_scale, telemetry

    def _tile_stage(self, k, state, mask, sets, counts, modules):
        """Subm convs of stage k on tile state (tz, B * T1p, 16C)."""
        plan = TKK.make_block_plan_batched(sets, TKK.t1p_of(self.tile_budgets[k]),
                                           *self.tile_wins[k])
        counts["tilek_miss"] += plan.n_miss
        for mod in modules:
            state = mod(state, mask, plan)
        return state

    def _tile_forward(self, feats, coords, grid, telemetry, multi_scale):
        """Stages before ``dense_from_stage`` on z-chunked tiles: fused subm
        convs on tile state over the batch flattened to (B * T1p) tile rows,
        strided convs (and, past stage 4, ``extra_conv``) in the
        chunk-planes layout; densify at the transition."""
        out_dtype = feats.dtype
        feats = feats.to(self.cd or feats.dtype)
        if feats.shape[-1] < 16:  # the state's channels are padded to 16
            feats = F.pad(feats, (0, 16 - feats.shape[-1]))
        b, dev = feats.shape[0], feats.device
        tzs, tbud, dfs = self.tile_tz, self.tile_budgets, self.dfs
        counts = {k: torch.zeros(b, dtype=torch.int32, device=dev)
                  for k in ("conv1_tile_drop", "tilek_miss", "down_drop")}

        def to_planes(state, mask, k):
            t1p = TKK.t1p_of(tbud[k])
            return (TKK.state_to_planes_batched(state, b, t1p, tzs[k], tbud[k] + 1),
                    TKK.state_to_planes_batched(mask, b, t1p, tzs[k], tbud[k] + 1))

        def densify_tiles(p, mk, sets, grid, tz):
            dense = [torch.stack([TP.to_dense(y, t, grid, tz) for y, t in zip(a, sets)])
                     for a in (p, mk)]
            return tuple(d.permute(0, 4, 1, 2, 3).contiguous() for d in dense)

        sets = [TLC.build_tile_set(c, grid, 4, 4, tzs[0], tbud[0])[0] for c in coords]
        counts["conv1_tile_drop"] += torch.stack([t.n_drop for t in sets])
        state, mask = TKK.build_state_batched(feats, coords, sets, grid, 4, 4, tzs[0],
                                              TKK.t1p_of(tbud[0]))
        state = self._tile_stage(0, state, mask, sets, counts,
                                 (self.conv_input, self.conv1_0, self.conv1_1))
        p, mk = to_planes(state, mask, 0)
        multi_scale["conv1"] = ((p, mk, sets), grid)

        x = dmask = None
        for k, (name, _, stride, pad, ksz) in enumerate(_STAGES, start=1):
            down = getattr(self, f"{name}_down")
            if k <= dfs:
                p, mk, sets, grid = down(p, mk, sets, grid)
                counts["down_drop"] += torch.stack([t.n_drop for t in sets])
                if k == dfs:
                    x, dmask = densify_tiles(p, mk, sets, grid, tzs[k])
            else:
                x, dmask = down(x, dmask)
                grid = conv_out_grid(grid, stride, pad, ksz)
            blocks = (getattr(self, f"{name}_0"), getattr(self, f"{name}_1"))
            if x is None:
                t1p = TKK.t1p_of(tbud[k])
                state = TKK.planes_to_state_batched(p, tzs[k], t1p)
                mask = TKK.planes_to_state_batched(mk, tzs[k], t1p)
                p, mk = to_planes(self._tile_stage(k, state, mask, sets, counts, blocks),
                                  mask, k)
                multi_scale[name] = ((p, mk, sets), grid)
            else:
                x = blocks[1](blocks[0](x, dmask), dmask)
                multi_scale[name] = (x, grid)
        telemetry.update({k: (v, 0) for k, v in counts.items()})

        if dfs > 4:
            y, _ = self.extra_conv(p, mk)                      # (B, T1, d2, 4, 4, C)
            g4 = ((grid[0] - 3) // 2 + 1, grid[1], grid[2])
            dense = torch.stack([TLC.tiles_to_dense(yy, t, g4, yy.shape[1])
                                 for yy, t in zip(y, sets)])   # (B, D, H, W, C)
            x = dense.permute(0, 4, 1, 2, 3)
        else:
            if x is None:
                x, dmask = densify_tiles(p, mk, sets, grid, tzs[3])
            x, _ = self.extra_conv(x, dmask)
        return dense_to_bev(x.to(out_dtype)), multi_scale, telemetry


def _check_tile_chain(grid: Sequence[int], tzs: Sequence[int]) -> None:
    """Each strided conv needs 2 * tz_out == tz or one output chunk, and
    conv4's chunk must cover its grid (the reference's static asserts)."""
    d_chain = [grid[0]]
    for pz in (1, 1, 0):
        d_chain.append((d_chain[-1] + 2 * pz - 3) // 2 + 1)
    for k in range(1, 4):
        if not (2 * tzs[k] == tzs[k - 1] or tzs[k] >= d_chain[k]):
            raise ValueError(f"tile_tz[{k}]={tzs[k]} breaks the chunk chain at d={d_chain[k]}")
    if tzs[3] < d_chain[3]:
        raise ValueError(f"tile_tz[3]={tzs[3]}: the conv4 z-chunk must cover d={d_chain[3]}")


def _stage_wins(win, n: int) -> List[Tuple[int, int]]:
    """Per-stage plan windows from an int or an n-tuple of ints or pairs."""
    if isinstance(win, (tuple, list)):
        if len(win) != n:
            raise ValueError(f"expected an int or {n} per-stage windows, got {win!r}")
        return [(int(w), int(w)) if not isinstance(w, (tuple, list)) else (int(w[0]), int(w[1]))
                for w in win]
    return [(int(win), int(win))] * n
