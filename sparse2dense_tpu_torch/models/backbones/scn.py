"""SpMiddleResNetFHD (gather, window, plane and tile engines) and SpMiddleFHD
(gather and window engines): the counterpart of
``sparse2dense_tpu/models/backbones/scn.py``.

With ``engine="gather"`` (the reference's default), the sparse stages run as
gather-GEMM convs through neighbour tables (``ops/sparse_conv.py``; plain
autograd in training). With ``engine="window"`` and ``"plane"``, the conv1
stage (conv_input, conv1_0, conv1_1) and the strided conv2_down run as
windowed sparse convs on voxel rows (``ops/window_conv.py``; the window pass
is the hand-written CUDA kernel on the card). With ``engine="window"``, the stages from
``dense_from_stage`` on run as masked dense 3D convs: one ``F.conv3d``
followed by the occupancy mask is the operator the reference's z-packed /
z-decomposed TPU convs compute. With ``engine="plane"``, conv2 to conv4 run as
fused submanifold convs over the occupied (by, bx, z) planes of 4x4 BEV tiles
(``ops/plane_conv.py``; the conv is the hand-written CUDA kernel on the
card), and the strided transitions and ``extra_conv`` in the chunk-planes
layout (``ops/tile_planes.py``). With ``engine="tile"``, every stage before
``dense_from_stage`` runs on z-chunked 4x4 BEV tiles: the subm convs as
fused tile convs (``ops/tile_kernel.py``; the conv is the hand-written CUDA
kernel on the card; in training under autograd, ``TileConv``), the strided
convs in the chunk-planes layout; the rest is dense. Rows are (B, V, C); dense tensors
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
from ...ops.sparse_conv import (build_index_grid_batched, conv_out_grid,
                                downsample_active_set_batched,
                                downsample_neighbor_table_batched, gather_conv_batched,
                                scatter_to_dense, subm_neighbor_table_batched)
from ..norm import BatchNorm
from ..remat import remat


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


def _gather_conv(feats, nbr, w, b=None):
    """The gather engine's conv: through the batched neighbour table
    (B, V_out, K), taps in the kernel's z-major order."""
    return gather_conv_batched(feats, nbr, _taps(w), b)


class WinSubMStage(nn.Module):
    """n x [windowed subm conv (no bias) + BN + ReLU] on voxel rows."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}_weight", _kernel(cin, ch))
            setattr(self, f"norm_{i}", BatchNorm(ch, channel_dim=-1))
            cin = ch

    def _conv(self, feats, plans, w, b=None):
        return _win_conv(feats, plans, w, b)

    def forward(self, feats, valid, plans):
        m = valid[..., None]
        for i in range(self.n):
            feats = self._conv(feats, plans, getattr(self, f"conv_{i}_weight"))
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

    _conv = WinSubMStage._conv

    def forward(self, feats, valid, plans):
        mb = valid[..., None]
        m = mb.to(feats.dtype)
        out = self._conv(feats, plans, self.conv1_weight, self.conv1_bias)
        out = F.relu(self.bn1(out, mask=mb)) * m
        out = self._conv(out, plans, self.conv2_weight, self.conv2_bias)
        out = self.bn2(out, mask=mb)
        return F.relu(out + feats) * m


class SubMStage(WinSubMStage):
    """The gather engine's n x [subm conv + BN + ReLU]: each conv through one
    shared neighbour table (B, V, 27) (``forward(feats, valid, nbr)``)."""

    def _conv(self, feats, nbr, w, b=None):
        return _gather_conv(feats, nbr, w, b)


class SparseBasicBlock(WinBasicBlock):
    """The gather engine's residual block of two subm convs."""

    _conv = SubMStage._conv


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


class SparseDownsample(nn.Module):
    """The gather engine's strided sparse conv + BN + ReLU: the coarse
    active set in grid-linear order, its neighbour table through the input's
    index grid (names of WinDownsample)."""

    def __init__(self, cin: int, out_channels: int, grid_in, stride, padding,
                 ksize=(3, 3, 3), out_budget: Optional[int] = None):
        super().__init__()
        self.grid_in, self.stride, self.padding = tuple(grid_in), tuple(stride), tuple(padding)
        self.ksize, self.out_budget = tuple(ksize), out_budget
        self.conv_weight = _kernel(cin, out_channels, ksize)
        self.norm = BatchNorm(out_channels, channel_dim=-1)

    def forward(self, feats, coords, valid):
        """-> (features, coords, valid, grid) of the output rows."""
        grid_out = conv_out_grid(self.grid_in, self.stride, self.padding, self.ksize)
        budget = self.out_budget or feats.shape[1]
        oc, ov = downsample_active_set_batched(coords, valid, self.grid_in, grid_out,
                                               self.stride, self.padding, self.ksize, budget)
        nbr = downsample_neighbor_table_batched(
            oc, ov, build_index_grid_batched(coords, valid, self.grid_in), self.grid_in,
            self.stride, self.padding, self.ksize)
        out = _gather_conv(feats, nbr, self.conv_weight)
        m = ov[..., None]
        return F.relu(self.norm(out, mask=m)) * m.to(out.dtype), oc, ov, grid_out


def _subm_table(coords, valid, grid):
    """The gather engine's (B, V, 27) subm neighbour table of a stage."""
    return subm_neighbor_table_batched(coords, valid,
                                       build_index_grid_batched(coords, valid, grid), grid)


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
    DenseBasicBlock). In inference, bias, BatchNorm, ReLU, the residual and
    the occupancy mask fold into the conv's epilogue. In training each conv
    is the masked linear conv under autograd (``plane_conv.pk_subm_conv_train``:
    the kernel forward, a plain VJP backward over ``plan.nbr``), followed by
    the bias, masked BatchNorm over (..., 16 cells, C) with batch
    statistics, a cast to the state's dtype and ReLU times the mask, in the
    reference's order."""

    engine = "plane"
    conv = staticmethod(PK.pk_subm_conv)
    conv_train = staticmethod(PK.pk_subm_conv_train)
    remat_epilogue = False

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.planes = planes
        self.conv1_weight = _kernel(cin, planes)
        self.conv1_bias = nn.Parameter(torch.zeros(planes))
        self.bn1 = BatchNorm(planes, channel_dim=-1)
        self.conv2_weight = _kernel(planes, planes)
        self.conv2_bias = nn.Parameter(torch.zeros(planes))
        self.bn2 = BatchNorm(planes, channel_dim=-1)

    def _fold(self, bias, bn):
        return PK.fold_epilogue(self.planes, bias=bias, bn_scale=bn.weight, bn_bias=bn.bias,
                                bn_mean=bn.running_mean, bn_var=bn.running_var, eps=bn.eps)

    def forward(self, state, mask, plan):
        mask16 = PK.expand_mask(mask, self.planes).to(state.dtype)
        if self.training:
            return self._train_forward(state, mask, mask16, plan)
        sc1, sh1 = self._fold(self.conv1_bias, self.bn1)
        sc2, sh2 = self._fold(self.conv2_bias, self.bn2)
        out = self.conv(state, plan, _taps(self.conv1_weight), sc1, sh1, mask16, relu=True)
        return self.conv(out, plan, _taps(self.conv2_weight), sc2, sh2, mask16,
                         residual=state, relu=True)

    def _train_forward(self, state, mask, mask16, plan):
        cells = mask.reshape(*state.shape[:-1], 16, 1)

        def epilogue(x, bias, norm, residual=None):
            x = _masked_bn(x + bias.repeat(16).to(x.dtype), norm, cells, self.planes)
            return F.relu(x if residual is None else x + residual) * mask16

        post = partial(_remat_epilogue, epilogue) if self.remat_epilogue else epilogue
        out = self.conv_train(state, plan, _taps(self.conv1_weight), mask16)
        out = post(out, self.conv1_bias, self.bn1)
        out = self.conv_train(out, plan, _taps(self.conv2_weight), mask16)
        return post(out, self.conv2_bias, self.bn2, state)


def _masked_bn(x, norm, cells, c):
    """BatchNorm ``norm`` over (..., 16 cells, c) of the cells ``cells``
    marks, on state rows (..., 16c), in the state's dtype."""
    lead = x.shape[:-1]
    return norm(x.reshape(*lead, 16, c), mask=cells).reshape(*lead, 16 * c).to(x.dtype)


def _remat_epilogue(fn, *args):
    """``fn(*args)``, a train-mode epilogue (bias, BatchNorm, residual, ReLU,
    mask), rematerialised: its float32 BatchNorm intermediates over the
    whole tile state are rebuilt in the backward, not kept."""
    return remat(fn, *args, name="tile epilogue")


class TileKBlock(PlaneKBlock):
    """Residual block of two fused tile subm convs on z-major tile state
    (tz, B * T1p, 16C) (names of DenseBasicBlock); in training each conv is
    ``TileConv`` (``tile_kernel.tk_subm_conv_train``), as the reference's
    ``TileBasicBlock`` orders it."""

    engine = "tile"
    conv = staticmethod(TKK.tk_subm_conv)
    conv_train = staticmethod(TKK.tk_subm_conv_train)
    # the tile state holds every z plane of a chunk (~6x the live planes at
    # conv1 of the flagship frame): without this the recipe's batch of 3
    # does not fit in training
    remat_epilogue = True


class TileKStage(nn.Module):
    """n x [fused tile subm conv (no bias) + BN + ReLU] (names of
    WinSubMStage); in training the conv is ``TileConv`` followed by masked
    BatchNorm with batch statistics and ReLU times the mask (the
    reference's ``TileSubMStage``). The weights keep the true input width;
    their taps get zero rows for the state's channel padding."""

    def __init__(self, cin: int, channels: Sequence[int]):
        super().__init__()
        self.channels = tuple(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}_weight", _kernel(cin, ch))
            setattr(self, f"norm_{i}", BatchNorm(ch, channel_dim=-1))
            cin = ch

    def forward(self, state, mask, plan: TKK.TKPlan):
        cells = mask.reshape(*state.shape[:-1], 16, 1)
        for i, ch in enumerate(self.channels):
            w = _taps(getattr(self, f"conv_{i}_weight"))
            w = F.pad(w, (0, 0, 0, state.shape[-1] // 16 - w.shape[1]))
            bn = getattr(self, f"norm_{i}")
            mask16 = TKK.expand_mask(mask, ch).to(state.dtype)
            if self.training:
                x = TKK.tk_subm_conv_train(state, plan, w, mask16)
                state = _remat_epilogue(  # ch bound now: the recompute runs later
                    lambda x, norm, m16, c=ch: F.relu(_masked_bn(x, norm, cells, c)) * m16,
                    x, bn, mask16)
                continue
            sc, sh = PK.fold_epilogue(ch, bn_scale=bn.weight, bn_bias=bn.bias,
                                      bn_mean=bn.running_mean, bn_var=bn.running_var,
                                      eps=bn.eps)
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


def sparse_to_bev(feats, coords, valid, grid) -> torch.Tensor:
    """Rows -> NHWC BEV (B, H, W, C*D): spconv's ``.dense()`` and the torch
    ``view(N, C*D, H, W)``."""
    dense = torch.stack([scatter_to_dense(f, c, v, grid) for f, c, v in zip(feats, coords, valid)])
    return dense_to_bev(dense.permute(0, 4, 1, 2, 3))


_STAGES = [  # (name, channels, down stride, down padding, down ksize)
    ("conv2", 32, (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("conv3", 64, (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("conv4", 128, (2, 2, 2), (0, 1, 1), (3, 3, 3)),
]


class _DenseStages(nn.Module):
    """What the backbones share for their masked dense stages: the dense
    compute dtype and the rematerialisation in training."""

    out_channels = 128   # of the last stage; the BEV map has this times its depth

    def __init__(self, remat_dense: bool, dense_compute_dtype: Optional[str]):
        super().__init__()
        self.remat_dense, self.cd = remat_dense, _dtype(dense_compute_dtype)

    @property
    def bev_channels(self) -> int:
        """Channels of the BEV map: the last stage's times the depth left
        after the three strided convs and ``extra_conv``."""
        grid = self.sparse_shape
        for _, _, stride, pad, ksz in _STAGES:
            grid = conv_out_grid(grid, stride, pad, ksz)
        return self.out_channels * conv_out_grid(grid, (2, 1, 1), (0, 0, 0), (3, 1, 1))[0]

    def _dense(self, module, *args):
        """``module(*args)`` for a dense module; in training, with
        ``remat_dense``, rematerialised: its multi-GB activations (the conv2
        stage's are 21x752x752x32 a sample on the Waymo grid) are rebuilt in
        the backward, not kept."""
        if self.remat_dense and self.training and torch.is_grad_enabled():
            return remat(module, *args, name=type(module).__name__)
        return module(*args)

    def _subm_plans(self, k, lin, coords, grid, telemetry, name):
        """The window plans of subm stage k (window ``wins[k]``), with their
        residual rows against their budget in ``telemetry[name]``; with
        their reader tables when gradients will flow."""
        plans = _for_autograd([WC.make_subm_plan_presorted(l, c, grid, window=self.wins[k])
                               for l, c in zip(lin, coords)])
        telemetry[name] = (torch.stack([p.n_resid for p in plans]),
                           plans[0].resid_rows.shape[0])
        return plans

    def _dense_stream(self, feats, coords, valid, grid):
        """Densify in the dense stages' storage dtype (cast before the
        scatter, so no f32 dense grid is built). The gather engine densifies
        in the rows' dtype, as the reference does."""
        if self.cd is not None and self.engine != "gather":
            feats = feats.to(self.cd)
        return densify(feats, coords, valid, grid)


class SpMiddleResNetFHD(_DenseStages):
    """CenterPoint residual sparse backbone, gather, window, plane or tile
    engine.

    forward(voxel_features (B, V, C), coords (B, V, 3) zyx)
      -> (bev NHWC (B, H/8, W/8, 128*2), multi_scale, telemetry)
    where telemetry maps each counter to (per-sample counts (B,), budget):
    the window plan groups (the subm plans of "conv1" and, at
    ``dense_from_stage`` 2, "conv2"; the strided "conv2_down" and
    "conv3_down") to their residual rows and budget; with the plane engine
    "plane_drop", "planek_miss", "plane_chunk_drop" and "down_drop", with
    the tile engine "conv1_tile_drop", "tilek_miss" and "down_drop" (each
    summed over the stages) to budget 0. The result is exact while every
    count is within its budget.

    ``engine="gather"`` (the reference's default) runs the stages before
    ``dense_from_stage`` (any; past 4 also ``extra_conv``) as gather-GEMM
    convs through neighbour tables (``ops/sparse_conv.py``), the rest
    dense; it has no telemetry. ``engine="window"``: ``dense_from_stage`` 1
    runs conv1 and conv2_down sparse and the rest dense (the shipped
    setting); 2 also the conv2 blocks and conv3_down; 0 runs every stage
    dense. ``win_window`` is an int or the four stages' plan windows (conv1,
    conv2 with conv2_down, conv3_down, conv4). ``engine="plane"`` runs conv1
    and conv2_down on the window engine and conv2..conv4 as fused plane
    convs (in training the plane conv under autograd, ``PlaneKBlock``), with
    the reference's plane knobs: per-stage z-chunk heights ``tile_tz``, chunk
    budgets ``tile_budgets``, plane budgets ``plane_budgets`` (conv2..conv4)
    and plan windows ``plane_window`` (an int, or per stage an int or a
    (w0, wy) pair); ``dense_from_stage`` is not read. ``engine="tile"`` runs
    the stages before ``dense_from_stage`` (above 4 also ``extra_conv``; at
    0 it densifies the conv1 tiles and every stage is dense) on z-chunked
    4x4 BEV tiles (``tile_size``) of per-stage heights ``tile_tz`` within
    the tile budgets ``tile_budgets``. ``tile_backend="xla"`` (the
    reference's default) reads every tap, in inference and in training;
    ``"pallas"`` does so in training and, in inference, keeps the plan
    windows ``tilek_window`` (an int, or per stage (conv1..conv4) an int or
    a (w0, wz) pair), whose dropped targets ``tilek_miss`` counts, as the
    reference's fused kernel does. Both run the same modules (in training
    the tile conv under autograd, ``TileConv``).

    In training, the gather and window engines' dense modules
    (``DenseSubMStage``, ``DenseBasicBlock``, ``DenseDownsample``) run
    rematerialised unless ``remat_dense`` is False (``models/remat.py``), as
    the reference's do.
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
                 plane_window=128, remat_dense: bool = True):
        dfs = 99 if dense_from_stage is None else dense_from_stage
        if engine not in ("window", "plane", "tile", "gather"):
            raise NotImplementedError(
                f"engine={engine!r}: this port runs engine='gather', 'window', 'plane' and "
                "'tile'; 'column' (the reference's column oracle) comes in a later slice")
        if engine == "tile" and tile_backend not in ("xla", "pallas"):
            raise ValueError(f"tile_backend={tile_backend!r}: 'xla' or 'pallas'")
        if engine == "tile" and tuple(tile_size) != (4, 4):
            raise ValueError(f"the tile kernel needs 4x4 BEV tiles, got {tile_size}")
        if engine == "window" and dfs not in (0, 1, 2):
            raise NotImplementedError(
                f"dense_from_stage={dense_from_stage}: sparse stages past conv3_down need the "
                "window kernel at 64->64, 64->128 and 128->128 channels (weights streamed "
                "through shared memory), a later slice")
        super().__init__(remat_dense, dense_compute_dtype)
        self.engine = engine
        self.sparse_shape = tuple(sparse_shape)
        self.stage_budgets = stage_budgets
        self.dfs = 1 if engine == "plane" else dfs
        self.wins, self.win_resid_budget = _win_windows(win_window), win_resid_budget
        self.tile_tz, self.tile_budgets = tuple(tile_tz), tuple(tile_budgets)
        self.tile_backend, self.tile_wins = tile_backend, _stage_wins(tilek_window, 4)
        self.plane_budgets = tuple(plane_budgets)
        self.plane_wins = _stage_wins(plane_window, 3)
        cd = dense_compute_dtype
        cin = num_input_features
        if engine == "tile":
            _check_tile_chain(self.sparse_shape, self.tile_tz)
        if engine == "tile" and self.dfs > 0:
            self.conv_input = TileKStage(cin, (16,))
            self.conv1_0 = TileKBlock(16, 16)
            self.conv1_1 = TileKBlock(16, 16)
        elif self.dfs <= 0:
            self.conv_input = DenseSubMStage(cin, (16,), compute_dtype=cd)
            self.conv1_0 = DenseBasicBlock(16, 16, compute_dtype=cd)
            self.conv1_1 = DenseBasicBlock(16, 16, compute_dtype=cd)
        elif engine == "gather":
            self.conv_input = SubMStage(cin, (16,))
            self.conv1_0 = SparseBasicBlock(16, 16)
            self.conv1_1 = SparseBasicBlock(16, 16)
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
                down = (SparseDownsample(cin, ch, grid, stride, pad, ksz, out_budget=budget)
                        if engine == "gather" else
                        WinDownsample(cin, ch, grid, stride, pad, ksz, out_budget=budget,
                                      window=self.wins[k], resid_budget=win_resid_budget))
            else:
                down = DenseDownsample(cin, ch, stride, pad, ksz, compute_dtype=cd)
            setattr(self, f"{name}_down", down)
            if engine == "plane":
                block = PlaneKBlock
            elif engine == "tile" and k < self.dfs:
                block = TileKBlock
            elif engine == "gather" and k < self.dfs:
                block = SparseBasicBlock
            elif engine == "window" and k < self.dfs:
                block = WinBasicBlock
            else:
                block = partial(DenseBasicBlock, compute_dtype=cd)
            setattr(self, f"{name}_0", block(ch, ch))
            setattr(self, f"{name}_1", block(ch, ch))
            cin, grid = ch, conv_out_grid(grid, stride, pad, ksz)
        if engine == "plane" or engine == "tile" and self.dfs > 4:
            self.extra_conv = TileZConv(128, 128, d=grid[0], tz=self.tile_tz[3],
                                        compute_dtype=cd)
        elif engine == "gather" and self.dfs > 4:
            self.extra_conv = SparseDownsample(
                128, 128, grid, (2, 1, 1), (0, 0, 0), (3, 1, 1),
                out_budget=stage_budgets[3] if stage_budgets else None)
        else:
            self.extra_conv = DenseDownsample(128, 128, (2, 1, 1), (0, 0, 0), (3, 1, 1),
                                              compute_dtype=cd)

    def _window_stages(self, feats, coords, grid, telemetry, multi_scale):
        """The conv1 stage and the strided conv2_down on the window engine.
        Returns the conv2 stage's sorted (feats, coords, keys, valid, grid)."""
        rows = [WC.sort_rows(f, c, grid) for f, c in zip(feats, coords)]
        feats, coords, lin = (torch.stack(t) for t in zip(*rows))
        valid = lin < WC.MISS
        plans = self._subm_plans(0, lin, coords, grid, telemetry, "conv1")
        feats = self.conv_input(feats, valid, plans)
        feats = self.conv1_1(self.conv1_0(feats, valid, plans), valid, plans)
        multi_scale["conv1"] = ((feats, coords, valid), grid)
        feats, coords, lin, valid, grid, plans = self.conv2_down(feats, coords, lin)
        telemetry["conv2_down"] = (torch.stack([p.n_resid for p in plans]),
                                   self.win_resid_budget)
        return feats, coords, lin, valid, grid

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
        if self.engine == "gather":
            return self._gather_forward(feats, coords, valid0, grid, multi_scale)

        x = mask = None
        if self.dfs == 0:
            x, mask = self._dense_stream(feats, coords, valid0, grid)
            x = self._dense(self.conv_input, x, mask)
            x = self._dense(self.conv1_1, self._dense(self.conv1_0, x, mask), mask)
            multi_scale["conv1"] = (x, grid)
        for k, (name, _, stride, pad, ksz) in enumerate(_STAGES, start=1):
            blocks = (getattr(self, f"{name}_0"), getattr(self, f"{name}_1"))
            if k > self.dfs:
                x, mask = self._dense(getattr(self, f"{name}_down"), x, mask)
                grid = conv_out_grid(grid, stride, pad, ksz)
            else:
                if k == 1:
                    feats, coords, lin, valid, grid = self._window_stages(
                        feats, coords, grid, telemetry, multi_scale)
                else:
                    feats, coords, lin, valid, grid, plans = getattr(self, f"{name}_down")(
                        feats, coords, lin)
                    telemetry[f"{name}_down"] = (torch.stack([p.n_resid for p in plans]),
                                                 self.win_resid_budget)
                if k == self.dfs:
                    x, mask = self._dense_stream(feats, coords, valid, grid)
            if x is None:
                plans = self._subm_plans(k, lin, coords, grid, telemetry, name)
                feats = blocks[1](blocks[0](feats, valid, plans), valid, plans)
                multi_scale[name] = ((feats, coords, valid), grid)
            else:
                x = self._dense(blocks[1], self._dense(blocks[0], x, mask), mask)
                multi_scale[name] = (x, grid)
        x, mask = self._dense(self.extra_conv, x, mask)
        return dense_to_bev(x), multi_scale, telemetry

    def _gather_forward(self, feats, coords, valid, grid, multi_scale):
        """Sparse stages as gather-GEMM convs, each stage's subm convs through
        one neighbour table; densified after the strided conv of stage
        ``dense_from_stage``."""
        x = mask = None
        if self.dfs <= 0:
            x, mask = self._dense_stream(feats, coords, valid, grid)
            x = self._dense(self.conv_input, x, mask)
            x = self._dense(self.conv1_1, self._dense(self.conv1_0, x, mask), mask)
            multi_scale["conv1"] = (x, grid)
        else:
            nbr = _subm_table(coords, valid, grid)
            feats = self.conv_input(feats, valid, nbr)
            feats = self.conv1_1(self.conv1_0(feats, valid, nbr), valid, nbr)
            multi_scale["conv1"] = ((feats, coords, valid), grid)
        for k, (name, _, stride, pad, ksz) in enumerate(_STAGES, start=1):
            blocks = (getattr(self, f"{name}_0"), getattr(self, f"{name}_1"))
            if x is None:
                feats, coords, valid, grid = getattr(self, f"{name}_down")(feats, coords, valid)
                if k == self.dfs:
                    x, mask = self._dense_stream(feats, coords, valid, grid)
            else:
                x, mask = self._dense(getattr(self, f"{name}_down"), x, mask)
                grid = conv_out_grid(grid, stride, pad, ksz)
            if x is None:
                nbr = _subm_table(coords, valid, grid)
                feats = blocks[1](blocks[0](feats, valid, nbr), valid, nbr)
                multi_scale[name] = ((feats, coords, valid), grid)
            else:
                x = self._dense(blocks[1], self._dense(blocks[0], x, mask), mask)
                multi_scale[name] = (x, grid)
        if self.dfs > 4:
            feats, coords, valid, g4 = self.extra_conv(feats, coords, valid)
            return sparse_to_bev(feats, coords, valid, g4), multi_scale, {}
        if x is None:
            x, mask = self._dense_stream(feats, coords, valid, grid)
        x, _ = self._dense(self.extra_conv, x, mask)
        return dense_to_bev(x), multi_scale, {}

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
        feats, coords, _, valid, grid = self._window_stages(feats, coords, grid, telemetry,
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
            if self.training:  # the train-mode blocks' backward reads the neighbour table
                plan = plan._replace(nbr=PK.flat_neighbor_ranks(sets, t1p))
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
        """Subm convs of stage k on tile state (tz, B * T1p, 16C). The fused
        inference backend ("pallas", not training) plans with the stage's
        windows; otherwise the plan's window is the whole state, so it
        misses no target (``tilek_miss`` is 0), as the reference's XLA tile
        path reads every tap."""
        t1p = TKK.t1p_of(self.tile_budgets[k])
        windowed = self.tile_backend == "pallas" and not self.training
        plan = TKK.make_block_plan_batched(sets, t1p,
                                           *(self.tile_wins[k] if windowed else (t1p, t1p)))
        counts["tilek_miss"] += plan.n_miss
        for mod in modules:
            state = mod(state, mask, plan)
        return state

    def _tile_down(self, down, *args):
        """``down(*args)``, a strided conv in the chunk-planes layout; in
        training rematerialised: its patches (conv2_down's hold ~80 million
        cells of the flagship frame) are gathered again in the backward, not
        kept."""
        if self.training and torch.is_grad_enabled():
            return remat(down, *args, name=type(down).__name__)
        return down(*args)

    def _tile_forward(self, feats, coords, grid, telemetry, multi_scale):
        """Stages before ``dense_from_stage`` on z-chunked tiles: fused subm
        convs on tile state over the batch flattened to (B * T1p) tile rows,
        strided convs (and, past stage 4, ``extra_conv``) in the
        chunk-planes layout; densify at the transition (at 0, the conv1
        tiles). The dense modules run rematerialised in training, as the
        window engine's."""
        out_dtype = feats.dtype
        feats = feats.to(self.cd or feats.dtype)
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
        x = dmask = None
        if dfs <= 0:
            # the dense conv1 stage sees the input's true channels, so that
            # conv_input's weights keep the reference's shape
            p, mk = to_planes(*TKK.build_state_batched(feats, coords, sets, grid, 4, 4, tzs[0],
                                                       TKK.t1p_of(tbud[0])), 0)
            x, dmask = densify_tiles(p, mk, sets, grid, tzs[0])
            x = self._dense(self.conv_input, x, dmask)
            x = self._dense(self.conv1_1, self._dense(self.conv1_0, x, dmask), dmask)
            multi_scale["conv1"] = (x, grid)
        else:
            if feats.shape[-1] < 16:  # the state's channels are padded to 16
                feats = F.pad(feats, (0, 16 - feats.shape[-1]))
            state, mask = TKK.build_state_batched(feats, coords, sets, grid, 4, 4, tzs[0],
                                                  TKK.t1p_of(tbud[0]))
            state = self._tile_stage(0, state, mask, sets, counts,
                                     (self.conv_input, self.conv1_0, self.conv1_1))
            p, mk = to_planes(state, mask, 0)
            multi_scale["conv1"] = ((p, mk, sets), grid)

        for k, (name, _, stride, pad, ksz) in enumerate(_STAGES, start=1):
            down = getattr(self, f"{name}_down")
            if k <= dfs:
                p, mk, sets, grid = self._tile_down(down, p, mk, sets, grid)
                counts["down_drop"] += torch.stack([t.n_drop for t in sets])
                if k == dfs:
                    x, dmask = densify_tiles(p, mk, sets, grid, tzs[k])
            else:
                x, dmask = self._dense(down, x, dmask)
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
                x = self._dense(blocks[1], self._dense(blocks[0], x, dmask), dmask)
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
            x, _ = self._dense(self.extra_conv, x, dmask)
        return dense_to_bev(x.to(out_dtype)), multi_scale, telemetry


_FHD_STAGES = [  # (subm stage, its strided conv, channels, stride, padding, ksize)
    ("subm1", "down1", (32, 32), (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("subm2", "down2", (64, 64, 64), (2, 2, 2), (1, 1, 1), (3, 3, 3)),
    ("subm3", "down3", (64, 64, 64), (2, 2, 2), (0, 1, 1), (3, 3, 3)),
]


class SpMiddleFHD(_DenseStages):
    """SECOND's non-residual sparse backbone, gather or window engine.

    forward(voxel_features (B, V, C), coords (B, V, 3) zyx)
      -> (bev NHWC (B, H/8, W/8, 64*2), conv4, telemetry)
    where conv4 is the last subm stage's output with its grid, ((features,
    coords, valid), grid) while it is sparse, else (dense NCDHW, grid); and
    telemetry, on the window engine, maps each sparse subm stage ("subm0",
    "subm1": its subm plans) and strided conv ("down1", "down2": its strided
    plans) to their residual rows a sample and their
    budget. The result is exact while every count is within its budget.

    ``engine="gather"`` (the reference's default) runs the stages before
    ``dense_from_stage`` (any; past 4 also ``extra_conv``) as gather-GEMM
    convs, ``engine="window"`` as windowed convs (the window pass, the
    hand-written CUDA kernel on the card); ``dense_from_stage`` 1 (the
    shipped setting) runs subm0 and down1 sparse, 2 also subm1 and down2, 0
    every stage dense. The
    later stages are masked dense 3D convs, rematerialised in training
    unless ``remat_dense`` is False. The parameters do not depend on the
    engine, so one checkpoint serves both.
    """

    out_channels = 64

    def __init__(self, num_input_features: int = 128,
                 sparse_shape: Tuple[int, int, int] = (41, 1504, 1504),
                 stage_budgets: Optional[Tuple[int, int, int, int]] = None,
                 dense_from_stage: Optional[int] = 2, engine: str = "gather",
                 win_window=384, win_resid_budget: int = 16384,
                 dense_compute_dtype: Optional[str] = None, remat_dense: bool = True):
        dfs = 99 if dense_from_stage is None else dense_from_stage
        if engine not in ("gather", "window"):
            raise NotImplementedError(
                f"engine={engine!r}: SpMiddleFHD runs engine='gather' and 'window' in this port")
        if engine == "window" and dfs not in (0, 1, 2):
            raise NotImplementedError(
                f"dense_from_stage={dense_from_stage}: sparse stages past down2 need the window "
                "kernel at 64->64 channels (weights streamed through shared memory), a later "
                "slice")
        super().__init__(remat_dense, dense_compute_dtype)
        self.engine, self.dfs = engine, dfs
        self.sparse_shape = tuple(sparse_shape)
        self.wins = _win_windows(win_window)
        self.win_resid_budget = win_resid_budget
        cd = dense_compute_dtype
        stage = SubMStage if engine == "gather" else WinSubMStage
        self.subm0 = (stage(num_input_features, (16, 16)) if dfs > 0 else
                      DenseSubMStage(num_input_features, (16, 16), compute_dtype=cd))
        cin, grid = 16, self.sparse_shape
        for k, (name, down, chans, stride, pad, ksz) in enumerate(_FHD_STAGES, start=1):
            budget = stage_budgets[k - 1] if stage_budgets else None
            if k > dfs:
                mod = DenseDownsample(cin, chans[0], stride, pad, ksz, compute_dtype=cd)
            elif engine == "gather":
                mod = SparseDownsample(cin, chans[0], grid, stride, pad, ksz, out_budget=budget)
            else:
                mod = WinDownsample(cin, chans[0], grid, stride, pad, ksz, out_budget=budget,
                                    window=self.wins[k], resid_budget=win_resid_budget)
            setattr(self, down, mod)
            setattr(self, name, stage(chans[0], chans) if k < dfs else
                    DenseSubMStage(chans[0], chans, compute_dtype=cd))
            cin, grid = chans[-1], conv_out_grid(grid, stride, pad, ksz)
        if dfs > 4:
            self.extra_conv = SparseDownsample(
                64, 64, grid, (2, 1, 1), (0, 0, 0), (3, 1, 1),
                out_budget=stage_budgets[3] if stage_budgets else None)
        else:
            self.extra_conv = DenseDownsample(64, 64, (2, 1, 1), (0, 0, 0), (3, 1, 1),
                                              compute_dtype=cd)

    def forward(self, voxel_features, coords):
        coords = coords.to(torch.int32)
        valid = (coords >= 0).all(-1)
        feats = voxel_features * valid[..., None].to(voxel_features.dtype)
        grid = self.sparse_shape
        telemetry: Dict[str, Tuple[torch.Tensor, int]] = {}
        window = self.engine == "window"
        lin = x = mask = None
        if self.dfs <= 0:
            x, mask = self._dense_stream(feats, coords, valid, grid)
            x = self._dense(self.subm0, x, mask)
            conv4 = (x, grid)
        else:
            if window:
                rows = [WC.sort_rows(f, c, grid) for f, c in zip(feats, coords)]
                feats, coords, lin = (torch.stack(t) for t in zip(*rows))
                valid = lin < WC.MISS
                tables = self._subm_plans(0, lin, coords, grid, telemetry, "subm0")
            else:
                tables = _subm_table(coords, valid, grid)
            feats = self.subm0(feats, valid, tables)
            conv4 = ((feats, coords, valid), grid)
        for k, (name, down, _, stride, pad, ksz) in enumerate(_FHD_STAGES, start=1):
            if x is None:
                if window:
                    feats, coords, lin, valid, grid, plans = getattr(self, down)(feats, coords,
                                                                                 lin)
                    telemetry[down] = (torch.stack([p.n_resid for p in plans]),
                                       self.win_resid_budget)
                else:
                    feats, coords, valid, grid = getattr(self, down)(feats, coords, valid)
                if k == self.dfs:
                    x, mask = self._dense_stream(feats, coords, valid, grid)
            else:
                x, mask = self._dense(getattr(self, down), x, mask)
                grid = conv_out_grid(grid, stride, pad, ksz)
            if x is None:
                tables = (self._subm_plans(k, lin, coords, grid, telemetry, name) if window
                          else _subm_table(coords, valid, grid))
                feats = getattr(self, name)(feats, valid, tables)
                conv4 = ((feats, coords, valid), grid)
            else:
                x = self._dense(getattr(self, name), x, mask)
                conv4 = (x, grid)
        if self.dfs > 4:
            feats, coords, valid, g4 = self.extra_conv(feats, coords, valid)
            return sparse_to_bev(feats, coords, valid, g4), conv4, telemetry
        if x is None:
            x, mask = self._dense_stream(feats, coords, valid, grid)
        x, _ = self._dense(self.extra_conv, x, mask)
        return dense_to_bev(x), conv4, telemetry


def _win_windows(win) -> Tuple[int, int, int, int]:
    """The window engine's plan windows of the four stages from an int or a
    4-tuple."""
    if isinstance(win, (tuple, list)):
        if len(win) != 4:
            raise ValueError(f"expected an int or 4 per-stage windows, got {win!r}")
        return tuple(int(w) for w in win)
    return (int(win),) * 4


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
