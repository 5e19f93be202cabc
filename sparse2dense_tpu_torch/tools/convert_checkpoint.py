"""det3d checkpoint -> this port's checkpoint (counterpart of
``sparse2dense_tpu/tools/convert_checkpoint.py``).

    python -m sparse2dense_tpu_torch.tools.convert_checkpoint <config.py>
        <det3d.pth> <out_dir> [--model_key S_model]

Maps a reference det3d ``state_dict`` (CenterPoint / Sparse2Dense ``.pth``)
onto the port's model of ``cfg[model_key]`` in one step: the JAX package's
key rules and layout transforms (det3d key -> Flax path, torch layout ->
Flax layout; copied here as they are) composed with ``convert.port_key``
and ``convert.port_tensor`` (Flax path -> port key, Flax layout -> port
layout). The result equals the JAX converter followed by
``convert.from_flax``, to the bit. A ``TwoStageDetector`` config maps its
first stage's keys, with or without det3d's ``single_det.`` prefix, onto
``single_det``; the RoI head's keys have no rule. Unmatched keys and
entries that do not fit the model are logged, not fatal (the reference's
``strict=False``). The output is a checkpoint of the port's own format
(``training/checkpoint.save_checkpoint``: ``<out_dir>/converted``, meta
``{"source": <pth>}``), which ``tools/train.py --load_from`` and
``tools/test.py --checkpoint`` read.

Layout transforms (det3d -> Flax):
- Conv2d  (out,in,kh,kw)        -> (kh,kw,in,out)
- Conv3d  (out,in,kd,kh,kw)     -> (kd,kh,kw,in,out)
- ConvTranspose2d (in,out,kh,kw)-> (kh,kw,in,out), spatially flipped
- Linear  (out,in)              -> (in,out)
- spconv  (kz,ky,kx,in,out)     -> (kz*ky*kx,in,out), taps z-major
- BatchNorm weight/bias -> params scale/bias; running_mean/var -> batch_stats

Name rules cover VoxelFeatureExtractorV3 (no parameters), PillarFeatureNet,
PointPillarsScatter, SpMiddleResNetFHD, RPN (and S2D_RPN's RPN trunk),
CenterHead and MultiGroupHead, as the JAX converter's.
"""
from __future__ import annotations

import argparse
import logging
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import port_key, port_tensor


def t_conv2d(w):
    return np.transpose(w, (2, 3, 1, 0))


def t_conv3d(w):
    return np.transpose(w, (2, 3, 4, 1, 0))


def t_convt2d(w):
    # torch ConvTranspose2d is the conv gradient; flax ConvTranspose
    # (transpose_kernel=False) convolves the dilated input with the kernel
    # as-is, so the torch kernel is spatially FLIPPED besides the
    # (in,out,kh,kw) -> (kh,kw,in,out) transpose
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def t_linear(w):
    return np.transpose(w, (1, 0))


def t_spconv(w):
    # (kz,ky,kx,in,out) -> (K,in,out); 1x1x1 and (3,1,1) kernels flatten the same way
    return np.reshape(w, (-1, w.shape[-2], w.shape[-1]))


def t_id(w):
    return w


def _bn_rules(torch_prefix, flax_path):
    """BN weight/bias/running stats for one norm layer."""
    return [
        (rf"^{torch_prefix}\.weight$", ("params",) + flax_path + ("scale",), t_id),
        (rf"^{torch_prefix}\.bias$", ("params",) + flax_path + ("bias",), t_id),
        (rf"^{torch_prefix}\.running_mean$",
         ("batch_stats",) + flax_path + ("mean",), t_id),
        (rf"^{torch_prefix}\.running_var$",
         ("batch_stats",) + flax_path + ("var",), t_id),
    ]


def rules_for_model(model_cfg: dict, module_prefix: str = ""):
    """(regex, flax_path_template, transform) rules for a detector cfg; the
    paths' ``{N}`` are filled from the regex groups. A copy of the JAX
    converter's."""
    rules = []
    p = module_prefix

    def add(pat, path, tf=t_id):
        rules.append((re.compile("^" + p + pat + "$"), path, tf))

    def add_bn(torch_prefix, flax_path):
        for n in _bn_rules(torch_prefix, flax_path):
            rules.append((re.compile(n[0].replace("^", "^" + p)), n[1], n[2]))

    reader = model_cfg.get("reader", {}).get("type")
    if reader == "PillarFeatureNet":
        add(r"reader\.pfn_layers\.(\d+)\.linear\.weight",
            ("params", "reader", "pfn_{0}", "linear", "kernel"), t_linear)
        add(r"reader\.pfn_layers\.(\d+)\.norm\.weight",
            ("params", "reader", "pfn_{0}", "norm", "scale"))
        add(r"reader\.pfn_layers\.(\d+)\.norm\.bias",
            ("params", "reader", "pfn_{0}", "norm", "bias"))
        add(r"reader\.pfn_layers\.(\d+)\.norm\.running_mean",
            ("batch_stats", "reader", "pfn_{0}", "norm", "mean"))
        add(r"reader\.pfn_layers\.(\d+)\.norm\.running_var",
            ("batch_stats", "reader", "pfn_{0}", "norm", "var"))

    backbone = model_cfg.get("backbone", {}).get("type")
    if backbone == "SpMiddleResNetFHD":
        add(r"backbone\.conv_input\.0\.weight",
            ("params", "backbone", "conv_input", "conv_0_kernel"), t_spconv)
        add_bn("backbone\\.conv_input\\.1", ("backbone", "conv_input", "norm_0"))
        # residual stages: torch conv{s}.{b} blocks; strided head inside conv2..4
        for s, ours_down, ours_blocks, blk_base in (
            (1, None, ("conv1_0", "conv1_1"), 0),
            (2, "conv2_down", ("conv2_0", "conv2_1"), 3),
            (3, "conv3_down", ("conv3_0", "conv3_1"), 3),
            (4, "conv4_down", ("conv4_0", "conv4_1"), 3),
        ):
            if ours_down:
                add(rf"backbone\.conv{s}\.0\.weight",
                    ("params", "backbone", ours_down, "conv_kernel"), t_spconv)
                add_bn(rf"backbone\.conv{s}\.1", ("backbone", ours_down, "norm"))
            for bi, ours in enumerate(ours_blocks):
                tb = blk_base + bi
                for cv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                    add(rf"backbone\.conv{s}\.{tb}\.{cv}\.weight",
                        ("params", "backbone", ours, f"{cv}_kernel"), t_spconv)
                    add(rf"backbone\.conv{s}\.{tb}\.{cv}\.bias",
                        ("params", "backbone", ours, f"{cv}_bias"))
                    add_bn(rf"backbone\.conv{s}\.{tb}\.{bn}", ("backbone", ours, bn))
        add(r"backbone\.extra_conv\.0\.weight",
            ("params", "backbone", "extra_conv", "conv_kernel"), t_spconv)
        add_bn("backbone\\.extra_conv\\.1", ("backbone", "extra_conv", "norm"))

    neck = model_cfg.get("neck", {}).get("type")
    if neck in ("RPN", "S2D_RPN"):
        layer_nums = model_cfg["neck"]["layer_nums"]
        # blocks.{i}: [ZeroPad, Conv, BN, ReLU, (Conv, BN, ReLU?)*layer_num]
        add(r"neck\.blocks\.(\d+)\.1\.weight",
            ("params", "neck", "block_{0}", "down", "conv", "kernel"), t_conv2d)
        add_bn(r"neck\.blocks\.(\d+)\.2", ("neck", "block_{0}", "down", "norm"))
        for i, ln in enumerate(layer_nums):
            for j in range(ln):
                ci, bi_ = 4 + 3 * j, 5 + 3 * j
                add(rf"neck\.blocks\.{i}\.{ci}\.weight",
                    ("params", "neck", f"block_{i}", f"conv_{j}", "conv", "kernel"),
                    t_conv2d)
                add_bn(rf"neck\.blocks\.{i}\.{bi_}",
                       ("neck", f"block_{i}", f"conv_{j}", "norm"))
        us = model_cfg["neck"].get("us_layer_strides", [])
        for k, stride in enumerate(us):
            tf = t_convt2d if stride > 1 else t_conv2d
            add(rf"neck\.deblocks\.{k}\.0\.weight",
                ("params", "neck", f"deblock_{k}", "up", "conv", "kernel"), tf)
            add_bn(rf"neck\.deblocks\.{k}\.1", ("neck", f"deblock_{k}", "up", "norm"))

    head = model_cfg.get("bbox_head", {}).get("type")
    if head == "CenterHead":
        add(r"bbox_head\.shared_conv\.0\.weight",
            ("params", "bbox_head", "shared_conv", "kernel"), t_conv2d)
        add(r"bbox_head\.shared_conv\.0\.bias",
            ("params", "bbox_head", "shared_conv", "bias"))
        add_bn(r"bbox_head\.shared_conv\.1", ("bbox_head", "shared_bn"))
        # SepHead sequentials: [Conv, BN, ReLU]*(num_conv-1) + Conv
        heads = dict(model_cfg["bbox_head"].get("common_heads", {}))
        heads["hm"] = (0, model_cfg["bbox_head"].get("num_hm_conv", 2))
        for hname, (_, num_conv) in heads.items():
            for j in range(num_conv - 1):
                ci, bi_ = 3 * j, 3 * j + 1
                add(rf"bbox_head\.tasks\.(\d+)\.{hname}\.{ci}\.weight",
                    ("params", "bbox_head", "task_{0}", f"{hname}_conv_{j}", "kernel"),
                    t_conv2d)
                add(rf"bbox_head\.tasks\.(\d+)\.{hname}\.{ci}\.bias",
                    ("params", "bbox_head", "task_{0}", f"{hname}_conv_{j}", "bias"))
                add_bn(rf"bbox_head\.tasks\.(\d+)\.{hname}\.{bi_}",
                       ("bbox_head", "task_{0}", f"{hname}_bn_{j}"))
            last = 3 * (num_conv - 1)
            add(rf"bbox_head\.tasks\.(\d+)\.{hname}\.{last}\.weight",
                ("params", "bbox_head", "task_{0}", f"{hname}_out", "kernel"), t_conv2d)
            add(rf"bbox_head\.tasks\.(\d+)\.{hname}\.{last}\.bias",
                ("params", "bbox_head", "task_{0}", f"{hname}_out", "bias"))
    elif head == "MultiGroupHead":
        for part in ("conv_box", "conv_cls", "conv_dir"):
            add(rf"bbox_head\.tasks\.(\d+)\.{part}\.weight",
                ("params", "bbox_head", "task_{0}_" + part, "kernel"), t_conv2d)
            add(rf"bbox_head\.tasks\.(\d+)\.{part}\.bias",
                ("params", "bbox_head", "task_{0}_" + part, "bias"))
    return rules


def rules_for_detector(model_cfg: dict):
    """:func:`rules_for_model`; for a ``TwoStageDetector``, its first
    stage's rules with det3d's ``single_det.`` prefix optional, onto the
    Flax paths under ``single_det``."""
    model_cfg = dict(model_cfg)
    if model_cfg.get("type") != "TwoStageDetector":
        return rules_for_model(model_cfg)
    return [(pat, (path[0], "single_det") + tuple(path[1:]), tf) for pat, path, tf in
            rules_for_model(dict(model_cfg["first_stage_cfg"]), r"(?:single_det\.)?")]


def _flax_items(state_dict: Dict[str, np.ndarray], rules):
    """(det3d key, Flax path or None, Flax-layout array) for each entry."""
    for key, val in state_dict.items():
        key = key.removeprefix("module.")
        val = np.asarray(val)
        for pat, path_tpl, tf in rules:
            m = pat.match(key)
            if m:
                yield key, tuple(seg.format(*m.groups()) if "{" in seg else seg
                                 for seg in path_tpl), tf(val)
                break
        else:
            yield key, None, None


def flax_shape(path, like: torch.Tensor, module) -> Tuple[int, ...]:
    """The Flax shape of the leaf at ``path`` whose port counterpart is
    ``like`` (the inverse of ``convert.port_tensor``'s layout)."""
    shape = tuple(like.shape)
    if path[-1].endswith("_kernel"):
        return (int(np.prod(shape[2:])), shape[1], shape[0])
    if path[-1] == "kernel":
        transposed = isinstance(module, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d))
        return shape[2:] + (shape[:2] if transposed else (shape[1], shape[0]))
    return shape


def convert_state_dict(state_dict: Dict[str, np.ndarray], model_cfg: dict,
                       model: torch.nn.Module, logger: Optional[logging.Logger] = None):
    """det3d ``state_dict`` -> (the port model's ``state_dict`` with every
    matched entry replaced, the det3d keys no rule matched, the Flax paths
    (``keystr``-style) that fit no entry of the model). Equals the JAX
    converter's ``convert_state_dict`` + ``apply_to_variables`` followed by
    ``from_flax``."""
    target = model.state_dict()
    modules = dict(model.named_modules())
    out = dict(target)
    unmatched, skipped, applied = [], [], 0
    for key, path, arr in _flax_items(state_dict, rules_for_detector(model_cfg)):
        if path is None:
            if not key.endswith("num_batches_tracked"):
                unmatched.append(key)
            continue
        coll, fpath = path[0], path[1:]
        name = port_key(coll, fpath)
        module = modules.get(".".join(fpath[:-1]))
        if name not in target or np.shape(arr) != flax_shape(fpath, target[name], module):
            skipped.append("".join(f"['{s}']" for s in path))
            continue
        out[name] = port_tensor(fpath, np.asarray(arr, np.float32), target[name], module)
        applied += 1
    if logger:
        logger.info(f"converter: applied {applied}, skipped {len(skipped)}")
    return out, unmatched, skipped


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Convert a det3d .pth to a port checkpoint")
    p.add_argument("config")
    p.add_argument("torch_ckpt")
    p.add_argument("out_dir")
    p.add_argument("--model_key", default="S_model")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Convert as the command line says; returns the checkpoint's path.
    The model is built on the CPU (only its names and shapes are read).
    det3d checkpoints pickle their meta beside the weights, so the file is
    unpickled in full: convert only checkpoints you trust."""
    args = parse_args(argv)
    from ..models import build_detector
    from ..training.checkpoint import save_checkpoint
    from ..utils.config import ConfigDict

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("convert")
    cfg = ConfigDict.fromfile(args.config)
    model_cfg = cfg[args.model_key]
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    state_dict = {k: v.numpy() for k, v in state_dict.items() if torch.is_tensor(v)}
    model = build_detector(model_cfg, test_cfg=cfg.get("test_cfg"),
                           voxel_generator=cfg.get("voxel_generator"), device="cpu")
    state, unmatched, _ = convert_state_dict(state_dict, model_cfg, model, logger)
    if unmatched:
        logger.warning(f"{len(unmatched)} torch keys unmatched, e.g. {unmatched[:5]}")
    path = save_checkpoint(args.out_dir, "converted", {"model": state},
                           meta={"source": args.torch_ckpt})
    logger.info(f"saved converted checkpoint to {path}")
    return path


if __name__ == "__main__":
    main()
