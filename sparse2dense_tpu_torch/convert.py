"""Flax variables of the reference -> this port's ``state_dict``.

The port's modules carry the reference's names, so a Flax path maps to a
torch key by renaming the leaf; the layouts change as follows
(``sparse2dense_tpu/tools/convert_checkpoint.py:10-48`` holds the inverse):

- ``nn.Conv`` kernel HWIO -> OIHW (depthwise (7, 7, 1, C) -> (C, 1, 7, 7));
- ``nn.ConvTranspose`` kernel (kh, kw, in, out) -> (in, out, kh, kw) AND
  spatially flipped: Flax convolves the dilated input with the kernel as it
  is, torch's ConvTranspose2d is the conv gradient (this covers the k=s=2
  VALID deblocks and the k4/s2 SAME decoders, torch padding 1);
- 3D ``nn.Conv`` and ``nn.ConvTranspose`` kernels (the PCR generators) by
  the same rules with three spatial axes, all three flipped for a
  transposed conv (Flax flips none, in z neither);
- sparse and dense 3D kernels (K, Cin, Cout), taps z-major (kz, ky, kx) ->
  Conv3d (Cout, Cin, kz, ky, kx);
- BatchNorm / LayerNorm scale -> weight; batch_stats mean / var ->
  running_mean / running_var;
- ``nn.Dense`` kernel (in, out) -> Linear weight (out, in).

:func:`port_key` and :func:`port_tensor` map one leaf;
``tools/convert_checkpoint.py`` composes them with the det3d rules, and
:func:`from_npz` reads a JAX checkpoint flattened to NumPy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# train-only PCR generator subtrees, by the top module that holds them:
# S2D_RPN's (the neck) and PointPillarsScatter_S2D's (the backbone). The
# reference creates them only in training, so a tree from an eval-mode init
# has none of them
_PCR = {"neck": {"out_conv", "generator_1a", "generator_1b", "generator_2a", "generator_2b",
                 "gen_out_2", "gen_mask_2", "gen_out_4", "gen_mask_4"},
        "backbone": {"generator_a", "generator_b", "gen_out", "gen_mask_a", "gen_mask_b"}}


def is_pcr_key(parts) -> bool:
    """Whether a key's parts name a train-only PCR generator (a two-stage
    detector's first stage, ``single_det``, holds them one level down)."""
    if parts and parts[0] == "single_det":
        parts = parts[1:]
    return len(parts) > 1 and parts[1] in _PCR.get(parts[0], ())


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


_RENAME = {"params": {"scale": "weight", "kernel": "weight"},
           "batch_stats": {"mean": "running_mean", "var": "running_var"}}


def port_key(coll: str, path) -> str:
    """The port's ``state_dict`` key of the Flax leaf ``coll/path``."""
    leaf = path[-1]
    if leaf.endswith("_kernel"):
        leaf = leaf[:-len("_kernel")] + "_weight"
    else:
        leaf = _RENAME[coll].get(leaf, leaf)
    return ".".join(tuple(path[:-1]) + (leaf,))


def port_tensor(path, arr: np.ndarray, like: torch.Tensor, module) -> torch.Tensor:
    """The Flax leaf ``arr`` at ``path`` in the layout of its port
    counterpart ``like`` (held by ``module``)."""
    n = arr.ndim - 2  # spatial axes of a dense kernel
    if path[-1] == "kernel" and isinstance(module, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        arr = np.transpose(np.flip(arr, tuple(range(n))), (n, n + 1) + tuple(range(n)))
    elif path[-1] == "kernel":
        arr = np.transpose(arr, (n + 1, n) + tuple(range(n)))
    elif path[-1].endswith("_kernel"):
        cout, cin = like.shape[:2]
        arr = np.transpose(arr.reshape(like.shape[2:] + (cin, cout)), (4, 3, 0, 1, 2))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)


def from_flax(variables: Dict[str, dict], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``variables``: {"params": ..., "batch_stats": ...} nested dicts of
    arrays. ``model`` is the port's twin, read for the target shapes and for
    which kernels belong to transposed convs. Raises on a Flax leaf with no
    counterpart. The PCR generators (S2D_RPN's, the pillar S2D scatter's)
    that the tree lacks (an eval-mode init, or a two-stage detector's
    frozen first stage) keep the model's own values. A two-stage tree maps
    by the same names: ``single_det/...``, ``roi_head/{shared_fc,
    cls_layers,reg_layers}/{fc_k,bn_k,out}`` (a ``Dense`` kernel (in, out)
    becomes a ``Linear`` weight (out, in)); its BEV extractor has none."""
    target = model.state_dict()
    modules = dict(model.named_modules())
    out = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {})):
            key = port_key(coll, path)
            if key not in target:
                raise KeyError(f"flax {coll}/{'/'.join(path)} has no counterpart {key}")
            t = port_tensor(path, arr, target[key], modules.get(".".join(path[:-1])))
            if t.shape != target[key].shape:
                raise ValueError(f"{key}: converted shape {tuple(t.shape)} != "
                                 f"{tuple(target[key].shape)}")
            out[key] = t
    for key, value in target.items():
        if key not in out and is_pcr_key(key.split(".")):
            out[key] = value
    return out


def from_npz(path: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a JAX-package checkpoint flattened to
    an ``.npz`` whose keys are the Flax tree's ``/``-joined paths (README,
    "JAX checkpoints"), read with NumPy through :func:`from_flax`; entries
    outside "params" and "batch_stats" (the optimizer's, the step) are
    left out."""
    tree: dict = {}
    with np.load(path) as npz:
        for name in npz.files:
            parts = name.split("/")
            if parts[0] not in ("params", "batch_stats"):
                continue
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[name]
    return from_flax(tree, model)
