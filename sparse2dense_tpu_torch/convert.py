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
  running_mean / running_var.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# train-only PCR generator subtrees of S2D_RPN: the reference creates them
# only in training, so a tree from an eval-mode init has none of them
_PCR = {"out_conv", "generator_1a", "generator_1b", "generator_2a", "generator_2b",
        "gen_out_2", "gen_mask_2", "gen_out_4", "gen_mask_4"}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def from_flax(variables: Dict[str, dict], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``variables``: {"params": ..., "batch_stats": ...} nested dicts of
    arrays. ``model`` is the port's twin, read for the target shapes and for
    which kernels belong to transposed convs. Raises on a Flax leaf with no
    counterpart. S2D_RPN's PCR generators that the tree lacks (an eval-mode
    init) keep the model's own values."""
    target = model.state_dict()
    modules = dict(model.named_modules())
    out = {}
    for coll, rename in (("params", {"scale": "weight", "kernel": "weight"}),
                         ("batch_stats", {"mean": "running_mean", "var": "running_var"})):
        for path, arr in _leaves(variables.get(coll, {})):
            leaf = path[-1]
            if leaf.endswith("_kernel"):
                leaf = leaf[:-len("_kernel")] + "_weight"
            else:
                leaf = rename.get(leaf, leaf)
            key = ".".join(path[:-1] + (leaf,))
            if key not in target:
                raise KeyError(f"flax {coll}/{'/'.join(path)} has no counterpart {key}")
            mod = modules.get(".".join(path[:-1]))
            n = arr.ndim - 2  # spatial axes of a dense kernel
            if path[-1] == "kernel" and isinstance(mod, (nn.ConvTranspose2d,
                                                         nn.ConvTranspose3d)):
                arr = np.transpose(np.flip(arr, tuple(range(n))), (n, n + 1) + tuple(range(n)))
            elif path[-1] == "kernel":
                arr = np.transpose(arr, (n + 1, n) + tuple(range(n)))
            elif path[-1].endswith("_kernel"):
                cout, cin = target[key].shape[:2]
                arr = np.transpose(arr.reshape(target[key].shape[2:] + (cin, cout)),
                                   (4, 3, 0, 1, 2))
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(target[key].dtype)
            if t.shape != target[key].shape:
                raise ValueError(f"{key}: converted shape {tuple(t.shape)} != "
                                 f"{tuple(target[key].shape)}")
            out[key] = t
    for key, value in target.items():
        parts = key.split(".")
        if key not in out and parts[0] == "neck" and parts[1] in _PCR:
            out[key] = value
    return out
