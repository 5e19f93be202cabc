"""Process bodies the data-parallel tests spawn (no JAX here: a spawned
process imports this module, not the test that spawned it).

``syncbn_worker``: the masked SyncBN of ``models/norm.py`` on this rank's
slice of each case's joined input, its outputs, input and parameter
gradients (the parameters' summed over the ranks) and running statistics
written to ``<out_dir>/syncbn_rank<r>.pt``. :func:`syncbn_case` runs a case
in one process on the joined input, or in a rank on its slice.

``save_worker``: ``Trainer.save_checkpoint`` of a small model in each rank,
each rank into a directory of its own; after the call (and its barrier) a
rank records what its directory and rank 0's hold.
"""
import os

import numpy as np
import torch

from sparse2dense_tpu_torch.models.norm import BatchNorm
from sparse2dense_tpu_torch.models.remat import remat
from sparse2dense_tpu_torch.parallel import dist

# name -> (input shape, channel dim, mask: None, "random", "empty on rank 1"
# or "pillar" (one value a pillar, the pillar net's count), under remat)
CASES = {
    "nchw": ((2, 5, 6, 7), 1, None, False),
    "masked_remat": ((2, 40, 6), -1, "random", True),
    "empty_rank": ((2, 40, 6), -1, "empty", False),
    "pillar_count": ((2, 12, 4, 6), -1, "pillar", False),
}


def case_inputs(name):
    """(x, mask, output weights, BN weight, BN bias) of a case, seeded."""
    shape, cdim, kind, _ = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 0.5)
    mask_shape = list(shape)
    mask_shape[cdim] = 1
    mask = None
    if kind == "pillar":
        mask = torch.from_numpy((rng.rand(shape[0], shape[1], 1, 1) < 0.7).astype(np.float32))
    elif kind is not None:
        mask = torch.from_numpy((rng.rand(*mask_shape) < 0.6).astype(np.float32))
        if kind == "empty":
            mask[1] = 0
    w_out = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    c = shape[cdim]
    weight = torch.from_numpy(1 + 0.1 * rng.randn(c).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
    return x, mask, w_out, weight, bias


def syncbn_case(name, rows=slice(None)):
    """The case on samples ``rows``: {"y", "x_grad", "weight_grad",
    "bias_grad", "running_mean", "running_var"}."""
    _, cdim, _, under_remat = CASES[name]
    x, mask, w_out, weight, bias = case_inputs(name)
    bn = BatchNorm(weight.numel(), channel_dim=cdim)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.train()
    x = x[rows].clone().requires_grad_(True)
    m = None if mask is None else mask[rows]
    y = remat(bn, x, m, name="syncbn test") if under_remat else bn(x, m)
    (y * w_out[rows]).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                bias_grad=bn.bias.grad, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone())


def syncbn_worker(out_dir):
    rank, _ = dist.init_distributed("pytorch", "cpu")
    out = {}
    for name in CASES:
        got = syncbn_case(name, slice(rank, rank + 1))
        for k in ("weight_grad", "bias_grad"):   # the parameters' gradients add over ranks
            got[k] = dist.global_sum(got[k])
        out[name] = got
    torch.save(out, os.path.join(out_dir, f"syncbn_rank{rank}.pt"))
    dist.close_distributed()


def save_worker(out_dir):
    from sparse2dense_tpu_torch.training.trainer import Trainer

    rank, _ = dist.init_distributed("pytorch", "cpu")
    model = torch.nn.Linear(3, 2)
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1))
    mine, main = (os.path.join(out_dir, f"rank{r}") for r in (rank, 0))
    os.makedirs(mine, exist_ok=True)
    path = trainer.save_checkpoint(mine)
    torch.save(dict(path=path, mine=sorted(os.listdir(mine)), main=sorted(os.listdir(main))),
               os.path.join(out_dir, f"save_rank{rank}.pt"))
    dist.close_distributed()
