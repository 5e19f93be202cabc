"""The masked SyncBN (``models/norm.py`` under ``parallel/dist.py``) at two
gloo ranks on the CPU against one process on the joined input: outputs,
input gradients, the parameters' gradients summed over the ranks, and the
running statistics (the batch statistics' update) agree within 1e-6 of
each quantity's largest |value| (float32 sums in other orders). Cases:
an NCHW map without a mask; a masked (B, V, C) input under remat (the
recompute runs the collective again and leaves the running statistics
alone); a rank whose mask is empty (it still takes part); the pillar net's
mask of one value a pillar over (B, V, P, C) (the count is the pillars')."""
import pytest
import torch

from sparse2dense_tpu_torch.parallel.launch import spawn
from tests.torch_dist_workers import CASES, syncbn_case, syncbn_worker


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("syncbn")
    spawn(syncbn_worker, 2, (str(out),), threads=1, timeout=300)
    return [torch.load(out / f"syncbn_rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_syncbn_two_ranks_equal_one_process(ranks, name):
    want = syncbn_case(name)
    for r, got in enumerate(g[name] for g in ranks):
        for key, w in want.items():
            w = w[r:r + 1] if key in ("y", "x_grad") else w
            torch.testing.assert_close(got[key], w, rtol=0, atol=1e-6 * float(w.abs().max()),
                                       msg=f"rank {r} {key}")
    # one update of the running statistics, from the global batch
    assert not torch.equal(want["running_mean"], torch.zeros_like(want["running_mean"]))
