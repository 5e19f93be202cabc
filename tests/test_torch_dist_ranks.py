"""What each rank of a data-parallel run does on its own: the process
group's backend follows from the devices, alike on every rank (NCCL where
each rank has a card, gloo on the CPU and where ranks share a card), and
``Trainer.save_checkpoint`` writes from rank 0 alone, every rank returning
after the write (two spawned gloo ranks on the CPU)."""
import os

import torch

from sparse2dense_tpu_torch.parallel import dist
from sparse2dense_tpu_torch.parallel.launch import spawn
from tests.torch_dist_workers import save_worker


def test_backend_follows_the_devices(monkeypatch):
    card = torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for world, local, cards, device, want in (
            (2, None, 2, None, "nccl"),      # a card a rank
            (2, None, 2, "cuda", "nccl"),
            (2, 2, 1, None, "gloo"),         # more ranks than cards
            (2, 2, 2, "cuda:0", "gloo"),     # one card named for the group
            (4, 2, 2, None, "nccl"),         # two hosts of two cards
            (1, 1, 1, "cuda:0", "nccl"),     # one rank on the card it names
    ):
        monkeypatch.setenv("WORLD_SIZE", str(world))
        if local is None:
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert dist._backend(card, device) == want, (world, local, cards, device)
    assert dist._backend(torch.device("cpu"), "cpu") == "gloo"


def test_save_checkpoint_writes_on_rank_0_only(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spawn(save_worker, 2, (str(tmp_path),), threads=1, timeout=120)
    finally:
        torch.set_num_threads(threads)
    r0, r1 = (torch.load(tmp_path / f"save_rank{r}.pt") for r in range(2))
    assert r0["mine"] == r0["main"] == ["epoch_1", "latest"]
    assert r1["mine"] == [] and r1["main"] == ["epoch_1", "latest"]   # after the barrier
    assert r0["path"] == os.path.abspath(tmp_path / "rank0" / "epoch_1")
    assert sorted(os.listdir(tmp_path / "rank1")) == []
