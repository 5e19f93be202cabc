"""Starting data parallelism (``parallel/dist.py``, ``parallel/launch.py``,
``tools/dryrun.py``) on the CPU: ``--launcher none`` starts no process
group and its collectives are the identity; ``--launcher pytorch`` without
torchrun's environment, or with a process group that cannot start, raises
(no quiet single-process run); a spawned rank's error reaches the caller;
the dry run (the counterpart of ``__graft_entry__.dryrun_multichip``) trains
``pp_tiny`` through the CLI and takes a distillation step at two ranks."""
import pytest
import torch

from sparse2dense_tpu_torch.parallel import dist
from sparse2dense_tpu_torch.parallel.launch import spawn
from sparse2dense_tpu_torch.tools import dryrun


def test_launcher_none_runs_no_collective():
    assert dist.init_distributed("none") == (0, 1)
    assert not dist.is_distributed()
    assert (dist.world_size(), dist.rank(), dist.is_main()) == (1, 0, True)
    x = torch.randn(3, requires_grad=True)
    assert dist.all_reduce_sum(x) is x and dist.global_sum(x) is x
    metrics = {"loss": torch.tensor(2.0), "grad_norm": torch.tensor(3.0)}
    assert dist.reduce_metrics(metrics) is metrics
    dist.barrier()
    p = torch.nn.Parameter(torch.ones(2))
    dist.reduce_gradients([p])
    assert p.grad is None


def test_launcher_pytorch_raises_without_its_environment_or_group(monkeypatch):
    for key in dist.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                                           "MASTER_PORT not set"):
        dist.init_distributed("pytorch", "cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="MASTER_PORT not set"):
        dist.init_distributed("pytorch", "cpu")
    monkeypatch.setenv("MASTER_PORT", "no-port")
    with pytest.raises(RuntimeError, match="gloo process group did not start"):
        dist.init_distributed("pytorch", "cpu")
    assert not dist.is_distributed()
    with pytest.raises(ValueError, match="'none' or 'pytorch'"):
        dist.init_distributed("slurm")


def _failing_rank():
    if dist.init_distributed("pytorch", "cpu")[0] == 1:
        raise ValueError("rank 1 failed on purpose")
    dist.barrier()


def test_spawn_raises_a_ranks_error():
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        spawn(_failing_rank, 2, threads=1, timeout=120)


def test_dryrun_two_processes(tmp_path, capfd):
    dryrun.main(["2", "--device", "cpu", "--work_dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "dryrun(2) on cpu: train CLI 2 steps a rank" in out
    assert "parameters equal across ranks" in out
    assert sorted((tmp_path / "train").iterdir())[0].name == "epoch_1"
