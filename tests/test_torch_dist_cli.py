"""The CLIs data-parallel on the CPU: ``tools/train.py`` and
``tools/test.py`` with ``--launcher pytorch`` in two spawned gloo ranks
(torchrun's environment, ``parallel.launch.spawn``), on records of the tiny
distillation config's data block (``tests/test_torch_val.py``'s: window
engine, 4 frames, ``workers_per_gpu=0``).

Training: rank r takes shard r of each epoch's shuffled frames, so the two
ranks at batch 1 step on the samples one process at batch 2 steps on; one
checkpoint is written, and it holds the ranks' equal state; the logged
metrics and the BatchNorm statistics are the one process's (below).
Evaluation: the val set
of 3 frames is sharded with the shards wrapped to equal length (rank 0
frames 0 and 2, rank 1 frames 1 and 0); rank 0 merges, keeps the first of
the duplicate frame and evaluates; rank 1 gets None; the merged detections
equal one process's."""
import os
import pickle

import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.parallel.launch import cli_worker, spawn
from sparse2dense_tpu_torch.tools import test as test_cli
from sparse2dense_tpu_torch.tools import train as train_cli
from tests.test_torch_val import WINDOW, _config, records  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def runs(records, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("dp_cli")
    cfg = _config(records, tmp, "configs/tests/distill_tiny.py", True, WINDOW)
    with open(records[1], "rb") as f:
        infos = pickle.load(f)
    val_infos = str(tmp / "val_infos.pkl")
    with open(val_infos, "wb") as f:
        pickle.dump(infos[:3], f)
    with open(cfg, "a") as f:
        f.write(f"\ndata['val']['info_path'] = {val_infos!r}\n")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = train_cli.main([cfg, "--work_dir", str(tmp / "one"), "--device", "cpu",
                              "--batch_size", "2"])
        spawn(cli_worker, 2, ("train", [cfg, "--work_dir", str(tmp / "dp"), "--device", "cpu",
                                        "--batch_size", "1", "--launcher", "pytorch"],
                              str(tmp)), threads=1, timeout=300)
        ckpt = os.path.join(str(tmp / "one"), "latest")
        one_eval = test_cli.main([cfg, "--checkpoint", ckpt, "--work_dir", str(tmp / "e1"),
                                  "--device", "cpu"])
        spawn(cli_worker, 2, ("test", [cfg, "--checkpoint", ckpt, "--work_dir", str(tmp / "e2"),
                                       "--device", "cpu", "--launcher", "pytorch"],
                              str(tmp)), threads=1, timeout=300)
    finally:
        torch.set_num_threads(threads)
    load = {}
    for tool in ("train", "test"):
        for r in range(2):
            with open(tmp / f"{tool}_rank{r}.pkl", "rb") as f:
                load[tool, r] = pickle.load(f)
    return dict(tmp=tmp, one=one, one_eval=one_eval, **{f"{t}{r}": v for (t, r), v in
                                                        load.items()})


def test_train_cli_two_ranks_write_once_and_equal_one_process(runs):
    """One checkpoint, the state both ranks hold (rank 0 alone writes:
    ``tests/test_torch_dist_ranks.py``). Against one process at batch 2
    (float32): the first step's metrics within 1e-4, the gradient norm of
    the summed gradients included (gradients left unreduced would give each
    rank the norm of its own sample's); the second step's losses within 1e-3
    (the same second batch: another sample moves them by tenths); the
    BatchNorm running statistics, which both steps' global batch statistics
    move, within 2e-4. The parameters are not held against the one process
    here: the tiny teacher-student step is ill-conditioned in float32, and
    Adam's first steps move by their learning rate either way an element
    whose gradient is a rounding residue or changes sign between the runs,
    so no float32 bound on them would tell reduced gradients from unreduced
    ones. ``tests/test_torch_dist_steps.py`` holds this step's parameters
    after each step within 1e-5 of the one process, in float64."""
    one, r0, r1 = runs["one"], runs["train0"], runs["train1"]
    assert r0["global_iter"] == r1["global_iter"] == one.global_iter == 2
    assert sorted(os.listdir(runs["tmp"] / "dp")) == ["epoch_1", "latest"]
    assert r0["param_gap"] == r1["param_gap"] == 0.0
    ckpt = torch.load(runs["tmp"] / "dp" / "epoch_1", weights_only=True)["model"]
    for k, v in ckpt.items():
        assert torch.equal(v, r0["state"][k]) and torch.equal(v, r1["state"][k]), k
    history = one.log_buffer.val_history
    assert "grad_norm" in history
    for k, v in history.items():
        if k in ("time", "data_time"):
            continue
        assert r0["log"][k] == r1["log"][k], k   # the global values on both ranks
        np.testing.assert_allclose(r0["log"][k][0], v[0], rtol=1e-4, err_msg=k)
        if k.endswith("loss") or k.endswith("_0"):
            np.testing.assert_allclose(r0["log"][k][1], v[1], rtol=1e-3, err_msg=k)
    for k, v in one.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(ckpt[k].numpy(), v.numpy(), rtol=0, atol=2e-4, err_msg=k)


def test_test_cli_merges_on_rank_0(runs):
    detections, (result, _), _ = runs["one_eval"]
    r0, r1 = runs["test0"], runs["test1"]
    assert (r1["detections"], r1["result"]) == (None, None)
    assert sorted(r0["detections"]) == sorted(detections) == ["frame_0", "frame_1", "frame_2"]
    for token, det in detections.items():
        for k, v in det.items():
            np.testing.assert_array_equal(r0["detections"][token][k], v, err_msg=f"{token} {k}")
    assert r0["result"][0] == result
    shards = sorted(os.listdir(runs["tmp"] / "e2"))
    assert "detections_shard_0.pkl" in shards and "detections_shard_1.pkl" in shards
