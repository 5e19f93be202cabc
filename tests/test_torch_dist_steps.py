"""Data parallelism against one process, on the CPU: two gloo ranks of one
sample each take the same 2 training steps as one process on both samples,
for the plain step of ``configs/tests/pp_tiny.py`` (PointPillars) and the
teacher-student ("centerpoint") step of ``configs/tests/distill_tiny.py``
(its gather engine; seeded weights, one synthetic batch of 2).

The runs are in float64 (``parallel.launch.build_job``'s ``dtype``): the
ranks sum the BatchNorm statistics, the normalisers and the gradients in
another order than one process does, and the tiny models amplify a float32
rounding difference past any useful tolerance (a BatchNorm over the two
samples of a 1x1 map, ReLU kinks; and Adam's first step moves a parameter
whose gradient is a rounding residue by its learning rate either way). In
float64 what is left is the semantics: metrics within 1e-5 (relative),
gradients within 1e-5 of their module's largest, BatchNorm running
statistics and parameters after each step within 1e-5 of the one-process
run's, and the parameters equal to the bit across the ranks."""
import numpy as np
import pytest
import torch

from sparse2dense_tpu_torch.parallel.launch import one_process_steps, spawn, steps_worker
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

JOBS = {
    "plain": ("configs/tests/pp_tiny.py", dict(max_voxels=256, n_points=600, n_obj=4, seed=0)),
    "ts": ("configs/tests/distill_tiny.py", dict(max_voxels=512, n_points=3000, n_obj=6, seed=0)),
}


def run_jobs(tmp):
    """Both jobs at two ranks (one spawn, one process group) and in this
    process: {kind: (the ranks' runs, the one process's rows)}."""
    jobs, paths = {}, []
    for kind, (config, frame) in JOBS.items():
        cfg = ConfigDict.fromfile(config)
        batch = make_batch(cfg, 2, device="cpu", with_targets=True, distillation=kind == "ts",
                           **frame)
        jobs[kind] = dict(config=config, kind=kind, batch=batch, per_rank=1, steps=2,
                          device="cpu", dtype="float64")
        paths.append(str(tmp / f"job_{kind}.pt"))
        torch.save(jobs[kind], paths[-1])
    spawn(steps_worker, 2, (paths, str(tmp)), threads=1, timeout=300)
    return {kind: ([torch.load(tmp / f"steps_rank{r}_{i}.pt", weights_only=False)
                    for r in range(2)], one_process_steps(job, "cpu")["rows"])
            for i, (kind, job) in enumerate(jobs.items())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(tmp_path_factory.mktemp("dp_steps"))


@pytest.fixture(scope="module")
def plain(runs):
    return runs["plain"]


@pytest.fixture(scope="module")
def ts(runs):
    return runs["ts"]


def check_metrics_and_gradients(ranks, want):
    for step, w in enumerate(want):
        for r, got in enumerate(rank["rows"][step] for rank in ranks):
            assert sorted(got["metrics"]) == sorted(w["metrics"])
            for k, v in w["metrics"].items():
                np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-12,
                                           err_msg=f"step {step} rank {r} {k}")
            scale = {}
            for name, g in w["grads"].items():
                module = name.rsplit(".", 1)[0]
                scale[module] = max(scale.get(module, 0.0), float(g.abs().max()))
            for name, g in w["grads"].items():
                np.testing.assert_allclose(
                    got["grads"][name].numpy(), g.numpy(), rtol=0,
                    atol=1e-5 * scale[name.rsplit(".", 1)[0]] + 1e-12,
                    err_msg=f"step {step} rank {r} {name}")
        assert w["metrics"]["loss"] > 0 and w["metrics"]["grad_norm"] > 0


def check_state(ranks, want):
    for step, w in enumerate(want):
        r0, r1 = (rank["rows"][step]["model"] for rank in ranks)
        for name, v in w["model"].items():
            assert torch.equal(r0[name], r1[name]), f"step {step} {name}: ranks differ"
            np.testing.assert_allclose(r0[name].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"step {step} {name}")
        assert [rank["param_gaps"][step] for rank in ranks] == [0.0, 0.0]
        before = ranks[0]["rows"][step - 1]["model"] if step else None
        if before is not None:   # the parameters moved
            assert any(not torch.equal(before[k], r0[k]) for k in r0)


def test_plain_step_metrics_and_gradients(plain):
    check_metrics_and_gradients(*plain)


def test_plain_step_parameters_and_statistics(plain):
    check_state(*plain)


def test_ts_step_metrics_and_gradients(ts):
    check_metrics_and_gradients(*ts)


def test_ts_step_parameters_and_statistics(ts):
    check_state(*ts)
