"""Data parallelism against the JAX package directly: the reference's
``make_train_step`` jitted over a 2-device mesh (2 of the suite's 8 virtual
CPU devices, the batch sharded on the data axis, the state replicated, as
``tests/test_train_smoke.py`` runs it) against the port's plain step at two
gloo ranks of one sample each, on ``configs/tests/pp_tiny.py`` with the same
seeded random weights (``from_flax``) and the same synthetic batch of 2,
in float32. JAX's gradients come from a ``TrainState`` whose ``tx`` is
``optax.sgd(1.0)`` (the parameters before minus after). Tolerances of the
teacher-student steps' parity: metrics 1e-4 (relative), gradients 1e-3 of
their module's largest, BatchNorm running statistics 1e-5."""
import numpy as np
import pytest
import torch

import jax
import optax
from jax.sharding import Mesh

from sparse2dense_tpu.models import build_detector as jax_build_detector
from sparse2dense_tpu.parallel.mesh import replicate, shard_batch
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.training.train_state import TrainState
from sparse2dense_tpu.training.train_state import make_train_step as jax_train_step
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.parallel.launch import spawn, steps_worker
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import assert_grads_close
from tests.test_torch_layers import flax_shapes, rand_variables

CFG = "configs/tests/pp_tiny.py"
FRAME = dict(max_voxels=256, n_points=600, n_obj=4, seed=0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    jmodel = jax_build_detector(jcfg.S_model, train_cfg=jcfg.train_cfg, test_cfg=jcfg.test_cfg)
    student = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                             voxel_generator=tcfg.voxel_generator, device="cpu")
    variables = rand_variables(flax_shapes(student), seed=12)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    state = replicate(TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                        batch_stats=variables["batch_stats"],
                                        tx=optax.sgd(1.0)), mesh)
    jbatch = shard_batch(jax_make_batch(jcfg, 2, **FRAME), mesh)
    after, jmetrics = jax.jit(jax_train_step(jmodel))(state, jbatch)

    tmp = tmp_path_factory.mktemp("dp_jax")
    job = dict(config=CFG, kind="plain", per_rank=1, steps=1, device="cpu",
               batch=make_batch(tcfg, 2, device="cpu", with_targets=True, **FRAME),
               state={"student": from_flax(variables, student)})
    torch.save(job, tmp / "job.pt")
    spawn(steps_worker, 2, ([str(tmp / "job.pt")], str(tmp)), threads=1, timeout=300)
    ranks = [torch.load(tmp / f"steps_rank{r}_0.pt", weights_only=False) for r in range(2)]
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   variables["params"], after.params)
    return dict(
        ranks=[rank["rows"][0] for rank in ranks], gaps=[rank["param_gaps"] for rank in ranks],
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        jgrads=from_flax({"params": grads}, student),
        jstats=from_flax({"batch_stats": after.batch_stats}, student))


def test_metrics_against_the_jax_mesh(run):
    for r, got in enumerate(run["ranks"]):
        assert sorted(got["metrics"]) == sorted(run["jmetrics"])
        for k, v in run["jmetrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=f"rank {r} {k}")


def test_gradients_against_the_jax_mesh(run):
    for got in run["ranks"]:
        assert_grads_close({k: g.numpy() for k, g in got["grads"].items()}, run["jgrads"])


def test_batchnorm_statistics_and_replicas(run):
    """The SyncBN running statistics against the mesh's global-batch ones;
    the ranks' parameters and statistics equal to the bit."""
    r0, r1 = (got["model"] for got in run["ranks"])
    stats = {k: v for k, v in r0.items() if "running" in k}
    assert stats and set(stats) <= set(run["jstats"])
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), run["jstats"][k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    assert run["gaps"] == [[0.0], [0.0]]
