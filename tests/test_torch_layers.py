"""Layers of the PyTorch port against their JAX/Flax references on the same
numpy inputs. Flax variables are drawn at random (seeded) from the module's
variable shapes and carried over with ``convert.from_flax``. float32
throughout; tolerances cover summation order (rtol 1e-4, atol 1e-5).

Split into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the dense stages,
``tests/test_torch_dense_stages.py``; the neck's layers,
``tests/test_torch_neck_layers.py``; the head, the NMS and the all-dense
backbone, ``tests/test_torch_head_layers.py``."""
import contextlib
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones import scn as jscn
from sparse2dense_tpu.models import norm as jnorm
from sparse2dense_tpu.models.readers.pillar_encoder import VoxelFeatureExtractorV3 as JVFE
from sparse2dense_tpu_torch.convert import from_flax, is_pcr_key
from sparse2dense_tpu_torch.models.backbones import scn as tscn
from sparse2dense_tpu_torch.models import norm as tnorm
from sparse2dense_tpu_torch.models.readers.pillar_encoder import VoxelFeatureExtractorV3 as TVFE

# One intra-op thread in every process that imports the port's tests (a
# test session imports them all when it collects): the tiny models' small
# ops run as fast on it, and with a team of threads in each of the suite's
# parallel workers OpenMP's barriers stall every op once the workers'
# threads outnumber the cores (the port's heaviest tests ran 1.1-1.9x
# slower on 8 threads a worker than on one, six workers on 8 cores).
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TASKS = ({"num_class": 3, "class_names": ["VEHICLE", "PEDESTRIAN", "CYCLIST"]},)
HEADS = {"reg": (2, 2), "height": (1, 2), "dim": (3, 2), "rot": (2, 2)}


def flax_shapes(model, pcr=False):
    """The shapes of the Flax variables of the reference twin of the port's
    ``model``, read off its ``state_dict`` by inverting ``from_flax``'s
    renames and layouts; with ``pcr`` the PCR generators, which only a
    train-mode init of the reference creates. It stands in for
    ``jax.eval_shape`` of the reference's init, which traces the whole model
    (up to ~45 s a model on the engines'); ``test_flax_shapes_are_the_inits``
    holds the two equal."""
    modules = dict(model.named_modules())
    tree = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked" or (not pcr and is_pcr_key(path)):
            continue
        shape, coll = tuple(t.shape), "params"
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf.endswith("_weight"):   # sparse kernel (Co, Ci, kz, ky, kx) -> (taps, Ci, Co)
            leaf, shape = leaf[:-len("_weight")] + "_kernel", (
                int(np.prod(shape[2:])), shape[1], shape[0])
        elif leaf == "weight" and len(shape) == 1:
            leaf = "scale"
        elif leaf == "weight":
            transposed = isinstance(modules[".".join(path)],
                                    (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d))
            leaf, shape = "kernel", shape[2:] + (shape[:2] if transposed else shape[1::-1])
        node = tree.setdefault(coll, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return tree


def rand_variables(init_fn, seed=0):
    """Flax variables with the shapes ``init_fn()`` would give (or of the
    shape tree ``init_fn``, as :func:`flax_shapes` gives), drawn from a
    seeded numpy generator: fan-in scaled kernels, BN stats away from 0/1."""
    shapes = jax.eval_shape(init_fn) if callable(init_fn) else init_fn
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith("kernel"):
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, shapes[k])
            for k in ("params", "batch_stats") if k in shapes}


@contextlib.contextmanager
def eager_compiles_cached():
    """JAX run op by op inside, with every op's compile written to the
    persistent compilation cache: the suite keeps only compiles of 1 s or
    more (``tests/conftest.py``), and an eager reference compiles hundreds
    of ops of ~0.05 s each, every run. Inside, a machine pays them once and
    later runs load them; what JAX computes is the same."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    try:
        yield
    finally:
        jax.config.update(key, old)


def eager_cache_fixture():
    """A module-scoped autouse fixture that runs its test module inside
    :func:`eager_compiles_cached`: assign it to a name of the module, for a
    module whose JAX references run op by op."""
    @pytest.fixture(scope="module", autouse=True)
    def eager_cache():
        with eager_compiles_cached():
            yield
    return eager_cache


def session_shared(tmp_path_factory, name, compute):
    """``compute()``, once a test session: the first process that asks
    computes it and writes it (pickled) under the session's temporary root,
    and every later one reads it: a module of another file, or another of
    pytest-xdist's workers (they share the parent of their base temporary
    directories). A file lock orders them. For a reference's results that
    two test files both check (files are split at 4 tests): keep the value
    to NumPy arrays and plain containers."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"shared_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        with open(path, "wb") as f:
            pickle.dump(value, f)
    return value


def to_numpy(tree):
    """``tree`` with its JAX arrays as NumPy arrays (other leaves kept)."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
                                  tree)


def load(module, variables):
    module.load_state_dict(from_flax(variables, module))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_batchnorm_eval_and_masked_train():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    mask = rng.rand(2, 5, 6, 1) > 0.4
    jbn = jnorm.BatchNorm()
    v = rand_variables(lambda: jbn.init(jax.random.PRNGKey(0), x))
    tbn = load(tnorm.BatchNorm(4, channel_dim=-1), v)
    with torch.no_grad():
        got = tbn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbn.apply(v, x, use_running_average=True)), **TOL)

    want, upd = jbn.apply(v, x, mask=mask, use_running_average=False, mutable=["batch_stats"])
    tbn.train()
    with torch.no_grad():
        got = tbn(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(tbn.running_mean.numpy(), upd["batch_stats"]["mean"], **TOL)
    np.testing.assert_allclose(tbn.running_var.numpy(), upd["batch_stats"]["var"], **TOL)
    assert tbn.eps == 1e-3


def test_layernorm2d_and_vfe():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    jln = jnorm.LayerNorm2d()
    v = rand_variables(lambda: jln.init(jax.random.PRNGKey(0), x))
    tln = load(tnorm.LayerNorm2d(8), v)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tln(nchw(x))), np.asarray(jln.apply(v, x)), **TOL)

    vox = rng.randn(2, 10, 5, 5).astype(np.float32)
    npts = rng.randint(0, 6, (2, 10)).astype(np.int32)
    want = JVFE(num_input_features=5).apply({}, vox, npts)
    got = TVFE(num_input_features=5)(torch.from_numpy(vox), torch.from_numpy(npts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _dense_scene(rng, c=4, shape=(1, 6, 7, 8)):
    mask = (rng.rand(*shape, 1) > 0.6).astype(np.float32)
    x = rng.randn(*shape, c).astype(np.float32) * mask
    return x, mask


def test_densify_and_bev():
    rng = np.random.RandomState(3)
    grid = (4, 6, 5)
    lin = rng.choice(np.prod(grid), 20, replace=False)
    coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
    coords = np.concatenate([coords, -np.ones((4, 3), np.int32)])[None]
    feats = rng.randn(1, 24, 3).astype(np.float32)
    valid = (coords >= 0).all(-1)
    jd, jm = jscn.densify(jscn.SparseTensor(jnp.asarray(feats), coords, valid), grid)
    td, tm = tscn.densify(torch.from_numpy(feats), torch.from_numpy(coords),
                          torch.from_numpy(valid), grid)
    np.testing.assert_array_equal(np.moveaxis(td.numpy(), 1, -1), np.asarray(jd))
    np.testing.assert_array_equal(np.moveaxis(tm.numpy(), 1, -1), np.asarray(jm))
    np.testing.assert_array_equal(tscn.dense_to_bev(td).numpy(),
                                  np.asarray(jscn.dense_to_bev(jd)))


def test_flax_shapes_are_the_inits():
    """``flax_shapes`` of the port's twin equals ``jax.eval_shape`` of the
    reference's init, leaf for leaf (paths, shapes, the PCR generators of a
    train-mode init) on distill_tiny's student in training on its default
    gather engine: sparse kernels, BN, the S2D neck's transposed 2D and 3D
    convs and the head."""
    from sparse2dense_tpu.models import build_detector as jax_build_detector
    from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
    from sparse2dense_tpu.utils import Config
    from sparse2dense_tpu_torch.models import build_detector
    from sparse2dense_tpu_torch.utils.config import ConfigDict

    path = "configs/tests/distill_tiny.py"
    jcfg, tcfg = Config.fromfile(path), ConfigDict.fromfile(path)
    jm = jax_build_detector(jcfg.S_model, test_cfg=jcfg.test_cfg,
                            voxel_generator=jcfg.voxel_generator)
    batch = jax_make_batch(jcfg, 1, max_voxels=256, n_points=1000, n_obj=3,
                           distillation=True)
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch, train=True))
    tm = build_detector(tcfg.S_model, test_cfg=tcfg.test_cfg,
                        voxel_generator=tcfg.voxel_generator, device="cpu")

    def flat(tree):
        return [(jax.tree_util.keystr(p), tuple(leaf.shape))
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]

    assert flat(flax_shapes(tm, pcr=True)) == flat(
        {k: want[k] for k in ("params", "batch_stats")})
