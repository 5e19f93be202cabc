"""The tile engine in training: the trainable tile conv (``TileConv``: the
fused conv forward, a float32 VJP backward over the plan's halo'd tiles),
the train-mode tile blocks and the tile path of ``SpMiddleResNetFHD``
under autograd, with ``tile_backend="xla"`` (the reference's default) and
``"pallas"``. Tolerances, and why:

- ``TileConv`` against ``jax.vjp`` of the reference's ``tile_planes.subm_conv``
  (jitted; the reference's tile training is plain differentiable XLA) on
  the same numpy tile set, state, taps, mask and output gradient, and
  against autograd through ``tile_subm_plain`` (identity epilogue, also
  on a windowed plan that drops targets): output, d state and d taps within
  1e-5 of each one's largest value (float32; the sums differ in order only).
- One train-mode ``TileBasicBlock`` of the reference (jitted apply with its
  ``batch_stats``, and its VJP) against the port's train-mode ``TileKBlock``
  on a batch of two tile sets: output and BN running statistics within
  1e-5 of their largest value; the gradients of the weights and of the
  input within 1e-3 of their module's largest (train-mode BatchNorm
  amplifies float32 rounding of the conv sums into its gradients; the
  tiny TS steps' rule).
- The backbone on ``engine="tile"`` in train mode against the port's own
  gather engine (held against JAX by ``tests/test_torch_gather_engine.py``)
  on voxelnet_tiny's (25, 32, 32) grid, a batch of two scenes, the same
  weights, at ``dense_from_stage`` 0, 2 and 99: BEV and BN running
  statistics within 2e-4, the gradients of sum(BEV^2) within 2e-3 of each
  module's largest (the tolerances of ``tests/test_torch_plane_train.py``);
  every counter 0. ``"xla"`` and ``"pallas"`` (the latter with a plan
  window of 16 tiles, which training must not read) agree bit for bit.
- One ``distill_tiny`` teacher-student step with teacher and student on the
  tile engine against the same step on the gather engine from the same
  weights and batch: metrics within 1e-4, BN statistics within 1e-5,
  student gradients within 1e-3 of their module's largest plus 1e-12 of
  the step's largest gradient (``tests/test_torch_plane_train.py`` says
  why).

Every budget covers its stage's key space, so no counter is above 0 and the
reference is exact.

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the backbone cases,
``tests/test_torch_tile_train_backbone.py`` (``dense_from_stage`` 0),
``_dfs2.py`` and ``_dfs99.py``; the block,
``tests/test_torch_tile_block_train.py``; the teacher-student step,
``tests/test_torch_tile_train_step.py``; the plan windows,
``tests/test_torch_tile_plan_windows.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones.scn import TileBasicBlock as JTileBasicBlock
from sparse2dense_tpu.ops import tile_conv as JTC
from sparse2dense_tpu.ops import tile_planes as JTP
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import TileKBlock
from sparse2dense_tpu_torch.ops import tile_conv as TTC
from sparse2dense_tpu_torch.ops import tile_kernel as TTK
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import CFG, FRAME, _port_grads
from tests.test_torch_layers import load, rand_variables

CONV_GRID, CONV_TZ, CONV_BUDGET = (8, 32, 32), 4, 120


def _coords(seed, grid, v, n_pad):
    rng = np.random.RandomState(seed)
    lin = rng.choice(int(np.prod(grid)), v, replace=False)
    coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
    coords[-n_pad:] = -1
    return coords


def _tile_case(seeds, c):
    """Tile sets of one scene a seed (both packages), the port's
    batch-flattened state, mask and exact plan, and the chunk planes and
    masks of each sample in the reference's layout."""
    t1p, t1 = TTK.t1p_of(CONV_BUDGET), CONV_BUDGET + 1
    jsets, tsets, feats, coords = [], [], [], []
    for seed in seeds:
        cc = _coords(seed, CONV_GRID, 300, 10)
        jsets.append(JTC.build_tile_set(jnp.asarray(cc), CONV_GRID, 4, 4, CONV_TZ,
                                        CONV_BUDGET)[0])
        tsets.append(TTC.build_tile_set(torch.from_numpy(cc), CONV_GRID, 4, 4, CONV_TZ,
                                        CONV_BUDGET)[0])
        feats.append(np.random.RandomState(seed + 50).randn(len(cc), c).astype(np.float32))
        coords.append(cc)
    state, mask = TTK.build_state_batched(torch.from_numpy(np.stack(feats)),
                                          torch.from_numpy(np.stack(coords)), tsets, CONV_GRID,
                                          4, 4, CONV_TZ, t1p)
    b = len(seeds)
    planes = TTK.state_to_planes_batched(state, b, t1p, CONV_TZ, t1).numpy()
    mplanes = TTK.state_to_planes_batched(mask, b, t1p, CONV_TZ, t1).numpy()
    assert all(int(t.n_drop) == 0 for t in tsets)
    return dict(jsets=jsets, tsets=tsets, state=state, mask=mask, planes=planes,
                mplanes=mplanes, plan=TTK.make_block_plan_batched(tsets, t1p, t1p, t1p),
                t1p=t1p, t1=t1)


# ---------------------------------------------------------------------------
# the trainable tile conv
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conv_case():
    return _tile_case((0,), 16)


def _tile_conv_grads(state, plan, w, mask16, g, function=True):
    """(output, d state, d taps) of TileConv, or of autograd through the
    plain version, for the output gradient g."""
    s, wt = state.clone().requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    if function:
        out = TTK.tk_subm_conv_train(s, plan, wt, mask16)
    else:
        ones = torch.ones((1, mask16.shape[-1]))
        out = TTK.tile_subm_plain(s, plan.tgt, wt, ones, torch.zeros_like(ones), mask16,
                                  relu=False)
    (out * g).sum().backward()
    return out.detach().numpy(), s.grad.numpy(), wt.grad.numpy()


def _rel(ref):
    return dict(rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tile_conv_matches_jax_vjp(conv_case):
    """Output, d state and d taps of ``TileConv`` against the reference's
    differentiable tile conv on the chunk planes."""
    rng = np.random.RandomState(3)
    co, t1, t1p = 16, conv_case["t1"], conv_case["t1p"]
    w = (rng.randn(27, 16, co) / np.sqrt(27 * 16)).astype(np.float32)
    gp = rng.randn(t1 * CONV_TZ, 4, 4, co).astype(np.float32)
    ts, mp = conv_case["jsets"][0], jnp.asarray(conv_case["mplanes"][0])

    def out_and_vjp(y, wt, g):
        out, vjp = jax.vjp(lambda yy, ww: JTP.subm_conv(yy, mp, ts, CONV_TZ, ww)[0], y, wt)
        return (out,) + vjp(g)

    jout, jdy, jdw = (np.asarray(a) for a in jax.jit(out_and_vjp)(
        jnp.asarray(conv_case["planes"][0]), jnp.asarray(w), jnp.asarray(gp)))
    g = TTK.planes_to_state(torch.from_numpy(gp), CONV_TZ)
    out, ds, dw = _tile_conv_grads(conv_case["state"], conv_case["plan"], w,
                                   TTK.expand_mask(conv_case["mask"], co), g)
    to_planes = lambda s: TTK.state_to_planes(torch.from_numpy(s), CONV_TZ, co)[  # noqa: E731
        :t1 * CONV_TZ].numpy()
    assert int(conv_case["plan"].n_miss) == 0 and t1p > t1
    np.testing.assert_allclose(to_planes(out), jout, **_rel(jout))
    np.testing.assert_allclose(to_planes(ds), jdy, **_rel(jdy))
    np.testing.assert_allclose(dw, jdw, **_rel(jdw))
    assert np.abs(jdy).max() > 0 and np.abs(jdw).max() > 0
    # rows past the tile budget are no tile's: no gradient reaches them
    assert not ds[:, t1:].any()


@pytest.mark.parametrize("window,co", [(None, 16), (None, 8), (16, 16)],
                         ids=["16->16", "16->8", "window 16, misses"])
def test_tile_conv_matches_autograd_through_the_plain_version(conv_case, window, co):
    """The VJP against autograd through ``tile_subm_plain``; on a plan whose
    windows drop targets, it leaves out exactly the dropped taps."""
    rng = np.random.RandomState(co)
    state, mask, t1p = conv_case["state"], conv_case["mask"], conv_case["t1p"]
    plan = (conv_case["plan"] if window is None else
            TTK.make_block_plan_batched(conv_case["tsets"], t1p, window, window))
    assert (int(plan.n_miss.sum()) > 0) == (window is not None)
    w = (rng.randn(27, 16, co) / np.sqrt(27 * 16)).astype(np.float32)
    mask16 = TTK.expand_mask(mask, co)
    g = torch.from_numpy(rng.randn(CONV_TZ, t1p, 16 * co).astype(np.float32))
    got = _tile_conv_grads(state, plan, w, mask16, g)
    want = _tile_conv_grads(state, plan, w, mask16, g, function=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **_rel(b))


# ---------------------------------------------------------------------------
# one train-mode residual block against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_case():
    """The reference's train-mode ``TileBasicBlock`` (jitted apply and VJP)
    and the port's ``TileKBlock`` on two samples' tile sets, same weights,
    input and output gradient."""
    case = _tile_case((1, 2), 16)
    jts = JTC.TileSet(*(jnp.stack(f) for f in zip(*case["jsets"])))
    y, m = jnp.asarray(case["planes"]), jnp.asarray(case["mplanes"])
    jblock = JTileBasicBlock(16, tz=CONV_TZ)
    variables = rand_variables(lambda: jblock.init(jax.random.PRNGKey(0), y, m, jts, True),
                               seed=21)
    gp = np.random.RandomState(22).randn(*case["planes"].shape).astype(np.float32)

    def fwd(params, stats, yy, g):
        def apply(p, x):
            return jblock.apply({"params": p, "batch_stats": stats}, x, m, jts, True,
                                mutable=["batch_stats"])
        out, vjp, upd = jax.vjp(apply, params, yy, has_aux=True)
        return (out, upd["batch_stats"]) + vjp(g)

    jout, jstats, jdp, jdy = jax.jit(fwd)(variables["params"], variables["batch_stats"], y,
                                          jnp.asarray(gp))
    block = load(TileKBlock(16, 16), variables).train()
    state = case["state"].clone().requires_grad_(True)
    out = block(state, case["mask"], case["plan"])
    b, t1p, t1 = 2, case["t1p"], case["t1"]
    (out * TTK.planes_to_state_batched(torch.from_numpy(gp), CONV_TZ, t1p)).sum().backward()
    to_planes = lambda s: TTK.state_to_planes_batched(s.detach(), b, t1p, CONV_TZ,  # noqa: E731
                                                      t1).numpy()
    return dict(out=to_planes(out), jout=np.asarray(jout), dy=to_planes(state.grad),
                jdy=np.asarray(jdy), block=block,
                jstats=from_tree(jstats, block), jgrads=from_tree(jdp, block, "params"))


def from_tree(tree, module, coll="batch_stats"):
    from sparse2dense_tpu_torch.convert import from_flax

    return {k: v.numpy() for k, v in from_flax({coll: jax.tree_util.tree_map(
        np.asarray, tree)}, module).items()}


# ---------------------------------------------------------------------------
# the backbone: tile engine in train mode against the gather engine
# ---------------------------------------------------------------------------

GRID = (25, 32, 32)   # voxelnet_tiny's sparse shape
# the key spaces of chunk tiles tz 8 / 4 / 2 / 6 on the conv1..conv4 grids
# (25, 32, 32), (13, 16, 16), (7, 8, 8), (3, 4, 4): 256, 64, 16, 1
SETTINGS = dict(num_input_features=5, sparse_shape=GRID,
                stage_budgets=(4000, 3000, 2000, 2000), tile_tz=(8, 4, 2, 6),
                tile_budgets=(255, 64, 16, 1))
ENGINES = {"gather": dict(engine="gather"), "xla": dict(engine="tile"),
           "pallas": dict(engine="tile", tile_backend="pallas", tilek_window=16)}


def _weights(module, seed):
    """Seeded weights of every parameter and BN statistic of ``module``:
    fan-in scaled conv kernels, BN scales and variances near 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in sorted(module.state_dict().items()):
        if name.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, t.shape)
        elif t.dim() == 5:
            v = rng.randn(*t.shape) / np.sqrt(np.prod(t.shape[1:]))
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * rng.randn(*t.shape)
        else:
            v = 0.1 * rng.randn(*t.shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# the teacher-student step on the tile engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ts_steps():
    """``distill_tiny``'s step with teacher and student on the tile engine
    (``tile_backend="xla"``, ``dense_from_stage=2``, budgets covering every
    key) and on the gather engine at the same ``dense_from_stage``, from
    the same weights."""
    engines = {"tile": dict(engine="tile", dense_from_stage=2, dense_compute_dtype=None,
                            tile_budgets=(384, 96, 24, 4)),
               "gather": dict(engine="gather", dense_from_stage=2, dense_compute_dtype=None)}
    out, weights = {}, None
    for name, settings in engines.items():
        cfg = ConfigDict.fromfile(CFG)
        for key in ("model", "S_model"):
            cfg[key]["backbone"].update(settings)
        kw = dict(test_cfg=cfg.test_cfg, voxel_generator=cfg.voxel_generator, device="cpu")
        teacher = build_detector(cfg.model, generator=torch.Generator().manual_seed(4), **kw)
        student = build_detector(cfg.S_model, generator=torch.Generator().manual_seed(5), **kw)
        if weights is None:   # copies: the step moves the student's weights in place
            weights = [{k: v.clone() for k, v in m.state_dict().items()}
                       for m in (teacher, student)]
        teacher.load_state_dict(weights[0])
        student.load_state_dict(weights[1])
        batch = make_batch(cfg, 1, device="cpu", with_targets=True, distillation=True, **FRAME)
        opt = OneCycleAdam(student.parameters(), cfg.optimizer, cfg.lr_config, 10,
                           cfg.optimizer_config["grad_clip"])
        metrics = TS_Trainer(teacher, student, opt, cfg.model).step(batch)
        out[name] = dict(metrics=metrics, grads=_port_grads(student),
                         stats={k: v.clone() for k, v in student.state_dict().items()
                                if "running" in k})
    return out


