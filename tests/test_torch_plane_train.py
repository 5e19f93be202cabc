"""The plane engine in training: the trainable plane conv (``PlaneConv``:
the fused conv forward, a float32 VJP backward over the batch's neighbour
table) and the plane path of ``SpMiddleResNetFHD`` under autograd.

- The conv's backward against JAX's ``jax.vjp`` of ``plane_subm_reference``
  (the reference's custom-VJP backward) on the same numpy state, taps and
  mask over plane sets built by both packages, and against autograd through
  ``plane_subm_plain`` (identity epilogue over the plan's targets): within
  1e-5 of the largest value, float32.
- The backbone on ``engine="plane"`` in train mode against the port's own
  gather engine at ``dense_from_stage=99`` (held against JAX by
  ``tests/test_torch_gather_engine.py``) on the scene and settings of JAX's
  ``tests/test_plane_backbone.py`` with the same weights: BEV and BN
  running statistics within 2e-4, the gradients of sum(BEV^2) within 2e-3
  of each module's largest (JAX's own tolerances there).
- One ``distill_tiny`` teacher-student step with teacher and student on the
  plane engine against the same step on the gather engine: metrics within
  1e-4, gradients 1e-3 of their module's largest, BN statistics 1e-5.

Every budget and window covers its stage, so no counter is above 0 and the
reference is exact."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.backbones.scn import SpMiddleResNetFHD as JSpMiddleResNetFHD
from sparse2dense_tpu.ops import plane_conv as JPK
from sparse2dense_tpu.ops import tile_conv as JTC
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import build_detector
from sparse2dense_tpu_torch.models.backbones.scn import (PlaneKBlock, SpMiddleResNetFHD,
                                                         TileKBlock, TileKStage)
from sparse2dense_tpu_torch.ops import plane_conv as TPK
from sparse2dense_tpu_torch.ops import tile_kernel as TTK
from sparse2dense_tpu_torch.solver.optim import OneCycleAdam
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.training.trainer import TS_Trainer
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_distill import CFG, FRAME, _compare_stats, _port_grads
from tests.test_torch_layers import rand_variables
from tests.test_torch_plane_detector import ENGINE as PLANE_ENGINE

GRID = (41, 64, 64)
SETTINGS = dict(num_input_features=5, sparse_shape=GRID, dense_from_stage=99,
                stage_budgets=(4000, 3000, 2000, 2000), tile_tz=(8, 4, 2, 6),
                tile_budgets=(800, 700, 500, 300), plane_budgets=(1500, 800, 300),
                plane_window=10 ** 6, win_window=10 ** 6)
COUNTERS = ("plane_drop", "planek_miss", "plane_chunk_drop", "down_drop")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small ops run as fast on it, and the suite's
    parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene(seed, v, b):
    """JAX's ``tests/test_plane_backbone.py`` scene: v distinct random voxels
    a sample on GRID, the last 30 padding."""
    rng = np.random.RandomState(seed)
    out_c, out_f = [], []
    for _ in range(b):
        lin = rng.choice(GRID[0] * GRID[1] * GRID[2], v, replace=False)
        coords = np.stack([lin // (GRID[1] * GRID[2]), (lin // GRID[2]) % GRID[1],
                           lin % GRID[2]], -1).astype(np.int32)
        coords[-30:] = -1
        feats = rng.randn(v, 5).astype(np.float32)
        feats[-30:] = 0
        out_c.append(coords)
        out_f.append(feats)
    return np.stack(out_f), np.stack(out_c)


# ---------------------------------------------------------------------------
# the trainable plane conv
# ---------------------------------------------------------------------------

CONV_GRID, CONV_BUDGET = (8, 32, 32), 512


@pytest.fixture(scope="module")
def conv_case():
    """Two samples' plane sets (both packages), their flat neighbour ranks,
    a plane state and mask, and the plan."""
    rng = np.random.RandomState(7)
    t1p = TPK.t1p_of(CONV_BUDGET)
    jsets, tsets, states, masks = [], [], [], []
    for seed in (0, 1):
        lin = rng.choice(int(np.prod(CONV_GRID)), 500, replace=False)
        coords = np.stack(np.unravel_index(lin, CONV_GRID), -1).astype(np.int32)
        coords[-20:] = -1
        jsets.append(JPK.build_plane_set(jnp.asarray(coords), CONV_GRID, CONV_BUDGET)[0])
        ts = TPK.build_plane_set(torch.from_numpy(coords), CONV_GRID, CONV_BUDGET)[0]
        tsets.append(ts)
        feats = torch.from_numpy(rng.randn(500, 16).astype(np.float32))
        st, mk = TPK.build_plane_state(feats, torch.from_numpy(coords), ts, CONV_GRID, t1p)
        states.append(st)
        masks.append(mk)
    jnbr = JPK.flat_neighbor_ranks(JTC.TileSet(*(jnp.stack(f) for f in zip(*jsets))), t1p)
    nbr = TPK.flat_neighbor_ranks(tsets, t1p)
    plan = TPK.make_plane_plan_batched(tsets, t1p, 10 ** 6, 10 ** 6)._replace(nbr=nbr)
    # each sample's always-zero row, which absent neighbours name
    zero_rows = [b * t1p + CONV_BUDGET for b in range(2)]
    return dict(jnbr=jnbr, nbr=nbr, plan=plan, state=torch.cat(states),
                mask=torch.cat(masks), zero_rows=zero_rows, t1p=t1p)


def test_flat_neighbor_ranks_bit_exact(conv_case):
    np.testing.assert_array_equal(conv_case["nbr"].numpy(), np.asarray(conv_case["jnbr"]))
    assert int(conv_case["plan"].n_miss.sum()) == 0


@pytest.mark.parametrize("co", [16, 8], ids=["16->16", "16->8"])
def test_plane_conv_backward_matches_jax_vjp_and_autograd(conv_case, co):
    """d state and d taps of ``PlaneConv`` against ``jax.vjp`` of the
    reference formula and against autograd through the plain version."""
    rng = np.random.RandomState(co)
    state, plan = conv_case["state"], conv_case["plan"]
    n = state.shape[0]
    w = rng.randn(27, 16, co).astype(np.float32) / np.sqrt(27 * 16)
    mask16 = TPK.expand_mask(conv_case["mask"], co)
    g = rng.randn(n, 16 * co).astype(np.float32)

    def out_and_vjp(s, wt, m, cot):
        out, vjp = jax.vjp(lambda s_, w_: JPK.plane_subm_reference(s_, conv_case["jnbr"], w_, m),
                           s, wt)
        return (out,) + vjp(cot)

    jout, jds, jdw = (np.asarray(x) for x in jax.jit(out_and_vjp)(
        jnp.asarray(state.numpy()), jnp.asarray(w), jnp.asarray(mask16.numpy()),
        jnp.asarray(g)))

    grads = {}
    for name in ("function", "plain"):
        s, wt = state.clone().requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
        if name == "function":
            out = TPK.pk_subm_conv_train(s, plan, wt, mask16)
        else:
            ones = torch.ones((1, 16 * co))
            out = TPK.plane_subm_plain(s, plan.tgt, wt, ones, torch.zeros_like(ones), mask16,
                                       relu=False)
        (out * torch.from_numpy(g)).sum().backward()
        grads[name] = (out.detach().numpy(), s.grad.numpy(), wt.grad.numpy())

    out, ds, dw = grads["function"]
    tol = lambda ref: dict(rtol=0, atol=1e-5 * np.abs(ref).max())  # noqa: E731
    np.testing.assert_allclose(out, np.asarray(jout), **tol(np.asarray(jout)))
    np.testing.assert_allclose(dw, jdw, **tol(jdw))
    # the reference's VJP also writes to the samples' always-zero rows (their
    # taps read them as absent neighbours); they are zero in every state and
    # the port's backward leaves them without a gradient
    keep = np.ones(n, bool)
    keep[conv_case["zero_rows"]] = False
    np.testing.assert_allclose(ds[keep], jds[keep], **tol(jds))
    assert np.abs(jds[~keep]).max() > 0 and not ds[~keep].any()
    for got, want in zip(grads["function"], grads["plain"]):
        np.testing.assert_allclose(got, want, **tol(want))
    assert np.abs(ds).max() > 0 and np.abs(dw).max() > 0


def test_plane_conv_needs_the_neighbour_table(conv_case):
    plan = conv_case["plan"]._replace(nbr=None)
    with pytest.raises(ValueError, match="neighbour table"):
        TPK.pk_subm_conv_train(conv_case["state"], plan, torch.zeros(27, 16, 16),
                               TPK.expand_mask(conv_case["mask"], 16))


def test_plane_block_trains_and_the_tile_blocks_do_not(conv_case):
    """Train-mode PlaneKBlock: batch statistics, a gradient on every weight;
    TileKBlock and TileKStage train too (an output, a weight gradient and
    moved BN statistics)."""
    torch.manual_seed(0)
    block = PlaneKBlock(16, 16).train()
    for name in ("conv1_weight", "conv2_weight"):
        torch.nn.init.normal_(getattr(block, name), std=0.05)
    state = conv_case["state"].clone().requires_grad_(True)
    out = block(state, conv_case["mask"], conv_case["plan"])
    out.square().sum().backward()
    assert out.shape == state.shape and bool((out[conv_case["mask"].repeat_interleave(
        16, -1) == 0] == 0).all())
    assert float(block.bn1.running_mean.abs().max()) > 0
    for name, p in block.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    tmask = (torch.rand(4, 128, 16, generator=torch.Generator().manual_seed(1)) < 0.3).float()
    tstate = torch.randn(4, 128, 256) * tmask.repeat_interleave(16, -1)
    tplan = TTK.TKPlan(torch.zeros(1, 9, dtype=torch.int32),
                       torch.full((1, 32, 128), TTK.SENTINEL, dtype=torch.int32),
                       torch.zeros((), dtype=torch.int32))
    for mod in (TileKBlock(16, 16), TileKStage(16, (16,))):
        mod.train()
        convs = [p for p in mod.parameters() if p.dim() == 5]
        for weight in convs:
            torch.nn.init.normal_(weight, std=0.05)
        out = mod(tstate.clone().requires_grad_(True), tmask, tplan)
        out.square().sum().backward()
        assert out.shape == tstate.shape
        assert all(float(weight.grad.abs().max()) > 0 for weight in convs)
        stats = [b for n, b in mod.named_buffers() if n.endswith("running_mean")]
        assert float(stats[0].abs().max()) > 0


# ---------------------------------------------------------------------------
# the backbone: plane engine in train mode against the gather engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def backbones():
    """Train-mode forward and the gradients of sum(BEV^2) on both engines,
    from one set of weights (the JAX gather module's shapes)."""
    feats, coords = scene(2, v=400, b=2)
    jmod = JSpMiddleResNetFHD(engine="gather", **SETTINGS)
    variables = rand_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(coords)),
        seed=31)
    out = {}
    for engine in ("gather", "plane"):
        mod = SpMiddleResNetFHD(engine=engine, **SETTINGS)
        mod.load_state_dict(from_flax(variables, mod))
        mod.train()
        bev, _, tele = mod(torch.from_numpy(feats), torch.from_numpy(coords))
        bev.square().sum().backward()
        out[engine] = dict(bev=bev.detach().numpy(), telemetry=tele,
                           stats={k: v.clone() for k, v in mod.state_dict().items()
                                  if "running" in k},
                           grads=_port_grads(mod))
    return out


def test_plane_train_counters_are_zero(backbones):
    tele = backbones["plane"]["telemetry"]
    for name in COUNTERS:
        assert int(tele[name][0].sum()) == 0, name
    assert all(int(c.max()) <= b for c, b in tele.values())


def test_plane_train_bev_and_statistics_match_gather(backbones):
    p, g = backbones["plane"], backbones["gather"]
    assert p["bev"].shape == g["bev"].shape and np.abs(g["bev"]).max() > 0
    np.testing.assert_allclose(p["bev"], g["bev"], rtol=2e-4, atol=2e-4)
    assert sorted(p["stats"]) == sorted(g["stats"])
    for k, v in g["stats"].items():
        np.testing.assert_allclose(p["stats"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_plane_train_gradients_match_gather(backbones):
    """Every weight from conv_input to extra_conv gets the gather engine's
    gradient, within 2e-3 of its module's largest."""
    got, want = backbones["plane"]["grads"], backbones["gather"]["grads"]
    assert sorted(got) == sorted(want)
    scale = {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 1.0), float(np.abs(g).max()))
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=2e-3,
                                   atol=2e-3 * scale[name.rsplit(".", 1)[0]], err_msg=name)
    for name in ("conv_input.conv_0_weight", "conv2_0.conv1_weight", "conv3_down.conv_weight",
                 "conv4_1.conv2_weight", "extra_conv.conv_weight"):
        assert np.abs(got[name]).max() > 0, name


# ---------------------------------------------------------------------------
# the teacher-student step on the plane engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ts_steps():
    """``distill_tiny``'s step with teacher and student on the plane engine
    and on the gather engine (every stage sparse), from the same weights."""
    engines = {"plane": PLANE_ENGINE,
               "gather": dict(engine="gather", dense_from_stage=99, dense_compute_dtype=None)}
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


def test_plane_ts_step_metrics(ts_steps):
    got, want = ts_steps["plane"]["metrics"], ts_steps["gather"]["metrics"]
    tele = {k: int(v) for k, v in got.items() if k.startswith("telemetry/")}
    assert {k.split("/")[1] for k in tele} >= set(COUNTERS)
    assert all(v == 0 for k, v in tele.items() if k.split("/")[1] in COUNTERS), tele
    assert sorted(k for k in got if k not in tele) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    assert float(got["grad_norm"]) > 0


def test_plane_ts_step_student_gradients(ts_steps):
    """Each gradient within 1e-3 of its module's largest. A conv bias right
    before train-mode BatchNorm has a true gradient of 0, and what each
    engine computes for it is float32 rounding of sums whose terms scale
    with the step's largest gradient (~3e7 on this ill-conditioned tiny
    step), so every tensor also gets 1e-12 of that largest gradient."""
    got, want = ts_steps["plane"]["grads"], ts_steps["gather"]["grads"]
    assert sorted(got) == sorted(want)
    scale = {}
    for name, g in want.items():
        module = name.rsplit(".", 1)[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(g).max()))
    floor = 1e-12 * max(scale.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=1e-3 * scale[name.rsplit(".", 1)[0]] + floor,
                                   err_msg=name)
    for name in ("backbone.conv_input.conv_0_weight", "backbone.conv2_down.conv_weight",
                 "backbone.conv2_0.conv1_weight", "backbone.conv4_1.conv2_weight",
                 "backbone.extra_conv.conv_weight"):
        assert np.abs(got[name]).max() > 0, name


def test_plane_ts_step_batchnorm_statistics(ts_steps):
    _compare_stats(ts_steps["plane"]["stats"], ts_steps["gather"]["stats"])
