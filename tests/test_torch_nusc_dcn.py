"""The nuScenes heads' operators against JAX: the deformable conv
(``models/dcn.py``), the double-flip merge and circle NMS.

The offset convs get non-zero weights, so offsets reach a few cells and
part of the samples fall outside the map (with zero offsets a deformable
conv is a plain conv and proves nothing). JAX runs eagerly here: its
deformable conv unrolls one gather a tap, group and corner, which XLA
takes ~12 CPU-s to compile for one head and ~60 for a vjp, against a few
op by op. Tolerances: forward maps 1e-5 (float32 sums in another order:
the port contracts all taps in one product, JAX one tap at a time); the
vjp 1e-5 of each gradient's largest value; the merge 1e-6 (a mean of
four); NMS selections equal."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from sparse2dense_tpu.models import dcn as jdcn
from sparse2dense_tpu.models.heads.center_head import merge_double_flip as j_merge
from sparse2dense_tpu.ops.nms import circle_nms as j_circle_nms
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models import dcn as tdcn
from sparse2dense_tpu_torch.models.heads.center_head import merge_double_flip
from sparse2dense_tpu_torch.ops.nms import circle_nms

from tests.test_double_flip import _make_variants
from tests.test_torch_layers import eager_cache_fixture, flax_shapes, rand_variables

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = (("dim", (3, 2)), ("height", (1, 2)), ("hm", (2, 2)), ("reg", (2, 2)),
         ("rot", (2, 2)), ("vel", (2, 2)))
OFFSET_GAIN = 2.0   # the offset convs' weights times this: offsets of ~2 cells


def _offsets_outside(x_hw, off):
    """The share of (pixel, group, tap) samples whose position falls off the
    map."""
    b, h, w, c = off.shape
    o = off.reshape(b, h, w, -1, 9, 2)
    r = np.arange(3) - 1
    ys = np.arange(h)[None, :, None, None, None] + np.repeat(r, 3) + o[..., 0]
    xs = np.arange(w)[None, None, :, None, None] + np.tile(r, 3) + o[..., 1]
    out = (ys < 0) | (ys > x_hw[0] - 1) | (xs < 0) | (xs > x_hw[1] - 1)
    return out.mean()


def test_deform_conv_forward_and_vjp_against_jax():
    """DeformConv at one group, offsets of ~2 cells: forward and vjp (d
    input, d offsets, d weights). Four groups run in every DCN head of
    ``tests/test_torch_nusc_model.py``."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 16).astype(np.float32)
    off = (2.0 * rng.randn(2, 5, 6, 18)).astype(np.float32)
    assert 0.1 < _offsets_outside((5, 6), off) < 0.9
    tm = tdcn.DeformConv(16, 8, 3, 1)
    v = rand_variables(flax_shapes(tm), seed=1)
    tm.load_state_dict(from_flax(v, tm))
    jm = jdcn.DeformConv(8, 3, 1)
    xt, ot = (torch.from_numpy(a).requires_grad_() for a in (x, off))
    got = tm(xt, ot)
    want, vjp = jax.vjp(lambda p, a, o: jm.apply({"params": p}, a, o), v["params"], x, off)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    ct = rng.randn(*got.shape).astype(np.float32)
    got.backward(torch.from_numpy(ct))
    jw, jx, jo = vjp(ct)
    wt = from_flax({"params": jw}, tm)["weight"].numpy()
    for name, g, w in (("x", xt.grad.numpy(), jx), ("offset", ot.grad.numpy(), jo),
                       ("weight", tm.weight.grad.numpy(), wt)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
        assert np.abs(w).max() > 0, name


def test_feature_adaption_and_the_dcn_head_tree():
    """FeatureAdaption (offset conv, DCN at 4 groups, ReLU) in eval mode;
    the reference's DCNSepHead variables (``jax.eval_shape`` of its init)
    land on the port's ``state_dict`` through ``from_flax``, every entry,
    nothing left over, the deformable kernels (taps, Cin, Cout) as (Cout,
    Cin, taps). The head's maps and BN statistics in eval and train mode:
    ``tests/test_torch_nusc_model.py``, six of them."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 16).astype(np.float32)
    fa = tdcn.FeatureAdaption(16, 16)
    v = rand_variables(flax_shapes(fa), seed=2)
    v["params"]["conv_offset"]["kernel"] *= OFFSET_GAIN
    fa.load_state_dict(from_flax(v, fa))
    off = np.asarray(jax.lax.conv_general_dilated(
        x, v["params"]["conv_offset"]["kernel"], (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + v["params"]["conv_offset"]["bias"])
    assert 0.1 < _offsets_outside((5, 6), off) < 0.9
    with torch.no_grad():
        got = fa(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdcn.FeatureAdaption(16).apply(v, x)), **TOL)

    tm = tdcn.DCNSepHead(16, dict(HEADS), 2)
    jm = jdcn.DCNSepHead(heads=HEADS, num_cls=2, in_channels=16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 5, 6, 16)), False))
    v = rand_variables(shapes, seed=4)
    state = from_flax(v, tm)
    assert set(state) == set(tm.state_dict())
    k = v["params"]["feature_adapt_reg"]["conv_adaption"]["kernel"]
    assert k.shape == (9, 16, 16)
    np.testing.assert_array_equal(state["feature_adapt_reg.conv_adaption.weight"].numpy(),
                                  np.transpose(k, (2, 1, 0)))
    tm.load_state_dict(state)


def test_merge_double_flip_and_circle_nms_against_jax():
    """The merge on random maps (with and without vel) and on the
    equivariant variants of ``tests/test_double_flip.py`` (which it must
    undo); circle NMS on clustered centres, padded entries at -inf."""
    rng = np.random.RandomState(2)
    maps = {k: rng.randn(8, 6, 7, c).astype(np.float32)
            for k, c in (("hm", 3), ("height", 1), ("dim", 3), ("reg", 2), ("rot", 2),
                         ("vel", 2))}
    base, stacked = _make_variants(rng)
    for pd in (maps, {k: v for k, v in maps.items() if k != "vel"},
               {k: np.asarray(v) for k, v in stacked.items()}):
        want = jax.jit(j_merge)({k: jnp.asarray(v) for k, v in pd.items()})
        got = merge_double_flip({k: torch.from_numpy(v) for k, v in pd.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    for k in base:
        np.testing.assert_allclose(got[k].numpy()[0], base[k][0], rtol=1e-5, atol=1e-5)

    k = 200
    centers = np.concatenate([rng.uniform(-20, 20, (k // 2, 2)),
                              rng.normal(0, 1.5, (k // 2, 2))]).astype(np.float32)
    scores = rng.rand(k).astype(np.float32)
    scores[rng.rand(k) < 0.15] = -np.inf
    radius = 4.0
    d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    assert np.abs(d2 - radius ** 2).min() > 1e-4   # no pair at the threshold
    want = np.asarray(j_circle_nms(jnp.asarray(centers), jnp.asarray(scores), radius, 83))
    got = circle_nms(torch.from_numpy(centers), torch.from_numpy(scores), radius, 83)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 10 < (want >= 0).sum() < 60
