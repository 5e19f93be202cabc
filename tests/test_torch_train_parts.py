"""The training slice's parts against JAX on the same numpy inputs: the
training batch (targets and distillation streams, bit-exact), the CenterNet
losses, ``center_head_loss``, the PCR targets and losses, the PCR
generators in training (against the reference's z-folded outputs,
unfolded: channel d*C + c), the window-engine backbone in training with
every stage dense, and the optimizer against optax over 10 one-cycle
steps. float32; tolerances per test.

Split off into files of at most 4 tests (the suite's scheduler hands out files
with more first, ahead of the two long JAX files): the PCR targets and losses,
the all-dense backbone and the optimizer, ``tests/test_torch_train_pcr.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sparse2dense_tpu.models.heads import center_head as jhead
from sparse2dense_tpu.models.losses import centernet as jloss
from sparse2dense_tpu.models.necks import s2d_rpn as js2d
from sparse2dense_tpu.training.synthetic import make_batch as jax_make_batch
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.convert import from_flax
from sparse2dense_tpu_torch.models.heads import center_head as thead
from sparse2dense_tpu_torch.models.losses import centernet as tloss
from sparse2dense_tpu_torch.models.necks import s2d_rpn as ts2d
from sparse2dense_tpu_torch.training.synthetic import make_batch
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_layers import eager_cache_fixture, flax_shapes, load, rand_variables

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached

CFG = "configs/tests/distill_tiny.py"
FRAME = dict(max_voxels=256, n_points=1500, n_obj=5, seed=3)
REL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def batches():
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    return (jax_make_batch(jcfg, 2, distillation=True, **FRAME),
            make_batch(tcfg, 2, device="cpu", with_targets=True, distillation=True, **FRAME))


def t(x):
    return torch.from_numpy(np.array(x))


def test_make_batch_bit_exact(batches):
    jb, tb = batches
    assert sorted(jb) == sorted(tb)
    for key, want in jb.items():
        for w, g in zip(want, tb[key]) if isinstance(want, list) else [(want, tb[key])]:
            w = np.asarray(w)
            assert g.dtype == t(w).dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    assert np.asarray(jb["mask"][0]).sum(1).min() > 0     # both samples have objects
    assert np.asarray(jb["hm"][0]).shape == (2, 4, 4, 3)


def _maps(rng, b, h, w, c):
    return rng.randn(b, h, w, c).astype(np.float32)


def test_centernet_losses(batches):
    jb, _ = batches
    rng = np.random.RandomState(0)
    ind, mask, cat = (np.asarray(jb[k][0]) for k in ("ind", "mask", "cat"))
    out = 1 / (1 + np.exp(-_maps(rng, 2, 4, 4, 3)))
    target = np.asarray(jb["hm"][0])
    want = jloss.fast_focal_loss(jnp.asarray(out), jnp.asarray(target), ind, mask, cat)
    got = tloss.fast_focal_loss(t(out), t(target), t(ind), t(mask), t(cat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REL)
    no_obj = np.zeros_like(mask)   # the num_pos == 0 branch
    np.testing.assert_allclose(
        tloss.fast_focal_loss(t(out), t(target), t(ind), t(no_obj), t(cat)).numpy(),
        np.asarray(jloss.fast_focal_loss(jnp.asarray(out), jnp.asarray(target), ind, no_obj,
                                         cat)), **REL)
    reg = _maps(rng, 2, 4, 4, 8)
    box = np.asarray(jb["anno_box"][0])[..., :8]
    np.testing.assert_allclose(tloss.reg_loss(t(reg), t(mask), t(ind), t(box)).numpy(),
                               np.asarray(jloss.reg_loss(jnp.asarray(reg), mask, ind, box)),
                               **REL)


def test_center_head_loss(batches):
    jb, tb = batches
    rng = np.random.RandomState(1)
    preds = [{k: _maps(rng, 2, 4, 4, c) for k, c in
              (("hm", 3), ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2))}]
    kw = dict(weight=2.0, code_weights=(1.0, 0.5, 1.0, 2.0, 1.0, 1.0, 0.25, 1.0))
    want, wlogs = jhead.center_head_loss([{k: jnp.asarray(v) for k, v in preds[0].items()}], jb,
                                         **kw)
    got, logs = thead.center_head_loss([{k: t(v) for k, v in preds[0].items()}], tb, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **REL)
    assert sorted(logs) == sorted(wlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].numpy(), np.asarray(wlogs[k]), **REL, err_msg=k)


NECK = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2), ds_num_filters=(16, 16),
            us_layer_strides=(1, 2), us_num_filters=(16, 16), num_input_features=24)


def test_s2d_rpn_train_pcr_generators():
    """Training forward of S2D_RPN (PCR generators in 5D) against the
    reference's folded generators, unfolded; and the BN statistics."""
    x = np.random.RandomState(5).randn(2, 8, 8, 24).astype(np.float32)
    jm, tm = js2d.S2D_RPN(**NECK), ts2d.S2D_RPN(**NECK)
    v = rand_variables(flax_shapes(tm))   # a train-mode tree: the PCR generators too
    tm = load(tm, v).train()
    want, mutated = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        got = tm(t(x))
    assert got[1].shape == (2, 3, 20, 32, 32) and got[4].shape == (2, 1, 10, 16, 16)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if g.dim() == 5:   # folded (B, H, W, D*C) -> (B, C, D, H, W)
            b, c, d, h, ww = g.shape
            w = np.transpose(w.reshape(b, h, ww, d, c), (0, 4, 3, 1, 2))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=str(i))
    stats = from_flax({"batch_stats": mutated["batch_stats"]}, tm)
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), **REL, err_msg=k)


