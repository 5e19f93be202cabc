"""The neck's layers against the reference's (``tests/test_torch_layers.py``'s
variables): conv-BN-GELU, its transposed form, the ConvNeXt block and the
RPN."""
import numpy as np
import pytest
import torch

import jax

from sparse2dense_tpu.models.necks import rpn as jrpn
from sparse2dense_tpu.models.necks import s2d_rpn as js2d
from sparse2dense_tpu_torch.models.necks import rpn as trpn
from sparse2dense_tpu_torch.models.necks import s2d_rpn as ts2d

from tests.test_torch_layers import TOL, load, nchw, nhwc, rand_variables


@pytest.mark.parametrize("kind", ["conv_bn_gelu", "convt_bn_gelu", "convnext", "rpn"])
def test_neck_layers(kind):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 8, 8, 6).astype(np.float32)
    if kind == "conv_bn_gelu":
        jm, tm = js2d.ConvBNGelu(5, kernel=2, stride=2, padding=0), \
            ts2d.ConvBNGelu(6, 5, kernel=2, stride=2, padding=0)
    elif kind == "convt_bn_gelu":
        jm, tm = js2d.ConvTBNGelu(5), ts2d.ConvTBNGelu(6, 5)
    elif kind == "convnext":
        jm, tm = js2d.ConvNeXtBlock(6), ts2d.ConvNeXtBlock(6)
    else:
        cfg = dict(layer_nums=(1, 1), ds_layer_strides=(1, 2), ds_num_filters=(8, 8),
                   us_layer_strides=(1, 2), us_num_filters=(8, 8), num_input_features=6)
        jm, tm = jrpn.RPN(**cfg), trpn.RPN(**cfg)
    args = () if kind == "convnext" else (False,)
    v = rand_variables(lambda: jm.init(jax.random.PRNGKey(0), x, *args))
    tm = load(tm, v)
    want = np.asarray(jm.apply(v, x, *args))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy() if kind == "rpn" else nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
