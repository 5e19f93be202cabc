"""``WindowPass`` on a plan without a reader table builds one, and its gradient
equals the one with the table."""
import numpy as np
import torch

from sparse2dense_tpu_torch.ops import window_conv as TWC
from sparse2dense_tpu_torch.ops.window_kernel import WindowPass

from tests.test_torch_window_grad import CASES, _case


def test_plan_without_a_table_builds_one():
    jf, jp, tf, tp, w, cot = _case(*CASES[0])
    f = tf.clone().requires_grad_(True)
    wd = TWC.taps_zyx_to_dyx(torch.from_numpy(w))
    assert tp.readers is None
    (WindowPass.apply(f, wd, tp, (3, 3, 3)) * torch.from_numpy(cot)).sum().backward()
    g_with = f.grad.clone()
    f.grad = None
    (WindowPass.apply(f, wd, TWC.with_readers(tp), (3, 3, 3)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), g_with.numpy())
