"""The hooks the trainer builds from a config and the parameter merge of
``--load_from``, against the reference's."""
import logging

import numpy as np
import pytest
import torch

from sparse2dense_tpu.training import checkpoint as jckpt
from sparse2dense_tpu.training import hooks as jhooks
from sparse2dense_tpu_torch.training import checkpoint as tckpt
from sparse2dense_tpu_torch.training import hooks as thooks

from tests.test_torch_train_runtime import HOOK_CONFIGS, _flat, _hook_list


@pytest.mark.parametrize("log_config,checkpoint_config", HOOK_CONFIGS)
def test_build_hooks_against_jax(log_config, checkpoint_config):
    want = _hook_list(jhooks.build_hooks(log_config, checkpoint_config, work_dir="w"))
    assert _hook_list(thooks.build_hooks(log_config, checkpoint_config, work_dir="w")) == want


def test_merge_params_against_jax(caplog):
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    target = {"conv": {"weight": arr(4, 3), "bias": arr(4)}, "bn": {"mean": arr(4), "var": arr(4)},
              "head": {"weight": arr(2, 4)}}
    restored = {"conv": {"weight": arr(4, 3), "bias": arr(5)}, "bn": {"mean": arr(4)},
                "head": {"weight": arr(2, 4)}, "extra": {"weight": arr(3)}}
    with caplog.at_level(logging.WARNING):
        want = _flat(jckpt.merge_params(target, restored, logging.getLogger("jax_side")))
        got = tckpt.merge_params(
            {k: torch.from_numpy(v) for k, v in _flat(target).items()},
            {k: torch.from_numpy(v) for k, v in _flat(restored).items()},
            logging.getLogger("port_side"))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(value), err_msg=name)
    messages = {r.name: r.getMessage() for r in caplog.records}
    assert messages["port_side"] == messages["jax_side"] == (
        "checkpoint merge: 1 missing, 1 shape-mismatched keys")
