"""The checkpoint hook's schedule against the reference's at three intervals."""
import pytest

from sparse2dense_tpu.training import hooks as jhooks
from sparse2dense_tpu_torch.training import hooks as thooks

from tests.test_torch_train_runtime import _Recorder


@pytest.mark.parametrize("checkpoint_config", [dict(interval=1), dict(interval=2),
                                               dict(interval=2, iter_interval=3)])
def test_checkpoint_schedule_against_jax(checkpoint_config):
    saves = []
    for mod in (jhooks, thooks):
        hooks = [h for h in mod.build_hooks(None, checkpoint_config, work_dir="out")
                 if type(h).__name__ == "CheckpointHook"]
        trainer = _Recorder()
        for _ in range(5):
            for i in range(4):
                trainer.inner_iter = i
                for h in hooks:
                    h.after_train_iter(trainer)
                trainer.global_iter += 1
            for h in hooks:
                h.after_train_epoch(trainer)
            trainer.epoch += 1
        saves.append(trainer.saves)
    assert saves[0] == saves[1] and saves[1]
