"""The port's config loader reads the tiny distillation config as the JAX
package's loader does (moved from ``tests/test_torch_detector.py``)."""
from sparse2dense_tpu.utils import Config
from sparse2dense_tpu_torch.utils.config import ConfigDict

from tests.test_torch_detector import CFG


def test_config_loader_reads_the_reference_config():
    jcfg, tcfg = Config.fromfile(CFG), ConfigDict.fromfile(CFG)
    for key in ("S_model", "test_cfg", "voxel_generator", "class_names"):
        assert tcfg[key] == jcfg[key], key
