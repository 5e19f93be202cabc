"""SECOND's anchor head (``models/heads/mg_head.py``) against the reference's
on ``configs/tests/second_tiny.py``'s batches
(``tests/test_torch_second.py``'s ``batches`` and ``head``): the anchor
targets, the forward, the loss and predict."""
import numpy as np

from sparse2dense_tpu.models.heads import mg_head as jmg
from sparse2dense_tpu_torch.models.heads import mg_head as tmg
from sparse2dense_tpu_torch.training.synthetic import make_batch

from tests.test_torch_layers import eager_cache_fixture
from tests.test_torch_second import FRAME, batches, head  # noqa: F401 (fixtures)

eager_cache = eager_cache_fixture()   # eager JAX references: op compiles cached


def test_make_batch_anchor_targets_bit_exact(batches):
    """``AssignTarget``'s anchors, labels and regression targets (and the
    voxel streams) equal the reference's."""
    jbatch, batch = batches["jbatch"], batches["batch"]
    assert sorted(jbatch) == sorted(batch)
    for key, want in jbatch.items():
        got = batch[key]
        for w, g in zip(want, got) if isinstance(want, list) else [(want, got)]:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, key
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
    labels = np.asarray(jbatch["labels"][0])
    assert (labels > 0).sum() > 0 and (labels == 0).sum() > 0
    # the anchors alone, in inference (no targets)
    plain = make_batch(batches["tcfg"], 2, device="cpu", **FRAME)
    np.testing.assert_array_equal(plain["anchors"][0].numpy(), np.asarray(jbatch["anchors"][0]))
    assert "labels" not in plain


def test_multigroup_head_forward(head):
    assert sorted(head["preds"][0]) == ["box_preds", "cls_preds", "dir_cls_preds"]
    for jp, tp in zip(head["jpreds"], head["preds"]):
        for k, v in jp.items():
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_mg_head_loss(head, batches):
    want_total, want = jmg.mg_head_loss(head["jhead"], head["jpreds"], batches["jbatch"])
    got_total, got = tmg.mg_head_loss(head["thead"], head["as_torch"], batches["batch"])
    assert sorted(got) == sorted(want) == ["cls_loss_0", "dir_loss_0", "loc_loss_0"]
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)


def test_mg_head_predict(head, batches):
    test_cfg = batches["jcfg"].test_cfg
    want = jmg.mg_head_predict(head["jhead"], head["jpreds"], batches["jbatch"], test_cfg)
    got = tmg.mg_head_predict(head["thead"], head["as_torch"], batches["batch"], test_cfg)
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["label_preds"].numpy(), np.asarray(want["label_preds"]))
    for k in ("box3d_lidar", "scores"):
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
