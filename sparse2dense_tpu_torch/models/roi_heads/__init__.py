"""The second-stage RoI heads (counterpart of ``sparse2dense_tpu/models/roi_heads``)."""
