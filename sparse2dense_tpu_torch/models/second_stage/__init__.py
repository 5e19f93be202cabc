"""The second-stage feature extractors (counterpart of ``sparse2dense_tpu/models/second_stage``)."""
