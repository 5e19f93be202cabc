"""``ShardedSampler``'s indices equal to the reference's over shards, epochs
and both ``drop_last`` settings."""
import numpy as np

from sparse2dense_tpu.data import loader as jloader
from sparse2dense_tpu_torch.data import loader as tloader

from tests.test_torch_data import assert_same


def test_sharded_sampler_indices_equal():
    for drop_last in (True, False):
        for shard in range(3):
            kw = dict(shuffle=True, seed=7, num_shards=3, shard_id=shard, drop_last=drop_last)
            got, want = tloader.ShardedSampler(10, **kw), jloader.ShardedSampler(10, **kw)
            for epoch in range(2):
                assert_same(got.epoch_indices(epoch), want.epoch_indices(epoch),
                            f"shard {shard} epoch {epoch}")
    assert_same(tloader.ShardedSampler(5, shuffle=False).epoch_indices(3), np.arange(5))
