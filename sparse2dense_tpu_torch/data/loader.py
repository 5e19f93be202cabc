"""The input pipeline: dataset -> static-shape batches on the device. The
port's copy of ``sparse2dense_tpu/data/loader.py`` (det3d's collate_kitti,
DistributedSampler and DataLoader stack):

- :func:`collate`: ragged per-frame dicts -> fixed (B, max_voxels, ...)
  arrays with -1 coordinates past a frame's voxels, the layout every port
  model consumes (det3d concatenates the rows and prepends a batch column);
  a double-flip frame's list of 4 bundles becomes 4 consecutive rows, so a
  batch of B frames holds 4B views in groups [orig, yflip, xflip, double];
- :class:`ShardedSampler`: an epoch-seeded permutation, shard k of n taking
  indices k::n (DistributedSampler's semantics);
- :class:`InputPipeline`: a ``torch.utils.data.DataLoader`` whose batch
  sampler yields the epoch's batches of (seed, epoch, index) keys, with
  ``collate`` (as tensors) as its ``collate_fn`` and ``num_workers`` spawned,
  persistent worker processes (det3d's workers_per_gpu) into pinned memory;
  the batches go to the device in the main process. A sample's draws come from its key
  (``datasets.waymo.sample_rng``), so a batch does not depend on the number
  of workers.
"""
from __future__ import annotations

import functools
from typing import Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from ..device import resolve_device

VOXEL_STREAM_PREFIXES = ("", "dense_", "reconstruction_")
VOXEL_STREAM_TAGS = ("", "_2", "_4")


def _pad_rows(a: np.ndarray, n: int, fill=0):
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    m = min(len(a), n)
    out[:m] = a[:m]
    return out


def _voxel_keys(example):
    keys = []
    for prefix in VOXEL_STREAM_PREFIXES:
        for tag in VOXEL_STREAM_TAGS if prefix == "reconstruction_" else ("",):
            if f"{prefix}voxels{tag}" in example:
                keys.append((f"{prefix}voxels{tag}", f"{prefix}coordinates{tag}",
                             f"{prefix}num_points{tag}"))
    return keys


def collate(examples, max_voxels: int):
    """Per-frame dicts (or double-flip lists of 4) -> one static-shape batch
    dict of NumPy arrays (the targets as per-task lists) and "metadata", the
    rows' metadata."""
    examples = [b for e in examples for b in (e if isinstance(e, list) else [e])]
    batch = {}
    ex0 = examples[0]
    for vk, ck, nk in _voxel_keys(ex0):
        batch[vk] = np.stack([_pad_rows(e[vk], max_voxels) for e in examples])
        batch[ck] = np.stack([_pad_rows(e[ck].astype(np.int32), max_voxels, fill=-1)
                              for e in examples])
        batch[nk] = np.stack([_pad_rows(e[nk].astype(np.int32), max_voxels) for e in examples])
    for key in ("hm", "anno_box", "ind", "mask", "cat", "labels", "reg_targets", "reg_weights",
                "anchors"):
        if key in ex0:
            batch[key] = [np.stack([np.asarray(e[key][t]) for e in examples])
                          for t in range(len(ex0[key]))]
            if key in ("ind", "cat", "labels"):
                batch[key] = [x.astype(np.int32) for x in batch[key]]
    if "gt_boxes_and_cls" in ex0:
        batch["gt_boxes_and_cls"] = np.stack([e["gt_boxes_and_cls"] for e in examples])
    batch["metadata"] = [e.get("metadata") for e in examples]
    return batch


class ShardedSampler:
    """An epoch's indices: a permutation seeded by ``seed + epoch`` (or the
    identity), shard ``shard_id`` of ``num_shards`` taking every
    ``num_shards``-th, cut (``drop_last``) or wrapped to equal length."""

    def __init__(self, n: int, shuffle=True, seed=0, num_shards=1, shard_id=0,
                 drop_last=True):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.drop_last = drop_last

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(self.n)
        else:
            idx = np.arange(self.n)
        if self.drop_last:
            per_shard = self.n // self.num_shards
        else:   # pad by wrapping
            per_shard = -(-self.n // self.num_shards)
            idx = np.concatenate([idx, idx[:per_shard * self.num_shards - self.n]])
        return idx[self.shard_id::self.num_shards][:per_shard]


class EpochBatchSampler(Sampler):
    """The batches of one epoch's indices as (seed, epoch, index) keys;
    ``set_epoch`` picks the epoch (the partial last batch is dropped)."""

    def __init__(self, sampler: ShardedSampler, batch_size: int, seed: int):
        self.sampler, self.batch_size, self.seed = sampler, batch_size, seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.sampler.epoch_indices(self.epoch)) // self.batch_size

    def __iter__(self):
        idx = self.sampler.epoch_indices(self.epoch)
        for b in range(len(idx) // self.batch_size):
            yield [(self.seed, self.epoch, int(i))
                   for i in idx[b * self.batch_size:(b + 1) * self.batch_size]]


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of :func:`collate_tensors` on ``device`` ("metadata" stays on
    the host)."""
    def put(t):
        return t.to(device, non_blocking=t.is_pinned())

    return {k: v if k == "metadata" else [put(x) for x in v] if isinstance(v, list) else put(v)
            for k, v in batch.items()}


def collate_tensors(examples, max_voxels: int) -> dict:
    """:func:`collate` with its arrays as CPU tensors (shared memory, no
    copy), which the loader can pin."""
    return {k: v if k == "metadata" else
            [torch.from_numpy(x) for x in v] if isinstance(v, list) else torch.from_numpy(v)
            for k, v in collate(examples, max_voxels).items()}


class InputPipeline:
    """Iterable over an epoch's batches on ``device`` (CUDA unless given).
    Under data parallelism each process takes shard ``shard_id`` of
    ``num_shards`` (its rank of the world); ``drop_last`` cuts the shards to
    equal length (training, as the JAX pipeline), else they wrap (the val
    set: every frame is seen, the duplicates go at the merge). A sample is
    the same whichever rank draws it: its draws come from its (seed, epoch,
    index) key."""

    def __init__(self, dataset, batch_size: int, max_voxels: int, shuffle=True, seed=0,
                 num_workers: int = 0, device=None, num_shards: int = 1, shard_id: int = 0,
                 drop_last: bool = True):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_sampler = EpochBatchSampler(
            ShardedSampler(len(dataset), shuffle=shuffle, seed=seed, num_shards=num_shards,
                           shard_id=shard_id, drop_last=drop_last), batch_size, seed)
        pin = self.device.type == "cuda"
        self.loader = DataLoader(
            dataset, batch_sampler=self.batch_sampler, num_workers=num_workers,
            collate_fn=functools.partial(collate_tensors, max_voxels=max_voxels),
            pin_memory=pin, persistent_workers=num_workers > 0,
            multiprocessing_context="spawn" if num_workers > 0 else None)

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int) -> None:
        self.batch_sampler.set_epoch(epoch)

    def __iter__(self) -> Iterator[dict]:
        for batch in self.loader:
            yield to_device(batch, self.device)


def build_dataset(cfg):
    """A dataset from the reference's schema (``data.train``, ``val`` or
    ``test``): ``WaymoDataset`` or ``NuScenesDataset`` with its pipeline."""
    from .datasets.nuscenes import NuScenesDataset
    from .datasets.waymo import WaymoDataset
    from .pipelines.formating import build_pipeline

    cfg = dict(cfg)
    kind = cfg.pop("type")
    registry = {"WaymoDataset": WaymoDataset, "NuScenesDataset": NuScenesDataset}
    if kind not in registry:
        raise NotImplementedError(kind)
    pipeline = build_pipeline(cfg.pop("pipeline"))
    cfg.pop("ann_file", None)
    return registry[kind](pipeline=pipeline, **cfg)
