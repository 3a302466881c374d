"""Host batch samplers of the proto-angular trainers, in numpy.

Port of ``interspeech_ser_tpu/train/samplers.py`` (the reference's
``src/information_encoder/samplers.py``); they order indices only, so the
copy is line for line and one seed yields the same index lists in both
packages:

- ``SubsetSampler``: sequential over a fixed subset;
- ``PerfectBatchSampler``: class-balanced batches, an equal number of rows
  per class, class-major inside a batch (its PCG64 draws: one permutation a
  class, then one shuffle of the classes); ``num_shards`` is kept for the
  signature (the port trains on one card);
- ``SortedSampler``: by length, descending;
- ``BucketBatchSampler``: shuffle, length-sorted buckets of
  ``bucket_size_multiplier x batch``, shuffled batch order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class SubsetSampler:
    def __init__(self, indices: Sequence[int]):
        self.indices = list(indices)

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class PerfectBatchSampler:
    """Equal samples per class in every batch.

    Args mirror the reference: ``dataset_items`` with class ids, the class
    set, ``batch_size`` (divisible by num_classes × num_shards),
    ``num_classes_in_batch``, drop_last semantics.
    """

    def __init__(
        self,
        labels: Sequence,
        classes: Sequence,
        batch_size: int,
        num_classes_in_batch: Optional[int] = None,
        num_shards: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
    ):
        classes = list(classes)
        n_cls = num_classes_in_batch or len(classes)
        assert batch_size % (n_cls * num_shards) == 0, (
            "batch size must be divisible by number of classes and shards"
        )
        self.labels = np.asarray(labels)
        self.classes = classes
        self.batch_size = batch_size
        self.num_classes_in_batch = n_cls
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.Generator(np.random.PCG64(seed))
        self._cls_indices: Dict = {
            c: np.flatnonzero(self.labels == c) for c in classes
        }

    def __iter__(self):
        per_class = self.batch_size // self.num_classes_in_batch
        pools = {}
        for c, idx in self._cls_indices.items():
            order = self.rng.permutation(idx) if self.shuffle else np.asarray(idx)
            pools[c] = list(order)
        classes = list(self.classes)
        if self.shuffle:
            self.rng.shuffle(classes)
        batches = []
        exhausted = False
        while not exhausted:
            batch = []
            for c in classes[: self.num_classes_in_batch]:
                if len(pools[c]) < per_class:
                    exhausted = True
                    break
                batch.extend(pools[c][:per_class])
                pools[c] = pools[c][per_class:]
            if not exhausted:
                batches.append(batch)
            elif batch and not self.drop_last:
                batches.append(batch)
        return iter(batches)

    def __len__(self):
        per_class = self.batch_size // self.num_classes_in_batch
        return min(
            len(idx) // per_class for idx in self._cls_indices.values()
        )


class SortedSampler:
    """Indices sorted by a key (length), descending."""

    def __init__(self, lengths: Sequence[float], descending: bool = True):
        order = np.argsort(np.asarray(lengths), kind="stable")
        self.order = order[::-1] if descending else order

    def __iter__(self):
        return iter(self.order.tolist())

    def __len__(self):
        return len(self.order)


class BucketBatchSampler:
    """Shuffle → sort inside buckets of ``batch×multiplier`` → shuffle batches."""

    def __init__(
        self,
        lengths: Sequence[float],
        batch_size: int,
        drop_last: bool = False,
        bucket_size_multiplier: int = 100,
        seed: int = 0,
    ):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.bucket_size = batch_size * bucket_size_multiplier
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __iter__(self):
        n = len(self.lengths)
        order = self.rng.permutation(n)
        batches: List[List[int]] = []
        for s in range(0, n, self.bucket_size):
            bucket = order[s : s + self.bucket_size]
            bucket = bucket[np.argsort(self.lengths[bucket], kind="stable")]
            for b in range(0, len(bucket), self.batch_size):
                chunk = bucket[b : b + self.batch_size].tolist()
                if len(chunk) == self.batch_size or not self.drop_last:
                    batches.append(chunk)
        self.rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        if self.drop_last:
            return len(self.lengths) // self.batch_size
        return -(-len(self.lengths) // self.batch_size)
