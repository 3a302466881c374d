"""Lazy cached-embedding data pipeline for fusion training and scoring.

Port of ``interspeech_ser_tpu/train/data.py``: each sample is one
``<utt>.pt`` feature file per modality (``lazy_dir{1,2,3}``) plus a label
row (one-hot classes, or the dimensional task's attributes) and, for the
legacy gender trainers, an auxiliary integer target. ``collate`` pads a batch to a bucketed time length and a fixed
batch size, with per-frame masks and a per-row ``sample_mask``; files load
on a thread pool. ``epoch_batches`` makes the same numpy ``Generator`` calls
in the same order as the JAX package's, so one seed draws the same batches
in both; ``PrefetchLoader`` collates the next batches on a thread while the
card computes.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import sys
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..utils import ptio


def bucket_length(t: int, quantum: int = 64, minimum: int = 64) -> int:
    """Round ``t`` up to the bucket grid."""
    return max(minimum, ((t + quantum - 1) // quantum) * quantum)


@dataclass
class Batch:
    """feats: per modality [B, T_m, D_m] f32; masks: per modality [B, T_m]
    (all zero in padding rows); labels: [B, C] one-hot rows (zero in padding
    rows); sample_mask: [B], 0 for the padding rows that fill the batch;
    aux: [B] auxiliary targets (the gender trainers'), 0 in padding rows, or
    None."""

    feats: List[np.ndarray]
    masks: List[np.ndarray]
    labels: np.ndarray
    sample_mask: np.ndarray
    aux: Optional[np.ndarray] = None


class LazyFeatureDataset:
    def __init__(
        self,
        utt_names: Sequence[str],
        labels: np.ndarray,
        lazy_dirs: Sequence[str],
        feat_dims: Sequence[int],
        num_workers: int = 8,
        aux_labels: Optional[np.ndarray] = None,
    ):
        assert len(utt_names) == len(labels)
        self.utt_names = list(utt_names)
        self.labels = np.asarray(labels, dtype=np.float32)
        self.aux_labels = None if aux_labels is None else np.asarray(aux_labels)
        self.lazy_dirs = list(lazy_dirs)
        self.feat_dims = list(feat_dims)
        self.num_workers = num_workers
        self._verbose_once = True
        self._echo_lock = threading.Lock()
        self._primary_lengths: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.utt_names)

    def paths(self, idx: int) -> List[str]:
        stem = self.utt_names[idx].replace(".wav", ".pt")
        return [os.path.join(d, stem) for d in self.lazy_dirs]

    def load_features(self, idx: int) -> List[np.ndarray]:
        paths = self.paths(idx)
        if self._verbose_once:
            # first-sample echo, as the reference prints; one atomic write
            with self._echo_lock:
                emit, self._verbose_once = self._verbose_once, False
            if emit:
                sys.stdout.write(" ".join(paths) + "\n")
        feats = []
        for p, d in zip(paths, self.feat_dims):
            arr = np.asarray(ptio.load_tensor(p), dtype=np.float32)
            if arr.ndim == 1:
                arr = arr[None, :]
            assert arr.shape[-1] == d, f"{p}: feat dim {arr.shape[-1]} != {d}"
            feats.append(arr)
        return feats

    def collate(self, indices: Sequence[int], batch_size: int, quantum: int = 64) -> Batch:
        """Load and pad ``indices`` into a batch of ``batch_size`` rows."""
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            per_sample = list(pool.map(self.load_features, indices))
        n_mod = len(self.lazy_dirs)
        B = batch_size
        t_max = [bucket_length(max(f[m].shape[0] for f in per_sample), quantum) for m in range(n_mod)]
        feats = [np.zeros((B, t_max[m], self.feat_dims[m]), np.float32) for m in range(n_mod)]
        masks = [np.zeros((B, t_max[m]), np.float32) for m in range(n_mod)]
        labels = np.zeros((B, self.labels.shape[1]), np.float32)
        sample_mask = np.zeros((B,), np.float32)
        aux = None if self.aux_labels is None else np.zeros((B,), self.aux_labels.dtype)
        for row, (idx, fs) in enumerate(zip(indices, per_sample)):
            for m in range(n_mod):
                t = fs[m].shape[0]
                feats[m][row, :t] = fs[m]
                masks[m][row, :t] = 1.0
            labels[row] = self.labels[idx]
            sample_mask[row] = 1.0
            if aux is not None:
                aux[row] = self.aux_labels[idx]
        return Batch(feats, masks, labels, sample_mask, aux)

    def primary_lengths(self) -> np.ndarray:
        """Per-utterance length proxy for sorting: the primary modality's
        ``.pt`` file size (monotone in T at a fixed D), read once."""
        if self._primary_lengths is None:
            sizes = np.zeros(len(self), dtype=np.int64)
            for i in range(len(self)):
                try:
                    sizes[i] = os.path.getsize(self.paths(i)[0])
                except OSError:
                    sizes[i] = 0
            self._primary_lengths = sizes
        return self._primary_lengths


def weighted_sample_indices(weights: np.ndarray, num_samples: int, rng: np.random.Generator) -> np.ndarray:
    """torch ``WeightedRandomSampler(replacement=True)`` semantics."""
    p = np.asarray(weights, dtype=np.float64)
    p = p / p.sum()
    return rng.choice(len(p), size=num_samples, replace=True, p=p)


def epoch_batches(
    dataset: LazyFeatureDataset,
    batch_size: int,
    rng: np.random.Generator,
    sample_weights: Optional[np.ndarray] = None,
    bucket_window: int = 8,
) -> List[List[int]]:
    """Index batches for one epoch: the reference sampler's order (a
    permutation, or weighted with replacement), then within each window of
    ``bucket_window`` batches the samples sorted by length, so a batch's
    lengths cluster while the global order stays random (1 = no sorting)."""
    n = len(dataset)
    if sample_weights is not None:
        order = weighted_sample_indices(sample_weights, n, rng)
    else:
        order = rng.permutation(n)
    if bucket_window > 1:
        window = batch_size * bucket_window
        lengths = dataset.primary_lengths()
        chunks = [order[s : s + window] for s in range(0, n, window)]
        chunks = [c[np.argsort(lengths[c], kind="stable")] for c in chunks]
        order = np.concatenate(chunks) if chunks else order
    return [list(order[i : i + batch_size]) for i in range(0, n, batch_size)]


class PrefetchLoader:
    """Collate the batches on a background thread, two ahead."""

    def __init__(self, dataset: LazyFeatureDataset, batches: List[List[int]], batch_size: int, quantum: int = 64):
        self.dataset = dataset
        self.batches = batches
        self.batch_size = batch_size
        self.quantum = quantum
        self.queue: "queue.Queue" = queue.Queue(maxsize=2)
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _produce(self) -> None:
        try:
            for idxs in self.batches:
                self.queue.put(self.dataset.collate(idxs, self.batch_size, self.quantum))
            self.queue.put(None)
        except BaseException as e:  # handed to the consumer, which re-raises it
            self.queue.put(e)

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self) -> int:
        return len(self.batches)
