"""Lazy cached-embedding dataset for fusion scoring.

Port of the scoring half of ``interspeech_ser_tpu/train/data.py``: each
sample is one ``<utt>.pt`` feature file per modality (``lazy_dir{1,2,3}``)
plus a one-hot label row. ``collate`` pads a batch to a bucketed time length
with per-frame masks; files load on a thread pool.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import threading
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..utils import ptio


def bucket_length(t: int, quantum: int = 64, minimum: int = 64) -> int:
    """Round ``t`` up to the bucket grid."""
    return max(minimum, ((t + quantum - 1) // quantum) * quantum)


@dataclass
class Batch:
    """feats: per modality [B, T_m, D_m] f32; masks: per modality [B, T_m]
    (all zero in padding rows)."""

    feats: List[np.ndarray]
    masks: List[np.ndarray]


class LazyFeatureDataset:
    def __init__(
        self,
        utt_names: Sequence[str],
        labels: np.ndarray,
        lazy_dirs: Sequence[str],
        feat_dims: Sequence[int],
        num_workers: int = 8,
    ):
        assert len(utt_names) == len(labels)
        self.utt_names = list(utt_names)
        self.labels = np.asarray(labels, dtype=np.float32)
        self.lazy_dirs = list(lazy_dirs)
        self.feat_dims = list(feat_dims)
        self.num_workers = num_workers
        self._verbose_once = True
        self._echo_lock = threading.Lock()

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
        for row, fs in enumerate(per_sample):
            for m in range(n_mod):
                t = fs[m].shape[0]
                feats[m][row, :t] = fs[m]
                masks[m][row, :t] = 1.0
        return Batch(feats, masks)

    def primary_lengths(self) -> np.ndarray:
        """Per-utterance length proxy for sorting: the primary modality's
        ``.pt`` file size (monotone in T at a fixed D)."""
        sizes = np.zeros(len(self), dtype=np.int64)
        for i in range(len(self)):
            try:
                sizes[i] = os.path.getsize(self.paths(i)[0])
            except OSError:
                sizes[i] = 0
        return sizes
