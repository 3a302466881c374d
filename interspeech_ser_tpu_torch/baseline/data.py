"""The challenge baseline's waveform data: loading, z-norm, batching.

Light copy of ``interspeech_ser_tpu/baseline/data.py`` over the port's
stdlib WAV decoder: parallel loading, the scalar mean / std over every
training sample and its pickle (``train_norm_stat.pkl``, a pickled ``(mean,
std)`` tuple, the reference's file), ``WavDataset`` (the 12-s cap and the
z-norm), ``collate_wav`` (lengths padded to whole 16000-sample quanta and a
fixed row count; padding rows carry ``sample_mask`` 0), the epoch order with
its length-sorted windows, the balanced sampler's weights, and the joint
RoBERTa + WavLM trainers' transcripts (``TxtDataset``, ``collate_txt_wav``).
The numpy draws are the JAX package's, so one seed gives both packages the
same batches.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.audio import load_wav


def load_audio(audio_path: str, utts: Sequence[str], num_workers: int = 24) -> List[np.ndarray]:
    """Decode ``audio_path/<utt>`` for each utterance, in order, at 16 kHz mono float32."""
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(lambda u: load_wav(os.path.join(audio_path, u))[0], utts))


def get_norm_stat_for_wav(wav_list: Sequence[np.ndarray]) -> Tuple[float, float]:
    """Scalar mean and std over all samples of all waveforms (sums in float64)."""
    count, wav_sum, wav_sqsum = 0, 0.0, 0.0
    for w in wav_list:
        wav_sum += float(np.sum(w))
        wav_sqsum += float(np.sum(np.square(w, dtype=np.float64)))
        count += len(w)
    mean = wav_sum / count
    var = wav_sqsum / count - mean ** 2
    return mean, float(np.sqrt(var))


def save_norm_stat(path: str, wav_mean: float, wav_std: float) -> None:
    with open(path, "wb") as f:
        pickle.dump((wav_mean, wav_std), f)


def load_norm_stat(path: str) -> Tuple[float, float]:
    """A ``train_norm_stat.pkl`` written by either package or the reference.
    It is unpickled: read only files a training run wrote."""
    with open(path, "rb") as f:
        mean, std = pickle.load(f)
    return float(mean), float(std)


MAX_SAMPLES = 12 * 16000  # the reference's cap: 12 s at 16 kHz
QUANTUM = 16000  # batches pad their length to whole seconds
BUCKET_WINDOW = 8  # an epoch's order is length-sorted within windows of this many batches


class WavDataset:
    """Waveforms cut to ``min(longest, 12 s)`` and z-normalised with the
    training set's mean and std (computed here when not given; the norm is
    skipped with ``normalize_wav=False``, the stats still computed).
    ``augment_fn``, when set, transforms a cut waveform before the norm."""

    def __init__(
        self,
        wav_list: Sequence[np.ndarray],
        labels: Optional[np.ndarray] = None,
        utts: Optional[Sequence[str]] = None,
        wav_mean: Optional[float] = None,
        wav_std: Optional[float] = None,
        normalize_wav: bool = True,
    ):
        self.wav_list = list(wav_list)
        self.labels = labels
        self.utts = list(utts) if utts is not None else None
        self.max_dur = int(min(max(len(w) for w in self.wav_list), MAX_SAMPLES))
        self.normalize_wav = normalize_wav
        self.augment_fn = None
        if wav_mean is None or wav_std is None:
            wav_mean, wav_std = get_norm_stat_for_wav(self.wav_list)
        self.wav_mean = float(wav_mean)
        self.wav_std = float(wav_std)

    def __len__(self) -> int:
        return len(self.wav_list)

    def get(self, idx: int) -> Tuple[np.ndarray, int]:
        w = self.wav_list[idx][: self.max_dur]
        if self.augment_fn is not None:
            w = np.asarray(self.augment_fn(w))
        if self.normalize_wav:
            w = (w - self.wav_mean) / (self.wav_std + 1e-6)
        w = w.astype(np.float32)
        return w, len(w)

    def save_norm_stat(self, path: str) -> None:
        save_norm_stat(path, self.wav_mean, self.wav_std)


@dataclass
class WavBatch:
    wav: np.ndarray  # [B, L] padded
    mask: np.ndarray  # [B, L] sample-level mask, 1 = a real sample
    labels: Optional[np.ndarray]  # [B, C]
    sample_mask: np.ndarray  # [B] 1 = a real row, 0 = padding to the fixed row count
    utts: List[str]


def collate_wav(dataset: WavDataset, indices: Sequence[int], batch_size: int) -> WavBatch:
    """Rows ``indices`` of ``dataset`` as ``batch_size`` rows of L samples,
    L the longest rounded up to a whole ``QUANTUM`` (at least one)."""
    items = [dataset.get(i) for i in indices]
    L = max(QUANTUM, -(-max(d for _, d in items) // QUANTUM) * QUANTUM)
    B = batch_size
    wav = np.zeros((B, L), np.float32)
    mask = np.zeros((B, L), np.float32)
    sample_mask = np.zeros((B,), np.float32)
    labels = None
    if dataset.labels is not None:
        labels = np.zeros((B, dataset.labels.shape[1]), np.float32)
    utts = [""] * B
    for row, (idx, (w, dur)) in enumerate(zip(indices, items)):
        wav[row, :dur] = w
        mask[row, :dur] = 1.0
        sample_mask[row] = 1.0
        if labels is not None:
            labels[row] = dataset.labels[idx]
        if dataset.utts is not None:
            utts[row] = dataset.utts[idx]
    return WavBatch(wav, mask, labels, sample_mask, utts)


def epoch_batches(
    n: int,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool,
    lengths: Optional[np.ndarray] = None,
) -> List[List[int]]:
    """One epoch's batches of indices: a permutation (``shuffle``), each window
    of ``batch_size * BUCKET_WINDOW`` of it sorted by length (stable) when
    ``lengths`` is given, cut into batches."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    if lengths is not None:
        window = batch_size * BUCKET_WINDOW
        chunks = []
        for s in range(0, n, window):
            chunk = order[s: s + window]
            chunks.append(chunk[np.argsort(lengths[chunk], kind="stable")])
        order = np.concatenate(chunks) if chunks else order
    return [list(order[i: i + batch_size]) for i in range(0, n, batch_size)]


def inverse_freq_sample_weights(onehot_labels) -> np.ndarray:
    """Sampling probabilities proportional to 1 / the frequency of each row's
    class (``WeightedRandomSampler`` semantics), summing to 1."""
    labs = np.asarray(onehot_labels)
    freq = labs.sum(axis=0).astype(np.float64)
    inv = np.where(freq > 0, 1.0 / np.maximum(freq, 1), 0.0)
    w = inv[np.argmax(labs, axis=1)]
    return w / w.sum()


class TxtDataset:
    """Transcripts (a missing one is ``""``), tokenized one at a time by
    ``tokenize([text]) -> {"input_ids", "attention_mask"}``."""

    def __init__(self, texts: Sequence[Optional[str]], tokenize):
        self.texts = [t if isinstance(t, str) else "" for t in texts]
        self.tokenize = tokenize

    def __len__(self) -> int:
        return len(self.texts)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        toks = self.tokenize([self.texts[idx]])
        return np.asarray(toks["input_ids"])[0], np.asarray(toks["attention_mask"])[0]


def collate_txt_wav(wav_dataset: WavDataset, txt_dataset: TxtDataset, indices: Sequence[int],
                    batch_size: int) -> Tuple[WavBatch, np.ndarray, np.ndarray]:
    """``collate_wav`` of the rows plus their token ids and attention masks
    ([batch_size, L] int64, L the longest row's, zeros past a row and on the
    padding rows) -> (WavBatch, ids, mask)."""
    wav_batch = collate_wav(wav_dataset, indices, batch_size)
    items = [txt_dataset.get(i) for i in indices]
    L = max(len(ids) for ids, _ in items)
    ids = np.zeros((batch_size, L), np.int64)
    mask = np.zeros((batch_size, L), np.int64)
    for row, (tid, tm) in enumerate(items):
        ids[row, : len(tid)] = tid
        mask[row, : len(tm)] = tm
    return wav_batch, ids, mask
