"""The one generator of the cells' inputs, driven by a traffic file's parameters.

Every seed gets the same multiset of sizes, in another order: lengths are a
fixed grid of quantiles of the traffic's length distribution, and the seed
only decides which file gets which length and what it holds. So the work of
a run does not depend on the seed; its order and its values do.

The length distribution is given by ``corpus.seconds`` [lo, hi] and, where
the traffic has it, ``corpus.mean_s``: the maximum-entropy distribution on
that range with that mean, a truncated exponential (skewed to short
segments when the mean lies below the range's midpoint). Without a mean,
lengths spread evenly over the range.

- ``wavs``: 16-kHz mono int16 WAV files of a tone in noise (a copy of
  ``chip_smoke.py``'s ``write_wavs``), ``utt<i>.wav``.
- ``features``: the fusion trainer's cached embeddings, one float32 ``.pt``
  per utterance and modality, ``[ceil(n / hop), D]`` for a speech encoder
  over the grid's lengths and ``[rows, D]`` for text, made on the card from
  the seed; and one-hot labels whose class counts are the traffic's shares.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .weights import sub_seed

SR = 16000


def exp_rate(lo: float, hi: float, mean: float) -> float:
    """The rate of the exponential truncated to [lo, hi] whose mean is ``mean`` (bisection)."""
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} s outside ({lo}, {hi})")
    w = hi - lo

    def mean_at(rate):  # falls from the midpoint (rate -> 0) towards lo; a negative rate skews long
        if abs(rate * w) < 1e-9:
            return lo + w / 2
        return lo + 1 / rate - w / math.expm1(rate * w)

    a, b = -100.0 / w, 100.0 / w
    for _ in range(200):
        mid = (a + b) / 2
        a, b = (mid, b) if mean_at(mid) > mean else (a, mid)
    return (a + b) / 2


def length_grid(n: int, seconds: Sequence[float], mean_s: Optional[float] = None) -> List[int]:
    """``n`` sample counts at the cell midpoints of the length distribution's quantiles."""
    lo, hi = seconds
    us = [(i + 0.5) / n for i in range(n)]
    if mean_s is None:
        return [int(round((lo + (hi - lo) * u) * SR)) for u in us]
    rate = exp_rate(lo, hi, mean_s)
    if abs(rate * (hi - lo)) < 1e-9:
        return length_grid(n, seconds)
    cut = -math.expm1(-rate * (hi - lo))
    return [int(round((lo - math.log1p(-u * cut) / rate) * SR)) for u in us]


def seeded_lengths(n: int, corpus_params: Dict, seed: int) -> List[int]:
    grid = length_grid(n, corpus_params["seconds"], corpus_params.get("mean_s"))
    order = np.random.default_rng(sub_seed(seed, "lengths")).permutation(n)
    return [grid[i] for i in order]


def write_wav(path: str, samples: np.ndarray) -> None:
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """The file's samples as float32 in [-1, 1] (16-bit PCM, the one format written here)."""
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32768.0


def wavs(out_dir: str, traffic: Dict, seed: int) -> Dict[str, int]:
    """Write the traffic's wav corpus -> {file name: samples}."""
    c = traffic["corpus"]
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(sub_seed(seed, "wavs"))
    lengths = {}
    for i, m in enumerate(seeded_lengths(c["utterances"], c, seed)):
        t = np.arange(m, dtype=np.float32) / SR
        tone = np.sin(np.float32(2 * np.pi * rng.uniform(100, 300)) * t)
        name = f"utt{i:04d}.wav"
        write_wav(os.path.join(out_dir, name), 0.3 * tone + 0.05 * rng.standard_normal(m, dtype=np.float32))
        lengths[name] = m
    os.sync()  # written back in set-up, not during the window
    return lengths


def label_counts(n: int, shares: Sequence[float]) -> List[int]:
    """Class counts of ``n`` rows at ``shares`` (largest remainders)."""
    raw = [n * s / sum(shares) for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])[: n - sum(counts)]:
        counts[i] += 1
    return counts


def features(out_dir: str, traffic: Dict, seed: int, device) -> Dict:
    """Write the traffic's cached features -> {"names", "dirs", "labels" [N, C]}."""
    c = traffic["corpus"]
    n = c["utterances"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "features"))
    lengths = seeded_lengths(n, c, seed)
    names = [f"utt{i:04d}.wav" for i in range(n)]
    dirs = []
    for m in c["modalities"]:
        d = os.path.join(out_dir, m["name"])
        os.makedirs(d, exist_ok=True)
        rows = [math.ceil(k / m["hop"]) for k in lengths] if "hop" in m else [m["rows"]] * n
        x = torch.randn(sum(rows), m["dim"], generator=g, device=device).cpu()
        for name, t in zip(names, x.split(rows)):
            torch.save(t.clone(), os.path.join(d, name.replace(".wav", ".pt")))
        dirs.append(d)
    counts = label_counts(n, c["class_shares"])
    classes = np.repeat(np.arange(len(counts)), counts)
    classes = classes[np.random.default_rng(sub_seed(seed, "labels")).permutation(n)]
    labels = np.zeros((n, len(counts)), np.float32)
    labels[np.arange(n), classes] = 1.0
    os.sync()  # written back in set-up, not during the window
    return {"names": names, "dirs": dirs, "labels": labels}
