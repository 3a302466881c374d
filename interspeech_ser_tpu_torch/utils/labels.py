"""Label / transcript CSVs without pandas.

Port of the scoring half of ``interspeech_ser_tpu/utils/labels.py``: the
reference's left merge of the label CSV with the transcript CSV on
``FileName``, the ``Split_Set`` filter, and the class order. Rows are dicts
of strings, as ``csv.DictReader`` gives them.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

import numpy as np

CLASSES = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]
CLASS_LETTERS = ["A", "S", "H", "U", "F", "D", "C", "N"]
INDEX_TO_LETTER = dict(enumerate(CLASS_LETTERS))

Rows = List[Dict[str, str]]


def read_csv(path: str) -> Rows:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_merged(label_path: str, txt_path: Optional[str] = None) -> Rows:
    """Label rows, left-merged with transcript rows on ``FileName``."""
    labels = read_csv(label_path)
    if txt_path is None:
        return labels
    by_name: Dict[str, Rows] = {}
    for r in read_csv(txt_path):
        by_name.setdefault(r["FileName"], []).append(r)
    merged = []
    for r in labels:
        for t in by_name.get(r["FileName"], [{}]):
            merged.append({**{k: v for k, v in t.items() if k not in r}, **r})
    return merged


def split(rows: Rows, split_set: str) -> Rows:
    return [r for r in rows if r["Split_Set"] == split_set]


def column(rows: Rows, name: str) -> List[str]:
    return [r[name] for r in rows]


def matrix(rows: Rows, names: Sequence[str] = CLASSES) -> np.ndarray:
    """[N, len(names)] float32 values of the named columns (one-hot labels)."""
    return np.asarray([[float(r[c]) for c in names] for r in rows], np.float32).reshape(len(rows), len(names))
