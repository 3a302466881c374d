"""MSP-Podcast labels (the challenge baseline's data contract).

Light copy of ``interspeech_ser_tpu/baseline/podcast.py``, read with
``csv`` instead of pandas: the split-name map, the eight emotion columns
and the three attribute columns, and the utterance, categorical and
dimensional loaders (all three attributes, or one), and the speaker-id
loader. Rows keep the file's order.
"""

from __future__ import annotations

import csv
from typing import List, Sequence, Tuple

import numpy as np

SPLIT_MAP = {
    "train": "Train",
    "dev": "Development",
    "test1": "Test1",
    "test2": "Test2",
    "test3": "Test3",
}

CAT_COLUMNS = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]
ADV_COLUMNS = ["EmoAct", "EmoDom", "EmoVal"]


def _split_rows(label_path: str, dtype: str) -> List[dict]:
    with open(label_path, newline="") as f:
        return [r for r in csv.DictReader(f) if r["Split_Set"] == SPLIT_MAP[dtype]]


def _labelled(label_path: str, dtype: str, columns: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    rows = _split_rows(label_path, dtype)
    labels = np.asarray([[float(r[c]) for c in columns] for r in rows], dtype=np.float64)
    return np.asarray([r["FileName"] for r in rows], dtype=object), labels.reshape(-1, len(columns))


def load_utts(label_path: str, dtype: str) -> np.ndarray:
    """-> the file names of split ``dtype``."""
    return np.asarray([r["FileName"] for r in _split_rows(label_path, dtype)], dtype=object)


def load_cat_emo_label(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 8] float64 label rows)."""
    return _labelled(label_path, dtype, CAT_COLUMNS)


def load_adv_emo_label(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 3] float64 arousal /
    dominance / valence rows)."""
    return _labelled(label_path, dtype, ADV_COLUMNS)


def load_adv_arousal(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 1] float64 arousal)."""
    return _labelled(label_path, dtype, ["EmoAct"])


def load_adv_dominance(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 1] float64 dominance)."""
    return _labelled(label_path, dtype, ["EmoDom"])


def load_adv_valence(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 1] float64 valence)."""
    return _labelled(label_path, dtype, ["EmoVal"])


def load_spk_id(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (file names of split ``dtype`` whose ``SpkrID`` is not ``Unknown``,
    their speaker ids densified to 0..N-1 in sorted order, N)."""
    rows = [r for r in _split_rows(label_path, dtype) if r["SpkrID"] != "Unknown"]
    spk = [int(r["SpkrID"]) for r in rows]
    remap = {old: new for new, old in enumerate(sorted(set(spk)))}
    return (np.asarray([r["FileName"] for r in rows], dtype=object),
            np.asarray([remap[s] for s in spk], dtype=np.int64), len(remap))
