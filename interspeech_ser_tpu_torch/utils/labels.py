"""Label / transcript CSVs without pandas.

Port of ``interspeech_ser_tpu/utils/labels.py``: the reference's left merge
of the label CSV with the transcript CSV on ``FileName``, the ``Split_Set``
filter, the class order, the trainers' class and sample weights, the one-hot
helpers of the ranking trainers, the gender targets of the legacy gender
trainers (``interspeech_ser_tpu/cli.py``), and the pipeline's first step,
``process_labels_for_categorical`` (labels_consensus.csv -> one-hot
processed_labels.csv; ``python -m interspeech_ser_tpu_torch.utils.labels IN
OUT``, the counterpart of ``benchmark/process_labels_for_categorical.py``).
Rows are dicts of strings, as ``csv.DictReader`` gives them.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

import numpy as np

CLASSES = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]
CLASS_LETTERS = ["A", "S", "H", "U", "F", "D", "C", "N"]
INDEX_TO_LETTER = dict(enumerate(CLASS_LETTERS))
LETTER_TO_NAME = dict(zip(CLASS_LETTERS, CLASSES))

Rows = List[Dict[str, str]]
# the strings pandas.read_csv reads as a missing value (its default na_values)
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


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


GENDER_TARGETS = {"Female": "0", "Male": "1"}  # any other value, or none, is 0


def merge_gender(rows: Rows, gender_csv: str) -> Rows:
    """Left merge on ``FileName`` of ``gender_csv``'s ``Gender`` column, as a
    ``target_gender`` column: Female -> 0, Male -> 1, a missing or other
    value -> 0."""
    by_name: Dict[str, List[str]] = {}
    for r in read_csv(gender_csv):
        by_name.setdefault(r["FileName"], []).append(r["Gender"])
    merged = []
    for r in rows:
        for g in by_name.get(r["FileName"], [""]):
            merged.append({**r, "Gender": g, "target_gender": GENDER_TARGETS.get(g, "0")})
    return merged


def transcripts(rows: Rows) -> List[Optional[str]]:
    """Each merged row's ``transcription``; ``None`` where pandas would read
    a missing value (no transcript row, an empty cell, ``NA``, ...)."""
    texts = [r.get("transcription") for r in rows]
    return [None if t is None or t in PANDAS_NA else t for t in texts]


def split(rows: Rows, split_set: str) -> Rows:
    return [r for r in rows if r["Split_Set"] == split_set]


def column(rows: Rows, name: str) -> List[str]:
    return [r[name] for r in rows]


def matrix(rows: Rows, names: Sequence[str] = CLASSES) -> np.ndarray:
    """[N, len(names)] float32 values of the named columns (one-hot labels)."""
    return np.asarray([[float(r[c]) for c in names] for r in rows], np.float32).reshape(len(rows), len(names))


def _class_counts(rows: Rows) -> np.ndarray:
    return np.asarray([[float(r[c]) for c in CLASSES] for r in rows], np.float64).reshape(-1, len(CLASSES)).sum(0)


def class_weights(rows: Rows) -> np.ndarray:
    """Inverse-frequency CE weights: ``N_total / (C * n_c)`` (0 if n_c==0)."""
    freq = _class_counts(rows)
    total = len(rows)
    w = [total / (len(CLASSES) * float(f)) if f != 0 else 0.0 for f in freq]
    return np.asarray(w, dtype=np.float32)


def balanced_sample_weights(rows: Rows) -> np.ndarray:
    """Per-sample weights for class-balanced sampling with replacement."""
    cw = [1.0 / float(f) if f != 0 else 0.0 for f in _class_counts(rows)]
    factor = len(cw) / sum(cw)
    cw = [w * factor for w in cw]
    idx = np.argmax(matrix(rows), axis=1)
    return np.asarray([cw[i] for i in idx], dtype=np.float64)


def neutral_balanced_sample_weights(rows: Rows) -> np.ndarray:
    """Neutral-vs-rest balanced weights (ranking trainers)."""
    is_neutral = np.asarray([float(r["Neutral"]) for r in rows], np.float64)
    groups = np.stack([is_neutral, 1.0 - is_neutral], axis=1)
    freq = groups.sum(axis=0)
    gw = np.where(freq != 0, 1.0 / np.where(freq == 0, 1.0, freq), 0.0)
    gw = gw * (len(gw) / gw.sum())
    idx = np.argmax(groups, axis=1)
    return gw[idx]


def labels_to_index(onehot: np.ndarray) -> np.ndarray:
    """One-hot (or soft) label rows -> the arg-max class index."""
    return np.argmax(np.asarray(onehot), axis=1)


def neutral_margin_targets(onehot: np.ndarray) -> np.ndarray:
    """+-1 neutral targets for the ranking trainers' SoftMarginLoss (Neutral is the last column)."""
    neutral = np.asarray(onehot)[:, -1].astype(np.int64)
    return (2 * neutral - 1).astype(np.float32)


def process_labels_for_categorical(consensus_csv: str, out_csv: Optional[str] = None) -> Rows:
    """labels_consensus.csv -> one-hot rows (``FileName``, the eight classes
    as 1.0 / 0.0, ``Split_Set``) of the rows whose ``EmoClass`` is one of the
    eight letters (X / O, no consensus, dropped); written to ``out_csv`` with
    the bytes pandas' ``to_csv(index=False)`` writes (a missing value, as
    pandas reads one, is an empty field)."""
    rows = [r for r in read_csv(consensus_csv) if r["EmoClass"] in LETTER_TO_NAME]
    out = [{"FileName": r["FileName"], **{name: float(r["EmoClass"] == letter)
                                          for letter, name in LETTER_TO_NAME.items()},
            "Split_Set": r["Split_Set"]} for r in rows]
    if out_csv is not None:
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["FileName", *CLASSES, "Split_Set"])
            for r in out:
                w.writerow(["" if r["FileName"] in PANDAS_NA else r["FileName"], *(repr(r[c]) for c in CLASSES),
                            "" if r["Split_Set"] in PANDAS_NA else r["Split_Set"]])
    return out


if __name__ == "__main__":
    import sys

    in_csv = sys.argv[1] if len(sys.argv) > 1 else "labels_consensus.csv"
    out_csv = sys.argv[2] if len(sys.argv) > 2 else "processed_labels.csv"
    process_labels_for_categorical(in_csv, out_csv)
    print(f"wrote {out_csv}")
