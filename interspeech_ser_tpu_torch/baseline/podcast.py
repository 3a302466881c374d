"""MSP-Podcast categorical labels (the challenge baseline's data contract).

Light copy of ``interspeech_ser_tpu/baseline/podcast.py``'s categorical
loader, read with ``csv`` instead of pandas: the split-name map, the eight
emotion columns, and ``load_cat_emo_label``.
"""

from __future__ import annotations

import csv
from typing import Tuple

import numpy as np

SPLIT_MAP = {
    "train": "Train",
    "dev": "Development",
    "test1": "Test1",
    "test2": "Test2",
    "test3": "Test3",
}

CAT_COLUMNS = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]


def load_cat_emo_label(label_path: str, dtype: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (file names of split ``dtype``, their [N, 8] float64 label rows), in file order."""
    with open(label_path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r["Split_Set"] == SPLIT_MAP[dtype]]
    utts = np.asarray([r["FileName"] for r in rows], dtype=object)
    labels = np.asarray([[float(r[c]) for c in CAT_COLUMNS] for r in rows], dtype=np.float64).reshape(-1, 8)
    return utts, labels
