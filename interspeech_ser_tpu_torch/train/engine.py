"""Fusion scoring engine: checkpoint loading, batched prediction, CSVs.

Port of the scoring half of ``interspeech_ser_tpu/train/engine.py``
(``FusionEngine.load_torch_checkpoint``, ``predict``, ``evaluate`` and
``save_predictions_with_probs``). Training (AdamW, losses, ``fit``) comes in
a later slice. Batches are length-sorted and masked, so a batched
prediction equals each utterance's batch-1 prediction.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.fusion import MultiModalEmotionClassifier
from ..utils import labels as L
from ..utils import ptio
from ..utils.config import FusionConfig
from ..utils.metrics import macro_f1
from .data import LazyFeatureDataset


def setup_run_logging(model_path: str) -> logging.Logger:
    """File + stream logging into the model path, as the reference does."""
    os.makedirs(model_path, exist_ok=True)
    handlers = [
        logging.FileHandler(os.path.join(model_path, "loggingtxt-%d.log" % time.time())),
        logging.StreamHandler(),
    ]
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers, force=True,
    )
    return logging.getLogger()


class FusionEngine:
    """Score the lazy-fusion classifier on one device."""

    def __init__(
        self,
        cfg: FusionConfig,
        seed: int = 7,
        device: Optional[torch.device] = None,
    ):
        self.cfg = cfg
        if device is None:
            device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        self.device = torch.device(device)
        torch.manual_seed(seed)  # the init that strict=False leaves in place
        self.model = MultiModalEmotionClassifier(
            feat_dims=cfg.feat_dims, fusion_hidden_dim=cfg.fusion_hidden_dim,
            num_emotions=cfg.num_emotions, dropout=cfg.dropout,
        ).to(self.device).eval()

    def load_torch_checkpoint(self, path: str, strict: bool = True) -> None:
        """Load a reference-format ``multimodal_ser.pt``. ``strict=False``
        keeps initialised values for missing keys (the reference eval load);
        a size mismatch raises either way."""
        self.model.load_state_dict(ptio.load_state_dict(path), strict=strict)

    @torch.inference_mode()
    def predict(self, dataset: LazyFeatureDataset) -> np.ndarray:
        """Logits for every sample, in dataset order (batches of the config's
        ``batch_size``, length-sorted, time padded to multiples of 64)."""
        bs = self.cfg.batch_size
        n = len(dataset)
        order = np.argsort(dataset.primary_lengths(), kind="stable")
        out = np.zeros((n, self.cfg.num_emotions), np.float32)
        for start in range(0, n, bs):
            idxs = order[start : start + bs].tolist()
            batch = dataset.collate(idxs, bs)
            feats = [torch.from_numpy(f).to(self.device) for f in batch.feats]
            masks = [torch.from_numpy(m).to(self.device) for m in batch.masks]
            logits = self.model(feats, masks).float().cpu().numpy()
            out[idxs] = logits[: len(idxs)]
        return out

    def evaluate(self, dataset: LazyFeatureDataset) -> Dict:
        """Logits, macro-F1 and the unweighted CE the reference eval logs."""
        logits = self.predict(dataset)
        y = np.argmax(dataset.labels, axis=1)
        preds = np.argmax(logits, axis=1)
        return {
            "macro_f1": macro_f1(y, preds, self.cfg.num_emotions),
            "loss": _host_ce(logits, y),
            "logits": logits, "preds": preds, "y": y,
        }


def _host_ce(logits: np.ndarray, y: np.ndarray) -> float:
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(y)), y].mean())


def save_predictions_with_probs(
    logits: np.ndarray,
    utts: Sequence[str],
    model_path: str,
    dtype: str = "dev",
    filename_header: str = "Filename",
) -> str:
    """results/{dev,test}.csv in the reference's format: raw logits at 4
    decimals; 'Filename' for dev, 'FileName' for test (reference quirk)."""
    os.makedirs(os.path.join(model_path, "results"), exist_ok=True)
    out = os.path.join(model_path, "results", f"{dtype}.csv")
    headers = [filename_header, "Prediction"] + [f"class_{i}_prob" for i in range(logits.shape[1])]
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        for utt, row in zip(utts, logits):
            w.writerow([utt, L.INDEX_TO_LETTER[int(np.argmax(row))]] + [f"{p:.4f}" for p in row])
    return out
