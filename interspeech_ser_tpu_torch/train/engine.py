"""Fusion training / eval / scoring engine.

Port of ``interspeech_ser_tpu/train/engine.py`` for the four lazy-fusion
trainers (``bin/train_cat_{bimodal,trimodal}_lazy_*``): they differ in the
modalities, the ranking neutral head, the sampler and the loss, which are
the config and the ``ranking`` / ``focal_dynamic_alpha`` arguments here.

Reference semantics kept (as in the JAX package):
- AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight decay 1e-6 on every
  parameter), with a per-epoch cosine LR to eta_min 1e-6;
- loss: weighted CE with inverse-frequency train weights (unweighted under
  balanced batches); focal loss replaces it when ``use_focalloss`` (dynamic
  alpha for the trimodal trainers); ranking adds a soft-margin loss on the
  neutral head, with neutral-vs-rest balanced sampling;
- model selection by dev macro-F1 per epoch, the best saved as
  ``multimodal_ser.pt`` with the reference's key names; the per-epoch dev
  loss is the CE weighted by the dev set's class weights;
- gradient accumulation takes the mean of the micro-batch gradients.

Batches are padded to a fixed batch size and bucketed lengths with masks,
so a padded batch trains as the unpadded one. On the card the BiGRU runs
through K3 and its backward K3b (``ops/kernels/gru.py``). Training runs in
float32 with TF32 off (the f32 parity mode). Dropout draws from a seeded
``torch.Generator`` owned by the engine; the samplers from a numpy
``Generator``; both are saved with every epoch's full-state checkpoint.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.fusion import MultiModalEmotionClassifier
from ..utils import labels as L
from ..utils import ptio
from ..utils.config import FusionConfig
from ..utils.device import resolve_device
from ..utils.metrics import macro_f1
from ..utils.seeding import numpy_generator
from . import checkpointing, losses
from .data import Batch, LazyFeatureDataset, PrefetchLoader, epoch_batches

BUCKET_WINDOW = 8
BUCKET_QUANTUM = 64
LOG_EVERY = 200


def cosine_epoch_lr(lr0: float, epoch: int, total_epochs: int, eta_min: float = 1e-6) -> float:
    """The reference's CosineAnnealingScheduler.get_lr for epoch index ``epoch``."""
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / total_epochs)) / 2


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
    """Train and score the lazy-fusion classifier on one device (``cuda``
    unless the caller passes ``device="cpu"``; no card raises)."""

    def __init__(
        self,
        cfg: FusionConfig,
        seed: int = 7,
        device="cuda",
        ranking: bool = False,
        focal_dynamic_alpha: bool = False,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ranking = ranking
        self.focal_dynamic_alpha = focal_dynamic_alpha
        torch.manual_seed(seed)  # the init, and what strict=False leaves in place
        self.model = MultiModalEmotionClassifier(
            feat_dims=cfg.feat_dims, fusion_hidden_dim=cfg.fusion_hidden_dim,
            num_emotions=cfg.num_emotions, dropout=cfg.dropout, neutral_head=ranking,
        ).to(self.device).eval()
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.logger = logging.getLogger()

    # -- checkpoints ----------------------------------------------------------

    def load_torch_checkpoint(self, path: str, strict: bool = True) -> None:
        """Load a reference-format ``multimodal_ser.pt``. ``strict=False``
        keeps initialised values for missing keys (the reference eval load);
        a size mismatch raises either way."""
        self.model.load_state_dict(ptio.load_state_dict(path), strict=strict)

    def save_torch_checkpoint(self, path: str) -> None:
        """``multimodal_ser.pt``: the reference's key names, CPU tensors."""
        ptio.save_state_dict(self.model.state_dict(), path)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """AdamW as the JAX package's ``make_tx`` (optax.adamw): decay on
        every parameter, biases and LayerNorms too."""
        return torch.optim.AdamW(
            self.model.parameters(), lr=self.cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-6
        )

    # -- one step -------------------------------------------------------------

    def _to_device(self, batch: Batch):
        dev = self.device
        feats = [torch.from_numpy(f).to(dev) for f in batch.feats]
        masks = [torch.from_numpy(m).to(dev) for m in batch.masks]
        return feats, masks, torch.from_numpy(batch.labels).to(dev), torch.from_numpy(batch.sample_mask).to(dev)

    def _loss_terms(self, out: Dict, labels: torch.Tensor, sample_mask: torch.Tensor,
                    class_w: Optional[torch.Tensor]):
        """-> (the loss to differentiate, the weighted CE that is logged)."""
        logits = out["logits"]
        y = labels.argmax(dim=1)
        ce = losses.weighted_cross_entropy(logits, y, class_w, sample_mask)
        if self.cfg.use_focalloss:
            backward = losses.focal_loss(
                logits, y, alpha=1.0, gamma=2.0, dynamic_alpha=self.focal_dynamic_alpha,
                sample_mask=sample_mask,
            )
        else:
            backward = ce
        if self.ranking:
            y_neutral = (2 * labels[:, -1] - 1)[:, None]
            backward = backward + losses.soft_margin_loss(out["neutral"], y_neutral, sample_mask)
        return backward, ce

    def accumulate_gradients(self, batch: Batch, class_w: Optional[torch.Tensor]):
        """Forward and backward of one (micro-)batch in training mode; the
        gradients add into ``.grad``. -> (loss, logged CE) as tensors."""
        self.model.train()
        feats, masks, labels, smask = self._to_device(batch)
        out = self.model(feats, masks, output_dict=True, generator=self.generator)
        backward, ce = self._loss_terms(out, labels, smask, class_w)
        backward.backward()
        return backward.detach(), ce.detach()

    def apply_gradients(self, lr: float, n_micro: int = 1) -> None:
        """One AdamW step on the mean of ``n_micro`` accumulated gradients."""
        if n_micro != 1:
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(n_micro)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- training -------------------------------------------------------------

    def fit(
        self,
        train_rows: L.Rows,
        val_rows: L.Rows,
        log: Optional[logging.Logger] = None,
        resume: bool = False,
        stop_after_epoch: Optional[int] = None,
    ) -> Dict[str, float]:
        cfg = self.cfg
        logger = log or self.logger
        os.makedirs(cfg.model_path, exist_ok=True)
        if self.device.type == "cuda":  # f32 parity mode
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        train_ds = LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows),
                                      cfg.lazy_dirs, cfg.feat_dims)
        val_ds = LazyFeatureDataset(L.column(val_rows, "FileName"), L.matrix(val_rows),
                                    cfg.lazy_dirs, cfg.feat_dims)
        val_w = L.class_weights(val_rows)
        if self.ranking:
            sample_weights = L.neutral_balanced_sample_weights(train_rows)
        elif cfg.use_balanced_batch:
            sample_weights = L.balanced_sample_weights(train_rows)
        else:
            sample_weights = None
        # balanced batches -> unweighted CE; ranking keeps the train-weights CE
        class_w = None
        if not cfg.use_balanced_batch:
            class_w = torch.from_numpy(L.class_weights(train_rows)).to(self.device)

        self.optimizer = self.make_optimizer()
        if cfg.accum_step != 1:
            logger.info("accum_step=%d: using mean-gradient accumulation", cfg.accum_step)
        best = {"epoch": -1, "macro_f1": 0.0, "dev_loss": float("inf")}
        start_epoch = 0
        if resume:
            state = checkpointing.load_train_state(
                cfg.model_path, self.model, self.optimizer, self.rng, self.generator
            )
            if state is not None:
                done_epoch, best = state
                start_epoch = done_epoch + 1
                logger.info(f"Resumed from epoch {done_epoch} (best: {best})")

        for epoch in range(start_epoch, cfg.epochs):
            lr_e = cosine_epoch_lr(cfg.lr, epoch, cfg.epochs)
            batches = epoch_batches(train_ds, cfg.batch_size, self.rng, sample_weights=sample_weights,
                                    bucket_window=BUCKET_WINDOW)
            loader = PrefetchLoader(train_ds, batches, cfg.batch_size, BUCKET_QUANTUM)
            n_micro = 0
            for i, batch in enumerate(loader):
                _, ce = self.accumulate_gradients(batch, class_w)
                n_micro += 1
                if (i + 1) % cfg.accum_step == 0 or (i + 1) == len(loader):
                    self.apply_gradients(lr_e, n_micro)
                    n_micro = 0
                if (i + 2) % LOG_EVERY == 0:
                    logger.info(
                        f"Epoch ({epoch+1}/{cfg.epochs})| step = {i+1}: "
                        f"loss = {float(ce):.6f} current lr = {lr_e:.8g}"
                    )

            dev = self.evaluate(val_ds, val_weights=val_w)
            logger.info(
                f"|VALIDATION| Epoch ({epoch+1}/{cfg.epochs}): "
                f"eval_loss = {dev['loss']:.6f} eval f1 = {dev['macro_f1']:.6f}"
            )
            if dev["macro_f1"] > best["macro_f1"]:
                logger.info(f"New best model at epoch {epoch+1}")
                best = {"epoch": epoch, "macro_f1": dev["macro_f1"], "dev_loss": dev["loss"]}
                self.save_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"))
            checkpointing.save_train_state(
                cfg.model_path, self.model, self.optimizer, epoch, best, self.rng, self.generator
            )
            if stop_after_epoch is not None and epoch >= stop_after_epoch:
                logger.info(f"Stopping after epoch {epoch} (stop_after_epoch)")
                break
        return best

    # -- evaluation / scoring ---------------------------------------------------

    @torch.inference_mode()
    def predict(self, dataset: LazyFeatureDataset) -> np.ndarray:
        """Logits for every sample, in dataset order (batches of the config's
        ``batch_size``, length-sorted, time padded to multiples of 64)."""
        self.model.eval()
        bs = self.cfg.batch_size
        n = len(dataset)
        order = np.argsort(dataset.primary_lengths(), kind="stable")
        out = np.zeros((n, self.cfg.num_emotions), np.float32)
        for start in range(0, n, bs):
            idxs = order[start : start + bs].tolist()
            feats, masks, _, _ = self._to_device(dataset.collate(idxs, bs, BUCKET_QUANTUM))
            logits = self.model(feats, masks).float().cpu().numpy()
            out[idxs] = logits[: len(idxs)]
        return out

    def evaluate(self, dataset: LazyFeatureDataset, val_weights: Optional[np.ndarray] = None) -> Dict:
        """Logits, macro-F1 and the CE weighted by ``val_weights`` (the
        unweighted mean without them, as the reference eval logs)."""
        logits = self.predict(dataset)
        y = np.argmax(dataset.labels, axis=1)
        preds = np.argmax(logits, axis=1)
        return {
            "macro_f1": macro_f1(y, preds, self.cfg.num_emotions),
            "loss": _host_weighted_ce(logits, y, val_weights),
            "logits": logits, "preds": preds, "y": y,
        }


def _host_weighted_ce(logits: np.ndarray, y: np.ndarray, class_w: Optional[np.ndarray]) -> float:
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    nll = -logp[np.arange(len(y)), y]
    w = np.ones_like(nll) if class_w is None else np.asarray(class_w)[y]
    return float((nll * w).sum() / w.sum())


def save_predictions_with_probs(
    logits: np.ndarray,
    utts: Sequence[str],
    model_path: str,
    dtype: str = "dev",
    filename_header: str = "Filename",
) -> str:
    """results/{dev,test,train}.csv in the reference's format: raw logits at
    4 decimals; 'Filename' for dev and train, 'FileName' for test (a
    reference quirk)."""
    os.makedirs(os.path.join(model_path, "results"), exist_ok=True)
    out = os.path.join(model_path, "results", f"{dtype}.csv")
    headers = [filename_header, "Prediction"] + [f"class_{i}_prob" for i in range(logits.shape[1])]
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        for utt, row in zip(utts, logits):
            w.writerow([utt, L.INDEX_TO_LETTER[int(np.argmax(row))]] + [f"{p:.4f}" for p in row])
    return out
