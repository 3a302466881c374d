"""The x-vector SER trainer of ``bin/old/train_cat_baselinelike_xvector.py``.

Port of ``interspeech_ser_tpu/baseline/xvector_engine.py``: speechbrain fbank features
(``ops/mel.speechbrain_fbank``, plain PyTorch on the card) -> ``XVector``
(five TDNN blocks, statistics pooling, 512-d) -> ``EmotionRegression(512,
head_dim, 1, 8)``, trained jointly under the train split's weighted CE by one
AdamW (lr, weight decay 1e-2; the reference's two AdamW at one rate are the
same update) over micro-batches of ``batch_size / accumulation_steps`` rows,
their gradients summed and divided by their count. BatchNorm moments take
every row of a micro-batch, padding rows included, as in the JAX engine.
The best dev loss saves ``final_ser.pt`` (the head, reference names) and
``final_xvector.pt`` (speechbrain names). ``xvector_ckpt`` starts the encoder
from a speechbrain checkpoint; without one it starts from a seeded random
init.

The dev loss is the full dev set's; ``last_batch_dev_loss=True`` replicates
the reference's bug (the loss of the last 8 dev rows in the split's order).
No kernel runs here, as none does in the JAX engine.

Data-parallel over the ranks of a process group (``n_devices``, ``None``:
the world's; ``parallel/mesh.py``): each rank runs its rows of a
micro-batch, BatchNorm takes the micro-batch's global moments (one
all-reduce of each layer's sums in the forward and one in the backward,
``ops/batch_norm.sync``), the logits are gathered for the micro-batch's
loss and one all-reduce of the gradients precedes each step. BatchNorm
moments must not see extra padding rows, so the data axis must divide the
micro-batch (``batch_size / accumulation_steps``) or ``fit`` raises, where
the JAX engine trains on the largest sub-mesh that divides it (ROADMAP.md
§C). Prediction pads freely (BatchNorm on its running statistics). Rank 0
alone writes files and logs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.xvector import XVector, xvector_from_speechbrain, xvector_to_speechbrain
from ..ops.batch_norm import sync
from ..ops.mel import speechbrain_fbank
from ..parallel.mesh import all_reduce_grads, barrier, data_parallel, make_mesh, replicate
from ..train import losses
from ..train.engine import _host_weighted_ce
from ..utils import ptio
from ..utils.device import resolve_device
from ..utils.labels import CLASSES
from ..utils.metrics import LogManager
from ..utils.seeding import numpy_generator
from . import data as bdata
from .models import EmotionRegression

PREDICT_BATCH = 8


class XVectorEngine:
    def __init__(
        self,
        head_dim: int = 1024,
        seed: int = 7,
        xvector_ckpt: Optional[str] = None,
        last_batch_dev_loss: bool = False,
        n_devices: Optional[int] = None,
        device="cuda",  # "cpu" only when asked: no card raises
    ):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.xvector = XVector()
            self.head = EmotionRegression(512, head_dim, 1, 8, dropout=0.5)
        if xvector_ckpt:
            self.xvector.load_state_dict(xvector_from_speechbrain(ptio.load_state_dict(xvector_ckpt)))
        self.xvector.to(self.device)
        self.head.to(self.device)
        sync(self.xvector, self.mesh)
        for m in (self.xvector, self.head):
            replicate(self.mesh, m)
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the head's dropout
        self.last_batch_dev_loss = last_batch_dev_loss

    def parameters(self) -> list:
        return list(self.xvector.parameters()) + list(self.head.parameters())

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits [B, 8] of waveforms [B, L] with ``lengths`` live samples a
        row; ``train``: BatchNorm on the batch's moments (the running ones
        move), the head's dropout drawn."""
        feats = speechbrain_fbank(wav, lengths=lengths)
        self.xvector.train(train)
        emb = self.xvector(feats, 1 + lengths.to(torch.int64) // 160)
        return self.head(emb, self.generator if train else None)

    def batch_loss(self, b: bdata.WavBatch, class_weights: torch.Tensor) -> torch.Tensor:
        dev = self.device
        wav, lengths = torch.from_numpy(b.wav).to(dev), torch.from_numpy(b.mask.sum(axis=1)).to(dev)
        pred = data_parallel(self.mesh, lambda w, n: self.forward(w, n, True), (wav, lengths), wav.shape[0])
        y = torch.from_numpy(np.argmax(b.labels, axis=1)).to(dev)
        return losses.weighted_cross_entropy(pred, y, class_weights, torch.from_numpy(b.sample_mask).to(dev))

    def fit(
        self,
        label_path: str,
        audio_path: str,
        model_path: str,
        batch_size: int = 32,
        accumulation_steps: int = 1,
        epochs: int = 10,
        lr: float = 1e-4,
        use_balanced_batch: bool = False,
        normalize_wav: bool = True,
        log=print,
    ) -> Dict:
        """-> ``{"epoch", "loss"}`` of the best epoch, its dev logits
        (``dev_preds``) and every epoch's dev loss (``dev_losses``)."""
        from .engine import labelled_split

        micro_bs = batch_size // accumulation_steps
        if micro_bs % self.mesh.data:
            raise ValueError(f"{self.mesh.data} data ranks do not divide the micro-batch of {micro_bs} rows: "
                             "BatchNorm's moments must not take padding rows")
        main = self.mesh.is_main
        log = self.mesh.main_only(log)
        if main:
            os.makedirs(model_path, exist_ok=True)
        train_set = labelled_split("cat", label_path, audio_path, "train", normalize_wav=normalize_wav)
        if main:
            train_set.save_norm_stat(os.path.join(model_path, "train_norm_stat.pkl"))
        dev_set = labelled_split("cat", label_path, audio_path, "dev", train_set.wav_mean, train_set.wav_std,
                                 normalize_wav)
        freq = np.asarray(train_set.labels).sum(axis=0).astype(np.float64)
        cw = np.where(freq != 0, len(train_set.labels) / (len(CLASSES) * np.maximum(freq, 1)), 0.0)
        class_weights = torch.tensor(cw, dtype=torch.float32, device=self.device)

        params = self.parameters()
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
        n = len(train_set)
        lengths = np.asarray([len(w) for w in train_set.wav_list])
        sample_w = bdata.inverse_freq_sample_weights(train_set.labels) if use_balanced_batch else None

        lm = LogManager()
        lm.alloc_stat_type_list(["train_loss", "dev_loss"])
        best = {"epoch": -1, "loss": float("inf"), "dev_preds": None, "dev_losses": []}
        for epoch in range(epochs):
            log(f"Epoch: {epoch}")
            lm.init_stat()
            if sample_w is not None:
                order = self.rng.choice(n, size=n, replace=True, p=sample_w)
                batches = [list(order[i: i + micro_bs]) for i in range(0, n, micro_bs)]
            else:
                batches = bdata.epoch_batches(n, micro_bs, self.rng, True, lengths)
            step_losses, n_micro = [], 0
            opt.zero_grad(set_to_none=True)
            for i, idxs in enumerate(batches):
                loss = self.batch_loss(bdata.collate_wav(train_set, idxs, micro_bs), class_weights)
                loss.backward()
                step_losses.append(loss.detach())
                n_micro += 1
                if (i + 1) % accumulation_steps == 0 or (i + 1) == len(batches):
                    all_reduce_grads(self.mesh, params)
                    for p in params:
                        p.grad.div_(n_micro)
                    opt.step()
                    opt.zero_grad(set_to_none=True)
                    n_micro = 0
            for loss in torch.stack(step_losses).tolist():
                lm.add_stat("train_loss", loss)
            dev = self.evaluate(dev_set, class_weights)
            lm.add_stat("dev_loss", dev["loss"])
            best["dev_losses"].append(dev["loss"])
            if main:
                lm.print_stat()
            log(f"|VALIDATION| Epoch ({epoch + 1}/{epochs}): eval_loss = {dev['loss']}")
            if dev["loss"] < best["loss"]:
                best.update(epoch=epoch, loss=dev["loss"], dev_preds=dev["preds"])
                log(f"New best model at epoch {epoch + 1}")
                self.save_checkpoints(model_path)
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    @torch.inference_mode()
    def predict(self, dataset: bdata.WavDataset, batch_size: int = PREDICT_BATCH) -> np.ndarray:
        """[N, 8] float32 logits in the dataset's order, computed over batches
        of ``batch_size`` rows in length order (BatchNorm on its running
        statistics, so padding rows change nothing)."""
        n = len(dataset)
        order = np.argsort([len(w) for w in dataset.wav_list], kind="stable")
        preds = np.zeros((n, 8), np.float32)
        for s in range(0, n, batch_size):
            idxs = order[s: s + batch_size].tolist()
            b = bdata.collate_wav(dataset, idxs, batch_size)
            wav = torch.from_numpy(b.wav).to(self.device)
            pred = data_parallel(self.mesh, self.forward, (wav, torch.from_numpy(b.mask.sum(axis=1)).to(self.device)),
                                 batch_size)
            preds[idxs] = pred.float().cpu().numpy()[: len(idxs)]
        return preds

    def evaluate(self, dataset: bdata.WavDataset, class_weights=None) -> Dict:
        """The dev set's weighted CE (of its last 8 rows with
        ``last_batch_dev_loss``), its logits and labels."""
        preds = self.predict(dataset)
        y = np.argmax(np.asarray(dataset.labels), axis=1)
        cw = None if class_weights is None else torch.as_tensor(class_weights).cpu().numpy()
        preds_, y_ = (preds[-8:], y[-8:]) if self.last_batch_dev_loss else (preds, y)
        return {"loss": _host_weighted_ce(preds_, y_, cw), "preds": preds, "y": y}

    def save_checkpoints(self, model_path: str) -> None:
        """``final_ser.pt`` and ``final_xvector.pt`` (rank 0 writes)."""
        if not self.mesh.is_main:
            return
        ptio.save_state_dict(self.head.state_dict(), os.path.join(model_path, "final_ser.pt"))
        ptio.save_state_dict(xvector_to_speechbrain(self.xvector.state_dict()),
                             os.path.join(model_path, "final_xvector.pt"))

    def load_checkpoints(self, model_path: str) -> None:
        """``final_ser.pt`` and ``final_xvector.pt`` of either package, loaded strictly."""
        self.head.load_state_dict(ptio.load_state_dict(os.path.join(model_path, "final_ser.pt")))
        self.xvector.load_state_dict(
            xvector_from_speechbrain(ptio.load_state_dict(os.path.join(model_path, "final_xvector.pt"))))
