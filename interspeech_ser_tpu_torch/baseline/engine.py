"""The challenge baseline: an end-to-end fine-tune of a speech SSL encoder.

Port of ``interspeech_ser_tpu/baseline/engine.py``. An encoder from a local HF
directory -> ``AttentiveStatisticsPooling`` -> ``EmotionRegression``: 8
logits (``cat``, weighted CE, or CE + focal loss under ``ce_focal3``) or 3
attributes (``dim``, the CCC loss). Every loss is masked by the batch's
``sample_mask``.

As in the JAX engine:
- the conv frontend is frozen (``requires_grad_(False)``, the reference's
  ``freeze_feature_encoder``): no gradient reaches it, so on the card its
  layer 0 runs kernel K2 inside the training forward, and AdamW gets only
  the trainable parameters;
- every attention runs K1 forward and K4 backward on the card, with the
  gated relative-position bias trained: K4's ``dbias`` of every layer sums
  into layer 0's ``rel_attn_embed``, its ``dgate`` reaches each layer's
  ``gru_rel_pos_linear`` / ``gru_rel_pos_const``;
- the encoder runs no dropout; the head's dropout draws from a seeded
  ``torch.Generator``;
- one AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-2): the gradients
  of ``batch_size / accumulation_steps``-row micro-batches are summed and
  divided by their count before each step, the last group of an epoch by
  its own count;
- the compute dtype is the caller's: ``cat`` trains in f32, ``dim`` in bf16
  over f32 weights; an f32 engine on the card turns TF32 off when it is
  built, so its training and its evaluation run in f32;
- the epoch order is the JAX engine's numpy draws (``numpy_generator(seed)``),
  or with ``use_balanced_batch`` rows drawn with replacement by inverse
  class frequency; ``use_timbre_perturb`` perturbs a drawn training wav with
  probability ``tp_prob`` (``train/information_encoder.fixed_timbre_perturb``,
  on the host, from a generator seeded by one draw of the engine's);
- the best dev loss writes ``final_ser.pt``, ``final_pool.pt`` and
  ``final_ssl.pt`` (HF names, the positional conv's weight norm unfolded);
- data-parallel over the ranks of a process group (``n_devices``, ``None``:
  the world's; ``parallel/mesh.py``): each micro-batch is padded to a
  multiple of the data axis with masked rows, each rank runs its rows (K2,
  K1 and K4 per rank), the outputs are gathered so that every rank computes
  the whole micro-batch's loss (CCC and focal's dynamic alpha are nonlinear
  in the batch), and the gradients are summed over the ranks by one
  all-reduce an optimizer step; prediction gathers the outputs. Rank 0 alone
  writes files and logs.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.loader import build_speech_encoder, speech_state_dict_from_hf, speech_state_dict_to_hf
from ..parallel.mesh import all_reduce_grads, barrier, data_parallel, make_mesh, replicate
from ..train import losses
from ..train.engine import _host_weighted_ce
from ..utils import ptio
from ..utils.device import is_main, resolve_device
from ..utils.labels import CLASSES, INDEX_TO_LETTER
from ..utils.metrics import LogManager, concordance_ccc
from ..utils.seeding import numpy_generator
from . import data as bdata
from .models import AttentiveStatisticsPooling, EmotionRegression

TASKS = ("cat", "dim")
LOSS_MODES = ("wce", "ce_focal3")
PREDICT_BATCH = 8


def set_precision(device: torch.device, dtype: str) -> None:
    """TF32 off for an f32 engine on the card (f32 parity mode, for training and
    evaluation alike); a bf16 engine leaves the flags as they are."""
    if device.type == "cuda" and dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class BaselineEngine:
    """End-to-end SSL encoder + pooling + head trainer and evaluator."""

    def __init__(
        self,
        ssl_type: str,  # a local HF-format directory
        task: str = "cat",  # 'cat' (8-way CE) | 'dim' (3 attributes, CCC)
        head_dim: int = 1024,
        seed: int = 100,
        dtype: str = "float32",
        dropout: float = 0.5,
        loss_mode: str = "wce",  # 'wce' | 'ce_focal3'
        device="cuda",  # "cpu" only when asked: no card raises
        n_devices: Optional[int] = None,  # ranks (one process each); None: the world's
    ):
        if task not in TASKS or loss_mode not in LOSS_MODES:
            raise ValueError(f"task {task!r} / loss_mode {loss_mode!r}: expected one of {TASKS} / {LOSS_MODES}")
        self.task, self.loss_mode = task, loss_mode
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        model, self.ssl_cfg, _ = build_speech_encoder(ssl_type, dtype=dtype)
        set_precision(self.device, dtype)
        model.feature_extractor.requires_grad_(False)
        self.ssl = model.to(self.device)
        feat_dim = self.ssl_cfg.hidden_size
        self.out_dim = 8 if task == "cat" else 3
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.pool = AttentiveStatisticsPooling(feat_dim).to(self.device)
            self.head = EmotionRegression(2 * feat_dim, head_dim, 1, self.out_dim, dropout=dropout).to(self.device)
        for m in (self.ssl, self.pool, self.head):
            replicate(self.mesh, m)
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the head's dropout

    def trainable(self) -> List[torch.Tensor]:
        """Every parameter but the frozen conv frontend's."""
        return [p for m in (self.ssl, self.pool, self.head) for p in m.parameters() if p.requires_grad]

    def optimizer(self, lr: float, weight_decay: float = 1e-2) -> torch.optim.AdamW:
        """The reference's AdamW over every trained tensor."""
        return torch.optim.AdamW(self.trainable(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    # -- forward ---------------------------------------------------------------

    def forward(self, wav: torch.Tensor, mask: torch.Tensor, train: bool = False, plain: bool = False):
        """Logits / attributes [B, out_dim] of waveforms [B, L] with sample mask
        [B, L]; ``train`` draws the head's dropout, ``plain`` runs every kernel's
        plain version (a reference run on the card)."""
        feats = self.ssl(wav, mask, keep=(-1,), plain=plain)["last_hidden_state"]
        return self.head(self.pool(feats, mask), self.generator if train else None)

    def loss(self, batch: bdata.WavBatch, class_weights: Optional[torch.Tensor] = None,
             plain: bool = False) -> torch.Tensor:
        """The training loss of one micro-batch (head dropout on; each rank
        runs its rows, the loss is the whole micro-batch's)."""
        dev = self.device
        wav, mask = torch.from_numpy(batch.wav).to(dev), torch.from_numpy(batch.mask).to(dev)
        pred = data_parallel(self.mesh, lambda w, m: self.forward(w, m, True, plain), (wav, mask), wav.shape[0])
        labels = torch.from_numpy(batch.labels).to(dev)
        smask = torch.from_numpy(batch.sample_mask).to(dev)
        if self.task == "dim":
            return losses.ccc_loss(pred, labels, smask)
        y = labels.argmax(dim=1)
        if self.loss_mode == "ce_focal3":
            return losses.weighted_cross_entropy(pred, y, None, smask) + losses.focal_loss(
                pred, y, alpha=1.0, gamma=3.0, dynamic_alpha=True, sample_mask=smask)
        return losses.weighted_cross_entropy(pred, y, class_weights, smask)

    # -- training --------------------------------------------------------------

    def fit(
        self,
        label_path: str,
        audio_path: str,
        model_path: str,
        batch_size: int = 32,
        accumulation_steps: int = 4,
        epochs: int = 20,
        lr: float = 1e-5,
        weight_decay: float = 1e-2,
        use_balanced_batch: bool = False,
        normalize_wav: bool = True,
        use_timbre_perturb: bool = False,
        tp_prob: float = 0.0,
        log=print,
    ) -> Dict:
        """Train on the label CSV's Train split, pick the epoch by dev loss ->
        ``{"epoch", "loss"}`` of the best epoch, its dev predictions
        (``dev_preds``) and every epoch's dev loss (``dev_losses``).
        ``use_timbre_perturb``: each training wav, when drawn, is perturbed
        with probability ``tp_prob`` (``timbre_augment``)."""
        main = self.mesh.is_main
        log = self.mesh.main_only(log)
        if main:
            os.makedirs(model_path, exist_ok=True)
        train_set = labelled_split(self.task, label_path, audio_path, "train", normalize_wav=normalize_wav)
        if use_timbre_perturb:
            train_set.augment_fn = timbre_augment(self.rng, tp_prob)
        if main:
            train_set.save_norm_stat(os.path.join(model_path, "train_norm_stat.pkl"))
        dev_set = labelled_split(self.task, label_path, audio_path, "dev", train_set.wav_mean, train_set.wav_std,
                                 normalize_wav)
        train_labs = train_set.labels

        class_weights = None
        if self.task == "cat":
            freq = np.asarray(train_labs).sum(axis=0)
            cw = np.where(freq != 0, len(train_labs) / (len(CLASSES) * np.maximum(freq, 1)), 0.0)
            class_weights = torch.tensor(cw, dtype=torch.float32, device=self.device)
        params = self.trainable()
        opt = self.optimizer(lr, weight_decay)
        micro_bs = batch_size // accumulation_steps
        lengths = np.asarray([len(w) for w in train_set.wav_list])
        sample_w = None
        if use_balanced_batch and self.task == "cat":
            sample_w = bdata.inverse_freq_sample_weights(train_labs)

        lm = LogManager()
        lm.alloc_stat_type_list(["train_loss", "dev_loss"])
        best = {"epoch": -1, "loss": float("inf"), "dev_preds": None, "dev_losses": []}
        for epoch in range(epochs):
            log(f"Epoch: {epoch}")
            lm.init_stat()
            if sample_w is not None:
                order = self.rng.choice(len(train_set), size=len(train_set), replace=True, p=sample_w)
                batches = [list(order[i: i + micro_bs]) for i in range(0, len(order), micro_bs)]
            else:
                batches = bdata.epoch_batches(len(train_set), micro_bs, self.rng, True, lengths)
            step_losses, n_micro = [], 0
            opt.zero_grad(set_to_none=True)
            for i, idxs in enumerate(batches):
                loss = self.loss(bdata.collate_wav(train_set, idxs, micro_bs), class_weights)
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
            if dev["loss"] < best["loss"]:
                best.update(epoch=epoch, loss=dev["loss"], dev_preds=dev["preds"])
                log(f"Save {epoch}")
                log(f"Loss {dev['loss']}")
                self.save_checkpoints(model_path)
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    # -- evaluation ------------------------------------------------------------

    @torch.inference_mode()
    def predict(self, dataset: bdata.WavDataset, batch_size: int = PREDICT_BATCH,
                timing: Optional[Dict] = None) -> np.ndarray:
        """[N, out_dim] float32 outputs in the dataset's order, computed over
        batches of ``batch_size`` rows in length order (each rank its rows of
        a batch, the outputs gathered). ``timing`` gains the
        seconds from each batch's copy to the card to its result back on the
        host (``inference``) and the seconds of audio (``audio_sec``)."""
        n = len(dataset)
        order = np.argsort([len(w) for w in dataset.wav_list], kind="stable")
        preds = np.zeros((n, self.out_dim), np.float32)
        for s in range(0, n, batch_size):
            idxs = order[s: s + batch_size].tolist()
            b = bdata.collate_wav(dataset, idxs, batch_size)
            t0 = time.perf_counter()
            wav = torch.from_numpy(b.wav).to(self.device)
            mask = torch.from_numpy(b.mask).to(self.device)
            pred = data_parallel(self.mesh, self.forward, (wav, mask), len(b.wav)).cpu().numpy()
            if timing is not None:
                timing["inference"] = timing.get("inference", 0.0) + time.perf_counter() - t0
                timing["audio_sec"] = timing.get("audio_sec", 0.0) + float(b.mask.sum()) / 16000
            preds[idxs] = pred[: len(idxs)]
        return preds

    def evaluate(self, dataset: bdata.WavDataset, class_weights=None) -> Dict:
        """``cat``: the weighted CE of the dev logits; ``dim``: 3 - sum of the
        three attributes' CCC."""
        preds = self.predict(dataset)
        labels = np.asarray(dataset.labels, np.float32)
        if self.task == "cat":
            y = np.argmax(labels, axis=1)
            cw = None if class_weights is None else torch.as_tensor(class_weights).cpu().numpy()
            return {"loss": _host_weighted_ce(preds, y, cw), "preds": preds, "y": y}
        cccs = [concordance_ccc(preds[:, i], labels[:, i]) for i in range(3)]
        return {"loss": 3.0 - sum(cccs), "ccc": cccs, "preds": preds}

    # -- checkpoints -----------------------------------------------------------

    def save_checkpoints(self, model_path: str) -> None:
        """``final_{ser,pool,ssl}.pt`` (rank 0 writes)."""
        if not self.mesh.is_main:
            return
        ptio.save_state_dict(self.head.state_dict(), os.path.join(model_path, "final_ser.pt"))
        ptio.save_state_dict(self.pool.state_dict(), os.path.join(model_path, "final_pool.pt"))
        ptio.save_state_dict(speech_state_dict_to_hf(self.ssl.state_dict()),
                             os.path.join(model_path, "final_ssl.pt"))

    def load_checkpoints(self, model_path: str) -> None:
        """``final_{ser,pool,ssl}.pt`` of either package, loaded strictly."""
        load = lambda name: ptio.load_state_dict(os.path.join(model_path, name))  # noqa: E731
        self.head.load_state_dict(load("final_ser.pt"))
        self.pool.load_state_dict(load("final_pool.pt"))
        self.ssl.load_state_dict(speech_state_dict_from_hf(load("final_ssl.pt")))


def labelled_split(task: str, label_path: str, audio_path: str, split: str, wav_mean: Optional[float] = None,
                   wav_std: Optional[float] = None, normalize_wav: bool = True) -> bdata.WavDataset:
    """The ``train`` or ``dev`` split of a label CSV with its targets (``cat``:
    the one-hot emotions, ``dim``: the attributes), normalised with the given
    mean and std (its own when none are given; not at all without
    ``normalize_wav``)."""
    from .podcast import load_adv_emo_label, load_cat_emo_label

    utts, labs = (load_cat_emo_label if task == "cat" else load_adv_emo_label)(label_path, split)
    return bdata.WavDataset(bdata.load_audio(audio_path, utts), labs, utts, wav_mean=wav_mean, wav_std=wav_std,
                            normalize_wav=normalize_wav)


def timbre_augment(rng: np.random.Generator, tp_prob: float):
    """The reference WavSet's augmentation: a wav -> with probability
    ``tp_prob`` its ``fixed_timbre_perturb``, else itself. Its draws come from
    a generator seeded by one draw of ``rng`` (the engine's), taken here, where
    the JAX engines take it, so the sampler draws after it stay equal."""
    from ..train.information_encoder import fixed_timbre_perturb

    aug_rng = numpy_generator(int(rng.integers(1 << 31)))

    def augment(w):
        if aug_rng.random() < tp_prob:
            return fixed_timbre_perturb(w, sr=16000, rng=aug_rng)
        return w

    return augment


def write_rows(path: str, header: List[str], rows: List[list]) -> str:
    """``results`` CSV as pandas' ``to_csv(index=False)`` writes it: rows sorted
    by their first field, ``\\n`` line ends. Rank 0 writes; every rank
    returns the path."""
    if not is_main():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(sorted(rows, key=lambda r: r[0]))
    return path


def write_test3_submission(preds: np.ndarray, utts, model_path: str, dtype: str = "test3") -> str:
    """``results/<dtype>.csv``: ``FileName,EmoClass`` with the arg-max class's
    letter, sorted by file name."""
    rows = [[u, INDEX_TO_LETTER[int(i)]] for u, i in zip(utts, np.argmax(preds, axis=1))]
    return write_rows(os.path.join(model_path, "results", f"{dtype}.csv"), ["FileName", "EmoClass"], rows)
