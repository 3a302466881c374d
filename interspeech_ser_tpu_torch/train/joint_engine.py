"""The joint RoBERTa + WavLM trainers (the ``bin/old/train_cat_roberta*`` family).

Port of ``interspeech_ser_tpu/train/joint_engine.py``. One engine covers
six scripts (``VARIANTS``):

| variant   | head                  | encoders  | loss                        |
|-----------|-----------------------|-----------|-----------------------------|
| base      | conv                  | frozen    | weighted CE                 |
| ftall     | conv (dropout 0.2)    | trained   | weighted CE                 |
| large     | transformer           | frozen    | focal (gamma 3, dynamic a)  |
| cka       | transformer + gates   | frozen    | CE + (1 - CKA)              |
| ckainv    | transformer + gates   | frozen    | CE + CKA                    |
| small_cka | = cka (the reference scripts are the same file)             |

and ``TextOnlyEngine`` the text-only RoBERTa fine-tune
(``train_cat_roberta.py``).

As in the JAX engine:
- class weights N / (C n_c) on the Train rows; ``base`` / ``ftall`` score
  the dev loss with them, the others (``dev_weights='val'``) with weights of
  the Development rows;
- balanced batches draw rows with replacement by inverse class frequency
  from the engine's numpy generator, otherwise ``epoch_batches``' order (the
  JAX engine's draws: one seed, the same batches);
- the gradients of ``batch_size / accumulation_steps``-row micro-batches are
  summed and divided by their count before each update, a short last group
  by its own;
- the head trains with AdamW(lr, weight_decay); ``cosine_step`` sets its lr
  before update k to ``cos_decay(min(k, T)) (lr - 1e-6) + 1e-6``, T =
  epochs * ceil(N / batch_size); ``ftall`` trains both encoders with
  AdamW(1e-6, weight decay 0.1), the frozen variants never change them;
- dev predictions run at batch 8 in length order, masked, so they equal
  the reference's batch-1 eval; the best dev loss writes ``final_ser.pt``
  (the reference's head names) and, for ``ftall``, ``final_text_model.pt``
  (HF RoBERTa names) and ``final_ssl.pt`` (HF speech names).

Routes on the card, fixed when the engine is built (not fallbacks: a kernel
that fails raises):
- frozen variants run both encoders under ``torch.no_grad()`` (the JAX
  engine's ``stop_gradient``) with the no-backward kernels on: K1 in every
  WavLM layer, K2 for the frontend's first layer, K8 for the positional
  conv, K7 in every RoBERTa layer;
- ``ftall`` trains them: WavLM's attention runs K1 + K4, its frontend and
  positional conv take cuDNN (neither K2 nor K8 has a backward, and the
  frontend is trained, as in the JAX engine); RoBERTa's attention takes the
  plain route while it needs a gradient (K7 has no backward) and K7 in the
  dev predictions;
- the text-only engine likewise trains RoBERTa on the plain attention and
  predicts on K7.

Dropout (the heads' only randomness) draws from a seeded ``torch.Generator``
owned by the engine. f32 engines on the card turn TF32 off.
``use_timbre_perturb`` perturbs a drawn training wav with probability
``tp_prob`` (``baseline/engine.timbre_augment``, on the host).

Both engines are data-parallel over the ranks of a process group
(``n_devices``, ``None``: the world's; ``parallel/mesh.py``): each
micro-batch is padded to a multiple of the data axis with masked rows, each
rank runs its rows through the encoders and the head, the head's outputs
(the logits, and the gated features of the CKA variants) are gathered so
that every rank computes the whole micro-batch's loss (focal's dynamic alpha
and CKA are nonlinear in the batch), and one all-reduce of the trained
gradients precedes each update. Rank 0 alone writes files and logs.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..baseline import data as bdata
from ..baseline.engine import set_precision, timbre_augment
from ..baseline.podcast import load_cat_emo_label
from ..models import joint
from ..models.loader import build_roberta, build_speech_encoder, speech_state_dict_to_hf
from ..models.speech import with_config
from ..parallel.mesh import all_reduce_grads, barrier, data_parallel, make_mesh, replicate
from ..utils import labels as L
from ..utils import ptio
from ..utils.device import resolve_device
from ..utils.metrics import LogManager, accuracy
from ..utils.seeding import numpy_generator
from . import losses
from .engine import _host_weighted_ce

Tokenize = Callable[[List[str]], Dict[str, np.ndarray]]
HEAD_LR_MIN = 1e-6  # cosine_step's floor
ENCODER_LR, ENCODER_WD = 1e-6, 1e-1  # ftall's encoder AdamW
TEXT_WD = 1e-1  # the text-only fine-tune's AdamW
LOG_EVERY = 200
PREDICT_BATCH = 8
TEXT_PREDICT_BATCH = 16


@dataclasses.dataclass
class JointOptions:
    head: str = "conv"  # 'conv' | 'transformer'
    finetune_encoders: bool = False  # ftall
    gated: bool = False  # the CKA variants' gates (the head returns the gated features)
    cka: str = "none"  # 'none' | 'plain' (+ 1 - CKA) | 'inverse' (+ CKA)
    loss: str = "wce"  # 'wce' | 'focal3' | 'ce_cka'
    scheduler: str = "none"  # 'none' | 'cosine_step'
    dev_weights: str = "train"  # 'train' | 'val'
    masked: bool = True  # False: the reference's unmasked batched pooling
    conv_dropout: float = 0.5
    input_dropout: bool = True
    classifier_layernorm: bool = True
    save_encoders: bool = False


VARIANTS: Dict[str, JointOptions] = {
    "base": JointOptions(),
    "ftall": JointOptions(finetune_encoders=True, conv_dropout=0.2, input_dropout=False,
                          classifier_layernorm=False, save_encoders=True),
    "large": JointOptions(head="transformer", loss="focal3", scheduler="cosine_step", dev_weights="val"),
    "cka": JointOptions(head="transformer", gated=True, cka="plain", loss="ce_cka", scheduler="cosine_step",
                        dev_weights="val"),
    "ckainv": JointOptions(head="transformer", gated=True, cka="inverse", loss="ce_cka", scheduler="cosine_step",
                           dev_weights="val"),
}
VARIANTS["small_cka"] = VARIANTS["cka"]


def cosine_step_lr(lr: float, count: int, t_max: int) -> float:
    """The head's lr before update ``count`` (0-based) under ``cosine_step``:
    ``optax.cosine_decay_schedule(lr - 1e-6, t_max)(min(count, t_max)) + 1e-6``."""
    c = min(count, t_max)
    return (lr - HEAD_LR_MIN) * 0.5 * (1.0 + math.cos(math.pi * c / t_max)) + HEAD_LR_MIN


def _adamw(groups, lr: float, weight_decay: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def _update(opt: torch.optim.Optimizer, params: List[torch.Tensor], n_micro: int) -> None:
    """Divide the summed gradients by their micro-batch count, step, clear."""
    for p in params:
        if p.grad is not None:
            p.grad.div_(n_micro)
    opt.step()
    opt.zero_grad(set_to_none=True)


class JointEngine:
    """Speech + text encoders, frozen or trained, under a fusion head, on the
    card (``cuda``, the rank's card in a multi-device run, unless the caller
    passes ``device="cpu"``; no card raises)."""

    def __init__(
        self,
        ssl_type: str,  # a local HF-format speech directory
        text_type: str,  # a local HF-format RoBERTa directory
        tokenize: Tokenize,
        options: JointOptions,
        head_dim: int = 512,
        seed: int = 7,
        dtype: str = "float32",
        n_devices: Optional[int] = None,
        device="cuda",
    ):
        self.opts, self.tokenize, self.head_dim = options, tokenize, head_dim
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        set_precision(self.device, dtype)
        ssl, self.ssl_cfg, _ = build_speech_encoder(ssl_type, dtype=dtype)
        txt, self.txt_cfg = build_roberta(text_type, dtype=dtype)
        if options.finetune_encoders:
            ssl.fused_frontend = 0  # the frontend trains: cuDNN, as K2 has no backward
        else:
            ssl = with_config(ssl, dataclasses.replace(self.ssl_cfg, inference_kernels=True))  # K8
            ssl.requires_grad_(False)
            txt.requires_grad_(False)
        self.ssl, self.txt = ssl.to(self.device), txt.to(self.device)
        wav_dim, txt_dim = self.ssl_cfg.hidden_size, self.txt_cfg.hidden_size
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            if options.head == "conv":
                head = joint.ConvJointHead(wav_dim, txt_dim, head_dim, p=options.conv_dropout,
                                           input_dropout=options.input_dropout,
                                           classifier_layernorm=options.classifier_layernorm, masked=options.masked)
            else:
                head = joint.TransformerJointHead(wav_dim, txt_dim, head_dim, gated=options.gated,
                                                  masked=options.masked)
        self.head = head.to(self.device)
        for m in (self.ssl, self.txt, self.head):
            replicate(self.mesh, m)
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the head's dropout

    def encoder_params(self) -> List[torch.Tensor]:
        """The encoders' parameters (trained by ``ftall`` only)."""
        return list(self.ssl.parameters()) + list(self.txt.parameters())

    # -- forward ---------------------------------------------------------------

    def forward(self, wav: torch.Tensor, wav_mask: torch.Tensor, ids: torch.Tensor, txt_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, plain: bool = False):
        """The head's output (logits [B, 8], and the gated features when
        ``gated``) for waveforms [B, L] with their sample mask and token ids
        [B, Lt] with their attention mask. ``generator`` draws the head's
        dropout (training); ``plain`` runs every kernel's plain version."""
        train_encoders = self.opts.finetune_encoders and torch.is_grad_enabled()
        with torch.set_grad_enabled(train_encoders):
            ssl_out = self.ssl(wav, wav_mask, keep=(-1,), plain=plain)
            # K7 has no backward: a RoBERTa that needs a gradient takes the plain attention
            txt_feats = self.txt(ids, txt_mask, keep=(-1,), plain=plain or train_encoders)["last_hidden_state"]
        return self.head(ssl_out["last_hidden_state"].float(), txt_feats.float(), ssl_out["frame_mask"],
                         txt_mask.float(), generator)

    def _tensors(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    def loss(self, batch: bdata.WavBatch, ids: np.ndarray, txt_mask: np.ndarray,
             class_weights: Optional[torch.Tensor] = None, deterministic: bool = False, plain: bool = False):
        """-> (total, main, cka term) of one micro-batch; the head's dropout is
        on unless ``deterministic``. Every term is masked by the batch's
        ``sample_mask``, the CKA statistic included."""
        opts = self.opts
        wav, mask, ids_t, tmask, labels, smask = self._tensors(batch.wav, batch.mask, ids, txt_mask, batch.labels,
                                                               batch.sample_mask)
        gen = None if deterministic else self.generator
        out = data_parallel(self.mesh, lambda *a: self.forward(*a, gen, plain), (wav, mask, ids_t, tmask),
                            wav.shape[0])
        logits = out[0] if opts.gated else out
        y = labels.argmax(dim=1)
        if opts.loss == "wce":
            main = losses.weighted_cross_entropy(logits, y, class_weights, smask)
        elif opts.loss == "focal3":
            main = losses.focal_loss(logits, y, alpha=1.0, gamma=3.0, dynamic_alpha=True, sample_mask=smask)
        elif opts.loss == "ce_cka":
            main = losses.weighted_cross_entropy(logits, y, None, smask)
        else:
            raise ValueError(f"loss {opts.loss!r}: one of wce, focal3, ce_cka")
        if opts.cka == "none":
            return main, main, torch.zeros((), device=self.device)
        cka = losses.cka_loss(out[1], out[2], smask)
        if opts.cka == "inverse":
            cka = 1.0 - cka
        return main + cka, main, cka

    # -- training --------------------------------------------------------------

    def fit(
        self,
        label_path: str,
        audio_path: str,
        txt_path: str,
        model_path: str,
        batch_size: int = 32,
        accumulation_steps: int = 1,
        epochs: int = 10,
        lr: float = 1e-4,
        weight_decay: float = 1e-6,
        use_balanced_batch: bool = False,
        normalize_wav: bool = True,
        use_timbre_perturb: bool = False,
        tp_prob: float = 0.0,
        log=print,
    ) -> Dict:
        """Train on the label CSV's Train rows (transcripts left-merged on
        ``FileName``), keep the epoch of the lowest dev loss -> ``{"epoch",
        "loss"}`` of the best epoch, its dev logits (``dev_logits``), and every
        epoch's dev loss and mean train loss (``dev_losses``, ``train_losses``)."""
        opts = self.opts
        main = self.mesh.is_main
        log = self.mesh.main_only(log)
        if main:
            os.makedirs(model_path, exist_ok=True)
        rows = L.load_merged(label_path, txt_path)
        train_rows, dev_rows = L.split(rows, "Train"), L.split(rows, "Development")
        class_weights = torch.from_numpy(L.class_weights(train_rows)).to(self.device)
        dev_weights = L.class_weights(dev_rows if opts.dev_weights == "val" else train_rows)

        utts, labs = load_cat_emo_label(label_path, "train")
        train_set = bdata.WavDataset(bdata.load_audio(audio_path, utts), labs, utts, normalize_wav=normalize_wav)
        if use_timbre_perturb:
            train_set.augment_fn = timbre_augment(self.rng, tp_prob)
        if main:
            train_set.save_norm_stat(os.path.join(model_path, "train_norm_stat.pkl"))
        utts, labs = load_cat_emo_label(label_path, "dev")
        dev_set = bdata.WavDataset(bdata.load_audio(audio_path, utts), labs, utts, train_set.wav_mean,
                                   train_set.wav_std, normalize_wav)
        train_txt = bdata.TxtDataset(L.transcripts(train_rows), self.tokenize)
        dev_txt = bdata.TxtDataset(L.transcripts(dev_rows), self.tokenize)

        groups = [{"params": list(self.head.parameters())}]
        if opts.finetune_encoders:
            groups.append({"params": self.encoder_params(), "lr": ENCODER_LR, "weight_decay": ENCODER_WD})
        params = [p for g in groups for p in g["params"]]
        opt = _adamw(groups, lr, weight_decay)
        t_max = epochs * math.ceil(len(train_rows) / batch_size)
        micro_bs = batch_size // accumulation_steps
        n = len(train_set)
        lengths = np.asarray([len(w) for w in train_set.wav_list])
        sample_w = bdata.inverse_freq_sample_weights(train_set.labels) if use_balanced_batch else None

        lm = LogManager()
        lm.alloc_stat_type_list(["train_loss", "dev_loss"])
        best = {"epoch": -1, "loss": float("inf"), "dev_logits": None, "dev_losses": [], "train_losses": []}
        updates = 0
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
                wb, ids, tmask = bdata.collate_txt_wav(train_set, train_txt, idxs, micro_bs)
                total, main, _ = self.loss(wb, ids, tmask, class_weights)
                total.backward()
                step_losses.append(main.detach())
                n_micro += 1
                if (i + 1) % accumulation_steps == 0 or (i + 1) == len(batches):
                    if opts.scheduler == "cosine_step":
                        opt.param_groups[0]["lr"] = cosine_step_lr(lr, updates, t_max)
                    all_reduce_grads(self.mesh, params)
                    _update(opt, params, n_micro)
                    n_micro, updates = 0, updates + 1
                if (i + 2) % LOG_EVERY == 0:
                    log(f"Epoch ({epoch + 1}/{epochs})| step = {i}: loss = {float(main)}")
            epoch_losses = torch.stack(step_losses).tolist()
            for loss in epoch_losses:
                lm.add_stat("train_loss", loss)
            best["train_losses"].append(float(np.mean(epoch_losses)))

            dev = self.evaluate(dev_set, dev_txt, dev_weights)
            lm.add_stat("dev_loss", dev["loss"])
            best["dev_losses"].append(dev["loss"])
            if main:
                lm.print_stat()
            msg = f"|VALIDATION| Epoch ({epoch + 1}/{epochs}): eval_loss = {dev['loss']}"
            if opts.cka != "none":
                msg += f" eval_cka = {dev['cka']}"
            log(msg)
            if dev["loss"] < best["loss"]:
                best.update(epoch=epoch, loss=dev["loss"], dev_logits=dev["logits"])
                log(f"New best model at epoch {epoch + 1}")
                self.save_checkpoints(model_path)
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    # -- evaluation ------------------------------------------------------------

    @torch.inference_mode()
    def predict(self, wav_set: bdata.WavDataset, txt_set: bdata.TxtDataset, batch_size: int = PREDICT_BATCH):
        """-> (logits [N, 8], gated wav / text features [N, head_dim] or None)
        in the dataset's order, over batches of ``batch_size`` rows in length
        order."""
        gated = self.opts.gated
        n = len(wav_set)
        order = np.argsort([len(w) for w in wav_set.wav_list], kind="stable")
        logits = np.zeros((n, 8), np.float32)
        feats_w = np.zeros((n, self.head_dim), np.float32) if gated else None
        feats_r = np.zeros((n, self.head_dim), np.float32) if gated else None
        for s in range(0, n, batch_size):
            idxs = order[s: s + batch_size].tolist()
            wb, ids, tmask = bdata.collate_txt_wav(wav_set, txt_set, idxs, batch_size)
            out = data_parallel(self.mesh, self.forward, self._tensors(wb.wav, wb.mask, ids, tmask), batch_size)
            if gated:
                out, wx, rx = out
                feats_w[idxs] = wx[: len(idxs)].cpu().numpy()
                feats_r[idxs] = rx[: len(idxs)].cpu().numpy()
            logits[idxs] = out[: len(idxs)].cpu().numpy()
        return logits, feats_w, feats_r

    def evaluate(self, wav_set: bdata.WavDataset, txt_set: bdata.TxtDataset, class_weights) -> Dict:
        """The dev loss (CE weighted by ``class_weights``), and for the CKA
        variants the CKA term over the whole split's gated features."""
        logits, fw, fr = self.predict(wav_set, txt_set)
        y = np.argmax(np.asarray(wav_set.labels), axis=1)
        out = {"loss": _host_weighted_ce(logits, y, np.asarray(class_weights)), "logits": logits, "y": y}
        if self.opts.cka != "none":
            cka = float(losses.cka_loss(torch.from_numpy(fw), torch.from_numpy(fr)))
            out["cka"] = 1.0 - cka if self.opts.cka == "inverse" else cka
        return out

    # -- checkpoints -----------------------------------------------------------

    def _head_file(self, sd: Dict[str, torch.Tensor], to_file: bool) -> Dict[str, torch.Tensor]:
        o = self.opts
        if o.head == "conv":
            fn = joint.conv_joint_flax_to_torch if to_file else joint.conv_joint_torch_to_flax
            return fn(sd, o.classifier_layernorm)
        fn = joint.transformer_joint_flax_to_torch if to_file else joint.transformer_joint_torch_to_flax
        return fn(sd, self.head.num_layers, o.gated)

    def save_checkpoints(self, model_path: str) -> None:
        """``final_ser.pt``; with ``save_encoders`` also ``final_text_model.pt``
        and ``final_ssl.pt`` (f32 CPU copies); rank 0 writes."""
        if not self.mesh.is_main:
            return
        ptio.save_state_dict(self._head_file(self.head.state_dict(), True), os.path.join(model_path, "final_ser.pt"))
        if self.opts.save_encoders:
            ptio.save_state_dict({k: v.float() for k, v in self.txt.state_dict().items()},
                                 os.path.join(model_path, "final_text_model.pt"))
            ptio.save_state_dict(speech_state_dict_to_hf(self.ssl.state_dict()),
                                 os.path.join(model_path, "final_ssl.pt"))

    def load_head(self, model_path: str) -> None:
        """``final_ser.pt`` of either package, loaded strictly."""
        sd = ptio.load_state_dict(os.path.join(model_path, "final_ser.pt"))
        self.head.load_state_dict(self._head_file(sd, False), strict=True)


# ---------------------------------------------------------------------------
# the text-only trainer (bin/old/train_cat_roberta.py)
# ---------------------------------------------------------------------------


class TextOnlyEngine:
    """RobertaForSequenceClassification fine-tuned on the transcripts: the
    whole model under AdamW(lr, weight decay 0.1), weighted CE (+ focal with
    gamma 3 and dynamic alpha under ``use_focalloss``), the dev loss with the
    train class weights and the accuracy each epoch, ``text_ser.pt`` at the
    best dev loss."""

    def __init__(self, text_type: str, tokenize: Tokenize, seed: int = 7, dtype: str = "float32",
                 n_devices: Optional[int] = None, device="cuda"):
        self.tokenize = tokenize
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        set_precision(self.device, dtype)
        txt, self.txt_cfg = build_roberta(text_type, dtype=dtype)
        self.txt = txt.to(self.device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            head = joint.RobertaClassificationHead(self.txt_cfg.hidden_size, 8)
        self.cls_head = head.to(self.device)
        replicate(self.mesh, self.parameters())
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def parameters(self) -> List[torch.Tensor]:
        return list(self.txt.parameters()) + list(self.cls_head.parameters())

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # K7 has no backward: the trained forward takes the plain attention
        h = self.txt(ids, mask, keep=(-1,), plain=torch.is_grad_enabled())["last_hidden_state"]
        return self.cls_head(h.float(), generator)

    def loss(self, ids: np.ndarray, mask: np.ndarray, y: np.ndarray, sample_mask: np.ndarray,
             class_weights: torch.Tensor, use_focalloss: bool = False, deterministic: bool = False) -> torch.Tensor:
        ids_t, mask_t, y_t, smask = (torch.from_numpy(a).to(self.device) for a in (ids, mask, y, sample_mask))
        gen = None if deterministic else self.generator
        logits = data_parallel(self.mesh, lambda i, m: self.forward(i, m, gen), (ids_t, mask_t), ids_t.shape[0])
        loss = losses.weighted_cross_entropy(logits, y_t, class_weights, smask)
        if use_focalloss:
            loss = loss + losses.focal_loss(logits, y_t, alpha=1.0, gamma=3.0, dynamic_alpha=True, sample_mask=smask)
        return loss

    def fit(
        self,
        label_path: str,
        txt_path: str,
        model_path: str,
        batch_size: int = 32,
        accumulation_steps: int = 1,
        epochs: int = 5,
        lr: float = 1e-5,
        use_focalloss: bool = False,
        use_balanced_batch: bool = False,
        log=print,
    ) -> Dict:
        """-> ``{"epoch", "loss", "acc"}`` of the best epoch, its dev logits
        (``dev_logits``) and every epoch's dev loss (``dev_losses``)."""
        log = self.mesh.main_only(log)
        if self.mesh.is_main:
            os.makedirs(model_path, exist_ok=True)
        rows = L.load_merged(label_path, txt_path)
        splits = {}
        for name, key in (("train", "Train"), ("dev", "Development")):
            split_rows = L.split(rows, key)
            toks = self.tokenize([t if isinstance(t, str) else "" for t in L.transcripts(split_rows)])
            splits[name] = {"ids": np.asarray(toks["input_ids"]), "mask": np.asarray(toks["attention_mask"]),
                            "labels": L.matrix(split_rows)}
            splits[name]["y"] = np.argmax(splits[name]["labels"], axis=1)
        freq = splits["train"]["labels"].astype(np.float64).sum(axis=0)
        n = len(splits["train"]["y"])
        w = np.where(freq != 0, n / (len(L.CLASSES) * np.maximum(freq, 1)), 0.0)
        class_weights = torch.tensor(w, dtype=torch.float32, device=self.device)
        params = self.parameters()
        opt = _adamw(params, lr, TEXT_WD)
        sample_w = None
        if use_balanced_batch:  # the JAX engine's arithmetic, so that its draws are these
            cw = {c: 1.0 / f if f else 0.0 for c, f in zip(L.CLASSES, freq)}
            factor = len(cw) / sum(cw.values())
            sample_w = np.asarray([cw[L.CLASSES[i]] * factor for i in splits["train"]["y"]])
            sample_w = sample_w / sample_w.sum()

        tr = splits["train"]
        best = {"epoch": -1, "loss": float("inf"), "dev_logits": None, "dev_losses": []}
        for epoch in range(epochs):
            log(f"Epoch: {epoch}")
            order = self.rng.choice(n, size=n, replace=True, p=sample_w) if sample_w is not None \
                else self.rng.permutation(n)
            batches = [order[i: i + batch_size] for i in range(0, n, batch_size)]
            n_micro = 0
            opt.zero_grad(set_to_none=True)
            for i, idxs in enumerate(batches):
                ids = np.zeros((batch_size,) + tr["ids"].shape[1:], np.int64)
                mask = np.zeros_like(ids)
                y = np.zeros((batch_size,), np.int64)
                smask = np.zeros((batch_size,), np.float32)
                ids[: len(idxs)], mask[: len(idxs)], y[: len(idxs)] = tr["ids"][idxs], tr["mask"][idxs], tr["y"][idxs]
                smask[: len(idxs)] = 1.0
                self.loss(ids, mask, y, smask, class_weights, use_focalloss).backward()
                n_micro += 1
                if (i + 1) % accumulation_steps == 0 or (i + 1) == len(batches):
                    all_reduce_grads(self.mesh, params)
                    _update(opt, params, n_micro)
                    n_micro = 0
            logits = self.predict(splits["dev"]["ids"], splits["dev"]["mask"])
            dev_loss = _host_weighted_ce(logits, splits["dev"]["y"], w)
            acc = accuracy(splits["dev"]["y"], np.argmax(logits, axis=1))
            best["dev_losses"].append(dev_loss)
            log(f"|VALIDATION| Epoch ({epoch + 1}/{epochs}): eval_loss = {dev_loss} eval acc = {acc}")
            if dev_loss < best["loss"]:
                best.update(epoch=epoch, loss=dev_loss, acc=acc, dev_logits=logits)
                log(f"New best model at epoch {epoch + 1}")
                self.save_checkpoint(model_path)
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    @torch.inference_mode()
    def predict(self, ids: np.ndarray, mask: np.ndarray, batch_size: int = TEXT_PREDICT_BATCH) -> np.ndarray:
        """[N, 8] float32 logits over batches of ``batch_size`` rows."""
        logits = np.zeros((len(ids), 8), np.float32)
        for s in range(0, len(ids), batch_size):
            i_, m_ = (torch.from_numpy(a[s: s + batch_size]).to(self.device) for a in (ids, mask))
            logits[s: s + len(i_)] = data_parallel(self.mesh, self.forward, (i_, m_), len(i_)).cpu().numpy()
        return logits

    def save_checkpoint(self, model_path: str) -> None:
        """``text_ser.pt``: ``roberta.*`` (HF names) and ``classifier.{dense,out_proj}.*``;
        rank 0 writes."""
        if not self.mesh.is_main:
            return
        sd = {f"roberta.{k}": v.float() for k, v in self.txt.state_dict().items()}
        sd.update({f"classifier.{k}": v for k, v in self.cls_head.state_dict().items()})
        ptio.save_state_dict(sd, os.path.join(model_path, "text_ser.pt"))
