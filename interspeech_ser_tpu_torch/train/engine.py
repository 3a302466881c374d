"""Fusion training / eval / scoring engine.

Port of ``interspeech_ser_tpu/train/engine.py``: one engine behind the four
lazy-fusion trainers (``bin/train_cat_{bimodal,trimodal}_lazy_*``) and the
legacy ``bin/old`` ones. The former differ in the modalities, the ranking
neutral head, the sampler and the loss; the latter in the ``EngineOptions``
fields, as in the JAX package: the dimensional task (``task='dim'``: CCC,
optionally + MSE, per-attribute ``dim_columns``, a warm start from a cat
checkpoint), the loss (``loss_type``: focal with any gamma, label-smoothed
CE, hierarchical CE + KL, differentiable F1 with or without CE;
``unweighted_ce``), the CKA coupling of the pooled speech and text
representations, the gender heads (``grl``, ``aux``, ``svm``), the MoE and
single-modality models, the cross-attention head count, the pooled gates
and the modality norms.

Reference semantics kept (as in the JAX package):
- AdamW(lr, betas (0.9, 0.999), eps 1e-8, weight decay 1e-6 on every
  parameter), with a per-epoch cosine LR to eta_min 1e-6;
- loss: weighted CE with inverse-frequency train weights (unweighted under
  balanced batches); focal loss replaces it when ``use_focalloss`` (dynamic
  alpha for the trimodal trainers); ranking adds a soft-margin loss on the
  neutral head, with neutral-vs-rest balanced sampling;
- model selection by dev macro-F1 per epoch (by dev ``n_attr - sum CCC`` for
  the dim task), the best saved as ``multimodal_ser.pt``: with the
  reference's key names, or, for ``moe``, ``single`` and any gender mode,
  with the JAX engine's flat flax keys and ``[in, out]`` Dense kernels
  (``models/convert.py``). Both kinds load back. The per-epoch dev loss is
  the CE weighted by the dev set's class weights;
- gradient accumulation takes the mean of the micro-batch gradients;
- kept for parity: the gender SVM trainer's non-focal branch takes its CE
  on the gender logits, CKA reads the whole padded batch and diff-F1 every
  row (ROADMAP §C), and a negative ``cka_weight`` adds nothing.

Batches are padded to a fixed batch size and bucketed lengths with masks,
so a padded batch trains as the unpadded one. On the card every BiGRU (each
MoE expert's too) runs through K3 and its backward K3b
(``ops/kernels/gru.py``). Training runs in float32 with TF32 off (the f32
parity mode). Dropout draws from a seeded ``torch.Generator`` owned by the
engine; the samplers from a numpy ``Generator``; both are saved with every
epoch's full-state checkpoint.

Data parallelism (one process a rank, ``parallel/mesh.py``; ``n_devices``
is the number of ranks, ``None`` the world's): every rank draws the same
batches, pads each to a multiple of the data axis with masked rows and runs
its own rows (K3 forward and K3b backward per rank: the kernels always run);
dropout keeps the rank's rows of the global batch's mask; the outputs the
loss reads (logits, neutral, gender, pooled) are gathered, so that every
rank computes the global batch's loss (CKA, diff-F1 and focal's dynamic
alpha are nonlinear in the batch); one all-reduce of the gradients a
optimizer step (after accumulation) gives the one-device gradient. Eval
gathers the logits. Rank 0 alone writes checkpoints and logs.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import convert
from ..models.fusion import MultiModalEmotionClassifier
from ..models.fusion_variants import MoEEmotionClassifier, SingleModalitySERClassifier
from ..utils import labels as L
from ..utils import ptio
from ..parallel.mesh import all_reduce_grads, barrier, data_parallel, make_mesh, replicate
from ..utils.config import FusionConfig
from ..utils.device import is_main, resolve_device
from ..utils.metrics import concordance_ccc, macro_f1
from ..utils.seeding import numpy_generator
from . import checkpointing, losses
from .data import Batch, LazyFeatureDataset, PrefetchLoader, epoch_batches

BUCKET_WINDOW = 8
BUCKET_QUANTUM = 64
LOG_EVERY = 200
DIM_COLUMNS = ("EmoAct", "EmoDom", "EmoVal")
LOSS_TYPES = (None, "ce", "focal", "labelsmooth", "hierarchical", "f1")
GENDER_MODES = (None, "grl", "aux", "svm")


def cosine_epoch_lr(lr0: float, epoch: int, total_epochs: int, eta_min: float = 1e-6) -> float:
    """The reference's CosineAnnealingScheduler.get_lr for epoch index ``epoch``."""
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / total_epochs)) / 2


def setup_run_logging(model_path: str) -> logging.Logger:
    """File + stream logging into the model path, as the reference does; on a
    rank other than 0 of a multi-device run, warnings only and no file."""
    if not is_main():
        logging.basicConfig(level=logging.WARNING, handlers=[logging.StreamHandler()], force=True)
        return logging.getLogger()
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


@dataclass
class EngineOptions:
    """The JAX ``EngineOptions``: what the fusion trainers and the ``bin/old``
    wrappers set (``cli.LEGACY`` maps each wrapper to its fields)."""

    ranking: bool = False
    focal_dynamic_alpha: bool = False  # True for the trimodal trainers
    masked: bool = True
    bucket_window: int = BUCKET_WINDOW
    bucket_quantum: int = BUCKET_QUANTUM
    log_every: int = LOG_EVERY
    n_devices: Optional[int] = None  # ranks (one process each); None: the world's
    task: str = "cat"  # 'cat' | 'dim' (CCC regression)
    loss_type: Optional[str] = None  # None: the config's flags; 'ce'|'focal'|'labelsmooth'|'hierarchical'|'f1'
    label_smoothing: float = 0.1
    cka_weight: float = 0.0  # couples the pooled speech and text representations (> 0 only)
    gender_mode: Optional[str] = None  # 'grl' | 'aux' | 'svm'
    gender_weight: float = 1.0
    mse_weight: float = 0.0  # dim task: + mse_weight x MSE
    model_variant: str = "fusion"  # 'fusion' | 'moe' | 'single'
    num_experts: int = 4
    dim_columns: Optional[Sequence[str]] = None  # None: EmoAct, EmoDom, EmoVal
    focal_gamma: float = 2.0
    unweighted_ce: bool = False
    add_ce_to_f1: bool = False
    attention_heads: Optional[int] = None  # None: the reference's 1 (2 for trimodal prosody)
    init_from_pretrained: bool = False  # warm start from the config's pretrained_path (name + shape matches)
    gated_pool: bool = False
    modality_norm: bool = True

    def __post_init__(self) -> None:
        for name, value, allowed in (("task", self.task, ("cat", "dim")), ("loss_type", self.loss_type, LOSS_TYPES),
                                     ("gender_mode", self.gender_mode, GENDER_MODES),
                                     ("model_variant", self.model_variant, ("fusion", "moe", "single"))):
            if value not in allowed:
                raise ValueError(f"{name}={value!r}: one of {allowed}")


class FusionEngine:
    """Train and score the lazy-fusion classifier on the card (``cuda``, the
    rank's card in a multi-device run, unless the caller passes
    ``device="cpu"``; no card raises). ``options`` (an ``EngineOptions``) or
    the ``ranking`` / ``focal_dynamic_alpha`` shorthands, not both."""

    def __init__(
        self,
        cfg: FusionConfig,
        seed: int = 7,
        device="cuda",
        ranking: bool = False,
        focal_dynamic_alpha: bool = False,
        options: Optional[EngineOptions] = None,
    ):
        if options is None:
            options = EngineOptions(ranking=ranking, focal_dynamic_alpha=focal_dynamic_alpha)
        elif ranking or focal_dynamic_alpha:
            raise ValueError("pass ranking / focal_dynamic_alpha inside options")
        self.cfg = cfg
        self.opt = opt = options
        self.device = resolve_device(device)
        self.mesh = make_mesh(opt.n_devices)
        self.dim_columns = tuple(opt.dim_columns or DIM_COLUMNS)
        self.num_out = len(self.dim_columns) if opt.task == "dim" else cfg.num_emotions
        self.loss_type = opt.loss_type or ("focal" if cfg.use_focalloss else "ce")
        # moe, single and the gender heads have no reference key names: flat flax keys on disk
        self.flat_checkpoint = opt.model_variant != "fusion" or opt.gender_mode is not None
        self.renames = convert.fusion_renames(len(cfg.feat_dims)) if opt.model_variant == "fusion" else None
        torch.manual_seed(seed)  # the init, and what strict=False leaves in place
        self.model = self._build_model().to(self.device).eval()
        replicate(self.mesh, self.model)
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.logger = logging.getLogger()

    def _build_model(self) -> torch.nn.Module:
        cfg, opt = self.cfg, self.opt
        if opt.model_variant == "single":
            # every single-modality reference script builds it with one attention head
            return SingleModalitySERClassifier(cfg.feat1_dim, cfg.fusion_hidden_dim, self.num_out,
                                               opt.attention_heads or 1)
        if opt.model_variant == "moe":
            return MoEEmotionClassifier(cfg.feat_dims, cfg.fusion_hidden_dim, self.num_out, opt.num_experts,
                                        cfg.dropout)
        return MultiModalEmotionClassifier(
            feat_dims=cfg.feat_dims, fusion_hidden_dim=cfg.fusion_hidden_dim, num_emotions=self.num_out,
            dropout=cfg.dropout, neutral_head=opt.ranking,
            # the svm trainer's gender head is the plain (no-GRL) one
            gender_head="aux" if opt.gender_mode == "svm" else opt.gender_mode,
            attention_heads=opt.attention_heads, masked=opt.masked, gated_pool=opt.gated_pool,
            modality_norm=opt.modality_norm,
        )

    # -- checkpoints ----------------------------------------------------------

    def _port_state(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A checkpoint's state dict in the port's key names (flat flax keys converted)."""
        return convert.flax_flat_to_port(sd, self.renames) if convert.is_flax_flat(sd) else sd

    def load_torch_checkpoint(self, path: str, strict: bool = True) -> None:
        """Load a ``multimodal_ser.pt`` with the reference's key names or the
        JAX engine's flat flax keys. ``strict=False`` keeps initialised values
        for missing keys (the reference eval load); a size mismatch raises
        either way."""
        self.model.load_state_dict(self._port_state(ptio.load_state_dict(path)), strict=strict)

    def load_torch_checkpoint_filtered(self, path: str) -> Tuple[List[str], List[str]]:
        """Warm start keeping only name + shape matches (the ``fromcat``
        trainer: a cat checkpoint's 8-way head is skipped by a dim model)
        -> (the keys loaded, the checkpoint's keys skipped)."""
        own = self.model.state_dict()
        sd = self._port_state(ptio.load_state_dict(path))
        kept = [k for k, v in sd.items() if k in own and own[k].shape == v.shape]
        self.model.load_state_dict({k: sd[k] for k in kept}, strict=False)
        return kept, [k for k in sd if k not in kept]

    def save_torch_checkpoint(self, path: str) -> None:
        """``multimodal_ser.pt`` as the JAX engine writes it, CPU tensors (rank 0 writes)."""
        if not self.mesh.is_main:
            return
        sd = self.model.state_dict()
        if self.flat_checkpoint:
            sd = {k: torch.from_numpy(v) for k, v in convert.port_to_flax_flat(sd, self.renames).items()}
        ptio.save_state_dict(sd, path)

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
        aux = None if batch.aux is None else torch.from_numpy(batch.aux).long().to(dev)
        return (feats, masks, torch.from_numpy(batch.labels).to(dev), torch.from_numpy(batch.sample_mask).to(dev),
                aux)

    def _forward(self, feats, masks, generator=None) -> Dict:
        """The model's outputs as a dict (``logits`` and, for the fusion
        model, ``neutral``, ``gender``, ``pooled``, ``fused``)."""
        if self.opt.model_variant == "fusion":
            return self.model(feats, masks, output_dict=True, generator=generator)
        if self.opt.model_variant == "single":
            logits = self.model(feats[0], masks[0] if masks else None, generator=generator)
        else:
            logits = self.model(feats, masks, generator=generator)
        return {"logits": logits, "neutral": None, "gender": None, "pooled": None, "fused": None}

    def _forward_rows(self, feats, masks, n: int, generator=None) -> Dict:
        """The forward of a global batch of ``n`` rows: this rank's rows, then
        the outputs the loss reads gathered from every rank (``fused`` is
        not gathered: ``None`` on more than one rank)."""
        if self.mesh.data == 1:
            return self._forward(feats, masks, generator)

        def rows(f, m):
            out = self._forward(f, m, generator)
            return (out["logits"], out["neutral"], out["gender"], *(out["pooled"] or ()))

        logits, neutral, gender, *pooled = data_parallel(self.mesh, rows, (feats, masks), n)
        return {"logits": logits, "neutral": neutral, "gender": gender, "pooled": pooled or None, "fused": None}

    def _loss_terms(self, out: Dict, labels: torch.Tensor, sample_mask: torch.Tensor,
                    class_w: Optional[torch.Tensor], aux: Optional[torch.Tensor] = None):
        """-> (the loss to differentiate, the weighted CE that is logged; the
        dim task logs its loss)."""
        opt = self.opt
        logits = out["logits"]
        if opt.task == "dim":
            backward = losses.ccc_loss(logits, labels, sample_mask)
            if opt.mse_weight > 0:
                backward = backward + opt.mse_weight * losses.mse_emotion(logits, labels, sample_mask)
            return backward, backward
        y = labels.argmax(dim=1)
        if opt.unweighted_ce:
            class_w = None
        ce = losses.weighted_cross_entropy(logits, y, class_w, sample_mask)
        if self.loss_type == "focal":
            backward = losses.focal_loss(logits, y, alpha=1.0, gamma=opt.focal_gamma,
                                         dynamic_alpha=opt.focal_dynamic_alpha, sample_mask=sample_mask)
        elif self.loss_type == "labelsmooth":
            backward = losses.smoothed_cross_entropy(logits, y, opt.label_smoothing, class_w, sample_mask)
        elif self.loss_type == "hierarchical":
            backward = losses.hierarchical_loss(logits, y, class_w, sample_mask=sample_mask)
        elif self.loss_type == "f1":
            backward = losses.diff_f1_loss(logits, labels)  # every row, padding too (as the JAX engine)
            if opt.add_ce_to_f1:
                backward = backward + ce
        else:
            backward = ce
        if opt.ranking:
            y_neutral = (2 * labels[:, -1] - 1)[:, None]
            backward = backward + losses.soft_margin_loss(out["neutral"], y_neutral, sample_mask)
        if opt.cka_weight > 0 and out["pooled"] is not None:
            # the whole padded batch, as the JAX engine does
            backward = backward + opt.cka_weight * losses.cka_loss(out["pooled"][0], out["pooled"][1])
        if opt.gender_mode == "svm" and aux is not None:
            # hinge on the gender head x 0.01; the non-focal branch's CE is the
            # GENDER head's (the reference trainer's quirk, kept)
            svm = losses.svm_ranking_loss(out["gender"], aux, sample_mask=sample_mask)
            if self.loss_type != "focal":
                backward = losses.weighted_cross_entropy(out["gender"], aux, None, sample_mask)
            backward = backward + 0.01 * svm
        elif opt.gender_mode is not None and aux is not None:
            backward = backward + opt.gender_weight * losses.weighted_cross_entropy(
                out["gender"], aux, None, sample_mask)
        return backward, ce

    def accumulate_gradients(self, batch: Batch, class_w: Optional[torch.Tensor]):
        """Forward and backward of one (micro-)batch in training mode; the
        gradients add into ``.grad``. -> (loss, logged CE) as tensors."""
        self.model.train()
        feats, masks, labels, smask, aux = self._to_device(batch)
        out = self._forward_rows(feats, masks, labels.shape[0], generator=self.generator)
        backward, ce = self._loss_terms(out, labels, smask, class_w, aux)
        backward.backward()
        return backward.detach(), ce.detach()

    def apply_gradients(self, lr: float, n_micro: int = 1) -> None:
        """One AdamW step on the mean of ``n_micro`` accumulated gradients
        (summed over the data axis first: one all-reduce a step)."""
        all_reduce_grads(self.mesh, self.model.parameters())
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
        if self.mesh.is_main:
            os.makedirs(cfg.model_path, exist_ok=True)
        if self.device.type == "cuda":  # f32 parity mode
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        opt = self.opt
        dim = opt.task == "dim"
        label_cols = self.dim_columns if dim else L.CLASSES
        lazy_dirs, feat_dims = cfg.lazy_dirs, cfg.feat_dims
        if opt.model_variant == "single":
            lazy_dirs, feat_dims = (cfg.lazy_dir1,), (cfg.feat1_dim,)
        aux = None
        if opt.gender_mode is not None:
            if any("target_gender" not in r for r in train_rows):
                raise ValueError(f"gender_mode={opt.gender_mode!r} needs each train row's target_gender: merge "
                                 "the gender labels CSV in first (utils.labels.merge_gender)")
            aux = np.asarray([int(r["target_gender"]) for r in train_rows], np.int64)
        train_ds = LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows, label_cols),
                                      lazy_dirs, feat_dims, aux_labels=aux)
        val_ds = LazyFeatureDataset(L.column(val_rows, "FileName"), L.matrix(val_rows, label_cols),
                                    lazy_dirs, feat_dims)
        val_w, sample_weights, class_w = None, None, None
        if not dim:
            val_w = L.class_weights(val_rows)
            if opt.ranking:
                sample_weights = L.neutral_balanced_sample_weights(train_rows)
            elif cfg.use_balanced_batch:
                sample_weights = L.balanced_sample_weights(train_rows)
            # balanced batches -> unweighted CE; ranking keeps the train-weights CE
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
                                    bucket_window=opt.bucket_window)
            loader = PrefetchLoader(train_ds, batches, cfg.batch_size, opt.bucket_quantum)
            n_micro = 0
            for i, batch in enumerate(loader):
                _, ce = self.accumulate_gradients(batch, class_w)
                n_micro += 1
                if (i + 1) % cfg.accum_step == 0 or (i + 1) == len(loader):
                    self.apply_gradients(lr_e, n_micro)
                    n_micro = 0
                if (i + 2) % opt.log_every == 0:
                    logger.info(
                        f"Epoch ({epoch+1}/{cfg.epochs})| step = {i+1}: "
                        f"loss = {float(ce):.6f} current lr = {lr_e:.8g}"
                    )

            dev = self.evaluate(val_ds, val_weights=val_w)
            if dim:
                logger.info(f"|VALIDATION| Epoch ({epoch+1}/{cfg.epochs}): "
                            f"eval_loss = {dev['loss']:.6f} ccc = {dev['ccc']}")
                improved = dev["loss"] < best["dev_loss"]
            else:
                logger.info(f"|VALIDATION| Epoch ({epoch+1}/{cfg.epochs}): "
                            f"eval_loss = {dev['loss']:.6f} eval f1 = {dev['macro_f1']:.6f}")
                improved = dev["macro_f1"] > best["macro_f1"]
            if improved:
                logger.info(f"New best model at epoch {epoch+1}")
                best = {"epoch": epoch, "macro_f1": dev.get("macro_f1", 0.0), "dev_loss": dev["loss"]}
                self.save_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"))
            if self.mesh.is_main:
                checkpointing.save_train_state(
                    cfg.model_path, self.model, self.optimizer, epoch, best, self.rng, self.generator
                )
            if stop_after_epoch is not None and epoch >= stop_after_epoch:
                logger.info(f"Stopping after epoch {epoch} (stop_after_epoch)")
                break
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    # -- evaluation / scoring ---------------------------------------------------

    @torch.inference_mode()
    def predict(self, dataset: LazyFeatureDataset) -> np.ndarray:
        """Logits (the dim task's attributes) for every sample, in dataset
        order (batches of the config's ``batch_size``, length-sorted, time
        padded to multiples of 64; on several ranks each runs its rows and
        the logits are gathered)."""
        self.model.eval()
        bs = self.cfg.batch_size
        n = len(dataset)
        order = np.argsort(dataset.primary_lengths(), kind="stable")
        out = np.zeros((n, self.num_out), np.float32)
        for start in range(0, n, bs):
            idxs = order[start : start + bs].tolist()
            feats, masks, _, _, _ = self._to_device(dataset.collate(idxs, bs, self.opt.bucket_quantum))
            logits = self._forward_rows(feats, masks, bs)["logits"].float().cpu().numpy()
            out[idxs] = logits[: len(idxs)]
        return out

    def evaluate(self, dataset: LazyFeatureDataset, val_weights: Optional[np.ndarray] = None) -> Dict:
        """Logits, macro-F1 and the CE weighted by ``val_weights`` (the
        unweighted mean without them, as the reference eval logs); for the
        dim task the per-attribute CCC and the loss ``n_attr - sum CCC``."""
        logits = self.predict(dataset)
        if self.opt.task == "dim":
            labels = np.asarray(dataset.labels, np.float32)
            cccs = [concordance_ccc(logits[:, i], labels[:, i]) for i in range(logits.shape[1])]
            return {"loss": float(logits.shape[1]) - sum(cccs), "ccc": cccs, "logits": logits}
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
    reference quirk). Rank 0 writes; every rank returns the path."""
    out = os.path.join(model_path, "results", f"{dtype}.csv")
    if not is_main():
        return out
    os.makedirs(os.path.join(model_path, "results"), exist_ok=True)
    headers = [filename_header, "Prediction"] + [f"class_{i}_prob" for i in range(logits.shape[1])]
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        for utt, row in zip(utts, logits):
            w.writerow([utt, L.INDEX_TO_LETTER[int(np.argmax(row))]] + [f"{p:.4f}" for p in row])
    return out
