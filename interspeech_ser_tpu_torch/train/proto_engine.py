"""Angular-prototypical style-embedding trainers.

    python -m interspeech_ser_tpu_torch.train.proto_engine <bin/old stem> --config_path <cfg> [--seed 7] \\
        [--gender_labels_csv <csv>] [--device cpu]

Port of ``interspeech_ser_tpu/train/proto_engine.py``.

- ``StyleEmbeddingNet`` (projection -> BiGRU -> attention pooling ->
  embedding [+ classifier]) under ``ProtoAngularEngine``: class-balanced
  batches (``PerfectBatchSampler``), embeddings grouped [C, U, D] into the
  angular prototypical loss (+ CE with ``use_softmax_proto``), AdamW (weight
  decay 1e-6) on the net and a second AdamW with optax's default decay (1e-4)
  on the loss's learnable scale (w, b) = (10, -5).
- The "_only" family of the five ``bin/old/*protoangularloss*`` wrappers
  (``STEMS``, ``proto_main``): ``ProtoSERNet`` (dropout -> Dense -> plain
  multi-head attention -> LN residual -> Conv1d(k3) -> LN -> softmax pooling
  [+ classifier]) or ``BidirectionalReferenceEncoder`` (6 x Conv2d(3x3, s2)
  + BatchNorm + ReLU over a log-mel, a BiGRU, its two final states) under
  ``ProtoOnlyEngine``: class-major batches padded to a 16-frame quantum, the
  angle-proto loss with (w, b) fixed at (10, -5) (+ CE in ``ce_mode``), RAdam
  with a per-step cosine to 0, the lowest mean val angle loss (or dev CE in
  ``ce_mode``) saved as ``angle_ser.pt`` (``ser.pt``) with the reference's
  flat names (the nets' own state-dict keys).

On the card every BiGRU runs kernel K3 forward and K3b backward
(``ops/gru.BiGRU``); the JAX package runs ``lax.scan`` there, the same
function. ``ProtoSERNet`` launches no kernel. The proto nets are unmasked by
the reference's design (``ProtoSERNet``'s attention and pooling, the
reference encoder's convs and GRU), so a padded batch is not the batch-1
forward, as in the JAX package. BatchNorm keeps flax's running statistics
(``ops/batch_norm.py``). Dropout draws from the engine's seeded
``torch.Generator``; a net runs it only when given one.

Both engines are data-parallel over the ranks of a process group
(``n_devices``, ``None``: the world's; ``parallel/mesh.py``): each rank runs
its rows of a class-major batch, the embeddings (and logits) are gathered
so that every rank computes the batch's grouped loss, as the JAX step
all-gathers its [B, D] embeddings, and one all-reduce of the net's
gradients precedes each step (the loss's learnable (w, b), outside the
per-rank forward, have the whole gradient on every rank and are not
reduced). The reference encoder's BatchNorm takes the global moments
(``ops/batch_norm.sync``). The grouped loss cannot take masked rows, so the
data axis must divide C x U (and C x U_val), or the engine raises, where the
JAX engines shrink the mesh to a divisor (ROADMAP.md §C).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import TorchMultiheadAttention, attention_pool
from ..ops.attention_core import dropout
from ..ops.batch_norm import RunningBatchNorm, sync
from ..ops.gru import BiGRU
from ..parallel.mesh import Mesh, all_reduce_grads, barrier, data_parallel, make_mesh, replicate
from ..utils.device import DEVICES, init_distributed, resolve_device, teardown
from ..utils.seeding import numpy_generator
from . import losses
from .information_encoder import FILTERS, conv_out
from .samplers import PerfectBatchSampler


class StyleEmbeddingNet(nn.Module):
    """feats [B, T, feat_dim] (+ frame mask) -> embedding [B, embedding_dim]
    (and class logits when ``num_classes > 0``)."""

    def __init__(self, feat_dim: int, hidden_dim: int = 256, embedding_dim: int = 256, num_classes: int = 0):
        super().__init__()
        self.projection = nn.Linear(feat_dim, hidden_dim)
        self.gru = BiGRU(hidden_dim, hidden_dim)
        self.pool_attn = nn.Linear(2 * hidden_dim, 1)
        self.embedding = nn.Linear(2 * hidden_dim, embedding_dim)
        self.classifier = nn.Linear(embedding_dim, num_classes) if num_classes > 0 else None

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = self.gru(self.projection(feats), mask)
        emb = self.embedding(attention_pool(h, self.pool_attn(h), mask))
        return emb if self.classifier is None else (emb, self.classifier(emb))


def _divisible_mesh(n_devices: Optional[int], *batch_sizes: int) -> Mesh:
    """The mesh, when its data axis divides every fixed batch size; else raise."""
    mesh = make_mesh(n_devices)
    bad = [b for b in batch_sizes if b % mesh.data]
    if bad:
        raise ValueError(f"{mesh.data} data ranks do not divide the class-major batch of {bad[0]} rows: the "
                         "grouped angular loss takes no padding rows (the JAX engines shrink the mesh)")
    return mesh


class ProtoAngularEngine:
    """Train a style embedder on angular-prototypical batches of C classes x U
    utterances."""

    def __init__(
        self,
        feat_dim: int,
        num_classes: int = 8,
        utter_per_class: int = 4,
        embedding_dim: int = 256,
        use_softmax_proto: bool = False,
        seed: int = 7,
        n_devices: Optional[int] = None,
        device="cuda",  # "cpu" only when asked: no card raises
    ):
        self.device = resolve_device(device)
        self.mesh = _divisible_mesh(n_devices, num_classes * utter_per_class)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = StyleEmbeddingNet(feat_dim, embedding_dim=embedding_dim,
                                           num_classes=num_classes if use_softmax_proto else 0).to(self.device)
        replicate(self.mesh, self.model)
        self.num_classes, self.utter_per_class = num_classes, utter_per_class
        self.use_softmax_proto = use_softmax_proto
        self.rng = numpy_generator(seed)

    def step_loss(self, feats: torch.Tensor, mask: torch.Tensor, y: torch.Tensor, wb) -> tuple:
        """(total, angle-proto) of one batch; ``wb`` the loss's (w, b). Each
        rank embeds its rows; the loss is the whole batch's."""
        out = data_parallel(self.mesh, self.model, (feats, mask), feats.shape[0])
        emb, ce = (out[0], losses.weighted_cross_entropy(out[1], y)) if self.use_softmax_proto else (out, 0.0)
        ap = losses.angle_proto_loss(emb.reshape(self.num_classes, self.utter_per_class, -1), *wb)
        return ap + ce, ap

    def fit(self, dataset, class_ids: np.ndarray, epochs: int = 5, lr: float = 1e-4, log=print) -> Dict:
        """``epochs`` passes of ``PerfectBatchSampler`` batches (a new seed from
        the engine's generator each epoch) -> the last step's ``loss`` and
        ``angle_proto``; the optimizers and (w, b) start afresh each call, as
        in the JAX engine."""
        C, U = self.num_classes, self.utter_per_class
        batch_size = C * U
        dev = self.device
        log = self.mesh.main_only(log)
        opt = torch.optim.AdamW(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-6)
        wb = [nn.Parameter(torch.tensor(10.0, device=dev)), nn.Parameter(torch.tensor(-5.0, device=dev))]
        # optax.adamw(lr)'s defaults: weight decay 1e-4, not torch's 1e-2
        wb_opt = torch.optim.AdamW(wb, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        self.model.train()
        last = None
        for epoch in range(epochs):
            sampler = PerfectBatchSampler(class_ids, range(C), batch_size, shuffle=True, drop_last=True,
                                          seed=int(self.rng.integers(0, 2 ** 31)))
            last = None
            for idxs in sampler:
                batch = dataset.collate(list(idxs), batch_size)
                y = torch.from_numpy(np.argmax(batch.labels, axis=1)).to(dev)
                total, ap = self.step_loss(torch.from_numpy(batch.feats[0]).to(dev),
                                           torch.from_numpy(batch.masks[0]).to(dev), y, wb)
                opt.zero_grad(set_to_none=True)
                wb_opt.zero_grad(set_to_none=True)
                total.backward()
                all_reduce_grads(self.mesh, self.model.parameters())
                opt.step()
                wb_opt.step()
                last = (float(total.detach()), float(ap.detach()))
            if last:
                log(f"epoch {epoch}: loss={last[0]:.4f} angle_proto={last[1]:.4f}")
        return {"loss": last[0] if last else float("nan"), "angle_proto": last[1] if last else float("nan")}

    @torch.inference_mode()
    def embed(self, dataset, batch_size: int = 16) -> np.ndarray:
        """[N, embedding_dim] embeddings in the dataset's order (batches of
        ``batch_size`` rows; the last one padded with empty rows, sliced off)."""
        self.model.eval()
        out = []
        for s in range(0, len(dataset), batch_size):
            idxs = list(range(s, min(s + batch_size, len(dataset))))
            b = dataset.collate(idxs, batch_size)
            o = data_parallel(self.mesh, self.model, (torch.from_numpy(b.feats[0]).to(self.device),
                                                      torch.from_numpy(b.masks[0]).to(self.device)), batch_size)
            emb = o[0] if self.use_softmax_proto else o
            out.append(emb.float().cpu().numpy()[: len(idxs)])
        return np.concatenate(out)


# ---------------------------------------------------------------------------
# The "_only" proto-angular family: the reference nets, RAdam + per-step cosine,
# angle-proto-only training, min-val-angle model selection -> angle_ser.pt.
# ---------------------------------------------------------------------------


class ProtoSERNet(nn.Module):
    """The reference ``WavLMSERClassifier`` of the proto-angular trainers:
    input dropout(0.5) -> Linear(hidden) -> self-attention (heads, dropout
    0.5) -> LN residual -> Conv1d(k3, p1) -> LN -> softmax pooling over time
    -> embeddings [B, hidden]; ``num_classes > 0`` adds the classifier
    (Linear, ReLU, dropout 0.2, Linear). Attention and pooling are
    unmasked, as in the reference. Every dropout runs only with a
    ``generator`` (training)."""

    def __init__(self, feat_dim: int, hidden_dim: int = 512, num_classes: int = 8, num_heads: int = 1):
        super().__init__()
        self.wav_proj = nn.Linear(feat_dim, hidden_dim)
        self.multihead_attn = TorchMultiheadAttention(hidden_dim, num_heads, dropout=0.5)
        self.attn_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.conv1d = nn.Conv1d(hidden_dim, hidden_dim, 3, padding=1)
        self.conv_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.attn_pooling = nn.Linear(hidden_dim, 1)
        self.classifier = (nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.ReLU(), nn.Dropout(0.2),
                                         nn.Linear(hidden_dim, num_classes)) if num_classes > 0 else None)

    def forward(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None):
        train = generator is not None
        h = self.wav_proj(dropout(feats, 0.5 if train else 0.0, generator))
        self.multihead_attn.training = train  # its attention dropout runs with the generator only
        h = self.attn_norm(self.multihead_attn(h, h, h, generator=generator) + h)
        c = self.conv_norm(self.conv1d(h.transpose(1, 2)).transpose(1, 2))
        emb = (c * torch.softmax(self.attn_pooling(c), dim=1)).sum(dim=1)
        if self.classifier is None:
            return emb
        x = dropout(F.relu(self.classifier[0](emb)), 0.2 if train else 0.0, generator)
        return emb, self.classifier[3](x)


class BidirectionalReferenceEncoder(nn.Module):
    """Prosody / style embedder over log-mel [B, T, num_mel]: 6 x [Conv2d(3x3,
    stride 2, pad 1) -> BatchNorm -> ReLU] over [B, 1, T, mel], the channel-
    major flatten [B, C, T', H'] -> [B, T', C * H'], a BiGRU of
    ``embedding_dim // 2`` (unmasked), and the forward direction's state at
    T' - 1 beside the backward one's at 0 -> [B, embedding_dim]."""

    def __init__(self, num_mel: int = 80, embedding_dim: int = 256):
        super().__init__()
        chans = (1,) + FILTERS
        self.convs = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1) for i in range(6))
        self.bns = nn.ModuleList(RunningBatchNorm(f) for f in FILTERS)
        self.hidden = embedding_dim // 2
        self.recurrence = BiGRU(FILTERS[-1] * conv_out(num_mel), self.hidden)

    def forward(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = mel[:, None].float()
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        x = x.transpose(1, 2)  # [B, T', C, H']
        seq = self.recurrence(x.reshape(x.shape[0], x.shape[1], -1))
        H = self.hidden
        return torch.cat([seq[:, -1, :H], seq[:, 0, H:]], dim=-1)


def _regroup_class_major(n_utter: int, n_classes: int) -> np.ndarray:
    """The reference's regroup of class-interleaved rows [c0 c1 ... c0 c1 ...]
    into class-major groups (``transpose(x.view(U, C, -1), 0, 1)``), as a row
    permutation. ``ProtoOnlyEngine`` does not apply it: ``PerfectBatchSampler``
    already yields class-major batches."""
    return np.arange(n_utter * n_classes).reshape(n_utter, n_classes).T.reshape(-1)


class MelspecProtoDataset:
    """wav dir -> log-mel [T, 80] computed when read (torchaudio semantics,
    ``ops/melspec_ta.py``, with the reference's ``mel_sample_rate``).
    ``perturb_prob > 0``: a read wav is timbre-perturbed first with that
    probability. Both the choice and the formant shift draw from
    ``np.random.default_rng(seed)``; the JAX package draws the shift from an
    unseeded generator, so its runs do not repeat (ROADMAP.md §C)."""

    def __init__(self, names, labels: np.ndarray, wav_dir: str, mel_sample_rate: int = 1600,
                 perturb_prob: float = 0.0, seed: int = 7):
        from ..ops.melspec_ta import TorchaudioMelSpectrogram

        self.names = list(names)
        self.labels = np.asarray(labels)
        self.wav_dir = wav_dir
        self.mel = TorchaudioMelSpectrogram(sample_rate=mel_sample_rate)
        self.perturb_prob = perturb_prob
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.names)

    def features(self, idx: int) -> np.ndarray:
        from ..utils.audio import load_wav
        from .information_encoder import fixed_timbre_perturb

        wav, _ = load_wav(os.path.join(self.wav_dir, self.names[idx]), target_sr=16000)
        if self.perturb_prob > 0 and self.rng.random() < self.perturb_prob:
            wav = fixed_timbre_perturb(wav, sr=16000, segment_size=16000 // 2, formant_rate=1.4,
                                       pitch_steps=0.01, pitch_floor=75, pitch_ceil=600, rng=self.rng)
        return self.mel(wav)


class LazyProtoDataset:
    """Cached ``<utt>.pt`` features, one per ``FileName``."""

    def __init__(self, names, labels: np.ndarray, lazy_dir: str):
        self.names = list(names)
        self.labels = np.asarray(labels)
        self.lazy_dir = lazy_dir

    def __len__(self):
        return len(self.names)

    def features(self, idx: int) -> np.ndarray:
        from ..utils import ptio

        return np.asarray(ptio.load_tensor(os.path.join(self.lazy_dir, self.names[idx].replace(".wav", ".pt"))),
                          np.float32)


def cosine_lr(lr: float, count: int, total: int) -> float:
    """optax ``cosine_decay_schedule(lr, total)`` at update ``count``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))


class ProtoOnlyEngine:
    """Angle-proto trainer of the legacy "_only" scripts (and, in ``ce_mode``,
    of the base protoangular one):
    - ``PerfectBatchSampler`` over the C target classes, train shuffled
      (a new seed from the engine's generator each epoch), val in order, both
      drop_last; no permutation of the class-major batches;
    - the angle-proto loss with (w, b) fixed at (10, -5) (the reference's
      optimizer holds only the net's parameters); ``ce_mode`` adds the
      unweighted CE of the logits, scores dev in sequential batches of
      ``val_batch_size`` (val-weighted CE, macro-F1) and saves ``ser.pt``;
    - RAdam(lr, (0.9, 0.999), 1e-8) with a per-step cosine to 0 over
      ``epochs * ceil(N / (C * U))`` steps;
    - the epoch of the lowest mean val angle loss (dev CE) saved to
      ``angle_ser.pt`` (``ser.pt``)."""

    def __init__(
        self,
        net: nn.Module,
        num_classes_in_batch: int,
        num_utter_per_class: int,
        num_utter_per_class_val: int,
        seed: int = 7,
        bucket_quantum: int = 16,
        ce_mode: bool = False,
        val_batch_size: int = 32,
        n_devices: Optional[int] = None,
        device="cuda",  # "cpu" only when asked: no card raises
    ):
        self.device = resolve_device(device)
        self.mesh = _divisible_mesh(n_devices, num_classes_in_batch * num_utter_per_class,
                                    num_classes_in_batch * num_utter_per_class_val)
        self.net = sync(net.to(self.device), self.mesh)
        replicate(self.mesh, self.net)
        self.C, self.U, self.U_val = num_classes_in_batch, num_utter_per_class, num_utter_per_class_val
        self.ce_mode, self.val_batch_size = ce_mode, val_batch_size
        self.bucket_quantum = bucket_quantum
        self.rng = numpy_generator(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the nets' dropout

    def collate(self, dataset, idxs) -> tuple:
        """(feats [len(idxs), T, F] with T the longest rounded up to the
        bucket quantum, int64 labels); rows in ``idxs``' order."""
        feats = [dataset.features(i) for i in idxs]
        q = self.bucket_quantum
        t_pad = -(-max(f.shape[0] for f in feats) // q) * q
        out = np.zeros((len(feats), t_pad, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            out[i, : f.shape[0]] = f
        return out, np.asarray([dataset.labels[i] for i in idxs], np.int64)

    def forward(self, feats: np.ndarray, train: bool):
        """The net on a host batch: training mode (BatchNorm's batch moments,
        dropout from the engine's generator) or eval; each rank runs its rows,
        the outputs are gathered."""
        self.net.train(train)
        gen = self.generator if train else None
        return data_parallel(self.mesh, lambda x: self.net(x, gen), (torch.from_numpy(feats).to(self.device),),
                             len(feats))

    def angle_loss(self, out) -> torch.Tensor:
        emb = out[0] if isinstance(out, tuple) else out
        return losses.angle_proto_loss(emb.reshape(self.C, emb.shape[0] // self.C, -1), 10.0, -5.0)

    def train_loss(self, feats: np.ndarray, y: np.ndarray) -> torch.Tensor:
        out = self.forward(feats, True)
        loss = self.angle_loss(out)
        if self.ce_mode:
            loss = loss + losses.weighted_cross_entropy(out[1], torch.from_numpy(y).to(self.device))
        return loss

    def fit(self, train_ds, val_ds, epochs: int, lr: float, model_path: Optional[str] = None, log=print) -> Dict:
        """-> ``{"epoch", "val_angle"}`` of the best epoch (``val_angle`` is the
        dev CE in ``ce_mode``); the net ends at the last epoch's parameters."""
        C, U, U_val = self.C, self.U, self.U_val
        log = self.mesh.main_only(log)
        total = epochs * math.ceil(len(train_ds) / (C * U))
        opt = torch.optim.RAdam(self.net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        step = 0
        best = {"epoch": -1, "val_angle": float("inf")}
        for epoch in range(epochs):
            sampler = PerfectBatchSampler(np.asarray(train_ds.labels), range(C), C * U, shuffle=True, drop_last=True,
                                          seed=int(self.rng.integers(0, 2 ** 31)))
            last = None
            for idxs in sampler:
                for group in opt.param_groups:
                    group["lr"] = cosine_lr(lr, step, total)
                loss = self.train_loss(*self.collate(train_ds, list(idxs)))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                all_reduce_grads(self.mesh, self.net.parameters())
                opt.step()
                step += 1
                last = float(loss.detach())
            if self.ce_mode:
                v, f1 = self.eval_ce(val_ds)
                log(f"epoch {epoch + 1}/{epochs}: train loss={last:.4f} dev CE={v:.4f} dev f1={f1:.4f}")
                ckpt_name = "ser.pt"
            else:
                v = self.val_angle(val_ds)
                log(f"epoch {epoch + 1}/{epochs}: train angle={last:.4f} val angle={v:.4f}")
                ckpt_name = "angle_ser.pt"
            if v < best["val_angle"]:
                best = {"epoch": epoch, "val_angle": v}
                if model_path:
                    self.save_torch_checkpoint(os.path.join(model_path, ckpt_name))
        barrier(self.mesh)  # rank 0's files are written when fit returns on any rank
        return best

    @torch.inference_mode()
    def val_angle(self, val_ds) -> float:
        """Mean angle-proto loss over the val split's class-major batches of
        C x U_val (in order, drop_last); nan when there are none."""
        sampler = PerfectBatchSampler(np.asarray(val_ds.labels), range(self.C), self.C * self.U_val,
                                      shuffle=False, drop_last=True)
        v = [float(self.angle_loss(self.forward(self.collate(val_ds, list(idxs))[0], False))) for idxs in sampler]
        return float(np.mean(v)) if v else float("nan")

    @torch.inference_mode()
    def eval_ce(self, val_ds) -> tuple:
        """(val-weighted CE, macro-F1) of the logits over sequential batches of
        ``val_batch_size`` rows (the tail that fills no batch is dropped)."""
        from ..utils.metrics import macro_f1

        bs = self.val_batch_size
        logits_all, y_all = [], []
        for s0 in range(0, len(val_ds) - len(val_ds) % bs, bs):
            feats, y = self.collate(val_ds, list(range(s0, s0 + bs)))
            logits_all.append(self.forward(feats, False)[1].float().cpu().numpy())
            y_all.append(y)
        logits, y = np.concatenate(logits_all), np.concatenate(y_all)
        n_cls = logits.shape[1]
        classes, counts = np.unique(y, return_counts=True)
        w = np.zeros(n_cls, np.float32)
        for c, cnt in zip(classes, counts):
            w[c] = len(y) / (n_cls * cnt)
        z = logits - logits.max(1, keepdims=True)
        nll = -(z - np.log(np.exp(z).sum(1, keepdims=True)))[np.arange(len(y)), y]
        return float((nll * w[y]).sum() / w[y].sum()), macro_f1(y, logits.argmax(1), n_cls)

    def save_torch_checkpoint(self, path: str) -> None:
        """The net's state dict: the reference's flat module names (rank 0 writes)."""
        from ..utils import ptio

        if not self.mesh.is_main:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ptio.save_state_dict(self.net.state_dict(), path)


# variant -> its net (made from the config), target, C, U, U_val, data, timbre perturbation, mel bank rate
_PROTO_VARIANTS = {
    "wavlm_only": dict(
        net=lambda cfg: ProtoSERNet(cfg.get("feat1_dim", 1024), 512, 8, 1),
        target="emotion", C=8, U=10, U_val=5, data="lazy",
    ),
    # the base (non-"_only") trainer: CE + angle, dev CE / F1 selection -> ser.pt
    "wavlm_ce": dict(
        net=lambda cfg: ProtoSERNet(cfg.get("feat1_dim", 1024), 512, 8, 1),
        target="emotion", C=8, U=10, U_val=5, data="lazy", ce=True,
    ),
    "melspec_only": dict(
        net=lambda cfg: ProtoSERNet(80, 128, 8, 1),
        target="emotion", C=8, U=10, U_val=5, data="melspec",
        perturb=0.5, mel_sr=1600,  # the reference passes sample_rate=1600
    ),
    "melspec_only_gender": dict(
        net=lambda cfg: BidirectionalReferenceEncoder(80, 256),
        target="gender", C=2, U=32, U_val=32, data="melspec", perturb=0.0, mel_sr=16000,
    ),
    "wavlm_only_gender": dict(
        net=lambda cfg: ProtoSERNet(cfg["hidden_dim"], 512, 0, 4),
        target="gender", C=2, U=32, U_val=32, data="lazy",
    ),
}

# bin/old wrapper stem -> _PROTO_VARIANTS entry
STEMS = {
    "train_cat_wavlm_lazy_protoangularloss_only": "wavlm_only",
    "train_cat_wavlm_lazy_protoangularloss": "wavlm_ce",
    "train_cat_melspec_lazy_protoangularloss_only": "melspec_only",
    "train_cat_melspec_lazy_protoangularloss_only_gender": "melspec_only_gender",
    "train_cat_wavlmlarge_lazy_protoangularloss_only_gender": "wavlm_only_gender",
}
GENDER_TARGETS = {"Female": 0, "Male": 1}


def proto_rows(label_path: str, target: str, gender_labels_csv: Optional[str] = None) -> list:
    """The label CSV's rows with an int ``target``: the arg-max emotion, or
    the gender (Female 0, Male 1; from ``gender_labels_csv``, left-merged on
    ``FileName``, when the label CSV has no ``Gender`` column), rows of any
    other gender dropped."""
    from ..utils import labels as L

    rows = L.read_csv(label_path)
    if target == "gender":
        if rows and "Gender" not in rows[0]:
            if not gender_labels_csv:
                raise ValueError("the gender variants need --gender_labels_csv (or GENDER_LABELS_CSV) when the "
                                 "label CSV has no Gender column")
            rows = L.merge_gender(rows, gender_labels_csv)
        return [{**r, "target": GENDER_TARGETS[r["Gender"]]} for r in rows if r["Gender"] in GENDER_TARGETS]
    y = np.argmax(L.matrix(rows, L.CLASSES), axis=1)
    return [{**r, "target": int(t)} for r, t in zip(rows, y)]


def proto_main(variant: str, argv=None) -> dict:
    """One ``_PROTO_VARIANTS`` trainer. Flags: ``--seed``, ``--config_path``,
    ``--gender_labels_csv`` (default ``$GENDER_LABELS_CSV``), ``--device``;
    config keys: ``audio_lazy_dir`` (or ``wav_dir``), ``label_path``,
    ``epochs``, ``lr``, ``model_path`` (+ ``hidden_dim``, the wavlm gender
    variant's feature width; ``feat1_dim``; ``batch_size``, ``ce_mode``'s dev
    batch). -> the best epoch and its val loss."""
    from ..utils.seeding import set_deterministic
    from .engine import setup_run_logging

    spec = _PROTO_VARIANTS[variant]
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--config_path", type=str, default="./configs/config_cat.json")
    ap.add_argument("--gender_labels_csv", type=str, default=os.environ.get("GENDER_LABELS_CSV"))
    ap.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                    help="where the net trains; without a card 'cuda' raises")
    args = ap.parse_args(argv)
    init_distributed(args.device)
    device = resolve_device(args.device)
    set_deterministic(seed=args.seed)
    with open(args.config_path) as f:
        cfg = json.load(f)
    logger = setup_run_logging(cfg["model_path"])
    rows = proto_rows(cfg["label_path"], spec["target"], args.gender_labels_csv)

    def build(split: str, seed: int):
        part = [r for r in rows if r["Split_Set"] == split]
        names = [r["FileName"] for r in part]
        y = np.asarray([r["target"] for r in part], np.int64)
        if spec["data"] == "melspec":
            return MelspecProtoDataset(names, y, cfg.get("audio_lazy_dir", cfg.get("wav_dir")),
                                       mel_sample_rate=spec.get("mel_sr", 16000),
                                       perturb_prob=spec.get("perturb", 0.0), seed=seed)
        return LazyProtoDataset(names, y, cfg["audio_lazy_dir"])

    train_ds, val_ds = build("Train", args.seed), build("Development", args.seed + 1)
    engine = ProtoOnlyEngine(spec["net"](cfg), spec["C"], spec["U"], spec["U_val"], seed=args.seed,
                             ce_mode=spec.get("ce", False), val_batch_size=int(cfg.get("batch_size", 32)),
                             device=device)
    best = engine.fit(train_ds, val_ds, epochs=cfg["epochs"], lr=cfg["lr"], model_path=cfg["model_path"],
                      log=logger.info)
    logger.info(f"Best epoch {best['epoch'] + 1}: val angle loss = {best['val_angle']:.6f}")
    return best


def main(argv=None) -> dict:
    """``<stem> [flags]``: the ``bin/old`` wrapper of that stem's trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in STEMS:
        raise SystemExit(f"usage: proto_engine <stem> [--config_path cfg] [--seed N] [--gender_labels_csv csv] "
                         f"[--device cuda|cpu]; stems: {', '.join(STEMS)}")
    return proto_main(STEMS[argv[0]], argv[1:])


if __name__ == "__main__":
    main()
    teardown()
