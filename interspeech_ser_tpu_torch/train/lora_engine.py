"""LoRA fine-tuning of a speech or Whisper encoder with a mean-pool classifier.

Port of ``interspeech_ser_tpu/train/lora_engine.py`` (``MeanPoolClassifier``,
``WavLMWrapperModel``, ``uar``, ``ReduceLROnPlateau`` and ``LoRAFTEngine``).
``WavLMWrapperModel`` is the layer-weighted head of ``lora_wavlm``
(``lora_model.build_wavlm_wrapper``). The production fine-tune whose checkpoint feeds the
``*_pretrained`` extraction CLIs: encoder -> mean pool over valid frames ->
Linear(512) -> ReLU -> Dropout(0.5) -> Linear(num_emotions).

Training updates only the LoRA factors and the head: the encoder's weights
are frozen (``requires_grad_(False)``) and each forward merges ``W + (alpha/r)
A @ B`` into the adapted weights through ``torch.func.functional_call``, so
autograd reaches the factors through the merge. On the card every attention
of that forward runs K1 and its backward K4 (``ops/attention_core.py``).
AdamW (lr 5e-4, weight decay 1e-2, optax's defaults otherwise), weighted
CE, the epoch order from ``numpy_generator(0)``, batches padded to whole
multiples of 3200 samples, and the dev UAR fed to a plateau scheduler, as
in the JAX engine. Whisper batches are padded or cut to 30 s, turned into
a log-mel on the device, and pooled over frames with ``t * 320 < samples``.

Data-parallel over the ranks of a process group (``n_devices``, ``None``:
the world's; ``parallel/mesh.py``): each batch is padded to a multiple of
the data axis with zero-weight rows, each rank runs its rows (K1 + K4 per
rank), the logits are gathered so that every rank computes the batch's CE,
and one all-reduce of the trainable gradients (the LoRA factors and the
head, never the frozen encoder) precedes each step. Rank 0 alone logs and
saves.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..extract.pipeline import WhisperExtractionPipeline
from ..models import lora as lora_lib
from ..models.loader import build_speech_encoder, build_whisper_encoder, read_config
from ..ops.attention_core import dropout
from ..ops.mel import whisper_log_mel
from ..parallel.mesh import all_reduce_grads, data_parallel, make_mesh, replicate
from ..utils import ptio
from ..utils.audio import normalize_waveform
from ..utils.device import resolve_device
from ..utils.seeding import numpy_generator
from . import losses

SAMPLE_QUANTUM = 3200  # batches pad to whole multiples of 0.2 s


class MeanPoolClassifier(nn.Module):
    """last_hidden_state mean-pooled over valid frames -> 512 MLP -> logits."""

    def __init__(self, hidden_size: int, num_emotions: int = 8, dropout_p: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, 512)
        self.fc2 = nn.Linear(512, num_emotions)
        self.dropout_p = dropout_p

    def forward(self, feats, frame_mask=None, generator: Optional[torch.Generator] = None):
        feats = feats.float()
        if frame_mask is not None:
            m = frame_mask.float()
            pooled = (feats * m[:, :, None]).sum(dim=1) / m.sum(dim=1, keepdim=True).clamp_min(1.0)
        else:
            pooled = feats.mean(dim=1)
        h = torch.relu(self.fc1(pooled))
        h = dropout(h, self.dropout_p if self.training else 0.0, generator)
        return self.fc2(h)


class WavLMWrapperModel(nn.Module):
    """The layer-weighted head: a softmax-weighted sum of the hidden states
    (``layer_weights`` ones / (L + 1) over all L + 1 states with
    ``use_conv_output``, else zeros over the L layer outputs), three pointwise
    "conv" Linears with ReLU and dropout 0.1 after the first two, a mean over
    time (over the first ``lengths`` frames when given), then Linear -> ReLU
    -> Linear. Names as the JAX package's (``seq{i}``, ``out1``, ``out2``)."""

    def __init__(self, num_layers: int, hidden_size: int, hidden_dim: int = 256, output_class_num: int = 4,
                 use_conv_output: bool = True):
        super().__init__()
        self.use_conv_output = use_conv_output
        self.dropout_p = 0.1
        n = num_layers + 1 if use_conv_output else num_layers
        self.layer_weights = nn.Parameter(torch.full((n,), 1.0 / n) if use_conv_output else torch.zeros(n))
        for i in range(3):
            setattr(self, f"seq{i}", nn.Linear(hidden_size if i == 0 else hidden_dim, hidden_dim))
        self.out1 = nn.Linear(hidden_dim, hidden_dim)
        self.out2 = nn.Linear(hidden_dim, output_class_num)

    def forward(self, hidden_states: Sequence[torch.Tensor], lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        states = hidden_states if self.use_conv_output else hidden_states[1:]
        h = torch.einsum("l,lbtd->btd", torch.softmax(self.layer_weights, dim=0),
                         torch.stack([s.float() for s in states]))
        p = self.dropout_p if self.training else 0.0
        for i in range(3):
            h = getattr(self, f"seq{i}")(h)
            if i < 2:
                h = dropout(torch.relu(h), p, generator)
        if lengths is None:
            pooled = h.mean(dim=1)
        else:
            mask = (torch.arange(h.shape[1], device=h.device)[None, :] < lengths[:, None]).to(h.dtype)
            pooled = (h * mask[:, :, None]).sum(dim=1) / lengths[:, None].to(h.dtype).clamp_min(1.0)
        return self.out2(torch.relu(self.out1(pooled)))


def uar(y_true, y_pred, num_classes: int) -> float:
    """Unweighted average recall over the classes present in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    recalls = [float((y_pred[y_true == c] == c).mean()) for c in range(num_classes) if (y_true == c).any()]
    return float(np.mean(recalls)) if recalls else 0.0


class ReduceLROnPlateau:
    """Host-side torch-equivalent scheduler (mode=min)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 2, min_lr: float = 1e-7):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


def pad_batch(wavs: Sequence[np.ndarray], rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """[rows, L] waveforms and sample mask, L the longest rounded up to 3200."""
    L = -(-max(len(w) for w in wavs) // SAMPLE_QUANTUM) * SAMPLE_QUANTUM
    wav = np.zeros((rows, L), np.float32)
    mask = np.zeros((rows, L), np.float32)
    for r, w in enumerate(wavs):
        wav[r, : len(w)] = w
        mask[r, : len(w)] = 1
    return wav, mask


class LoRAFTEngine:
    """Fine-tune a speech or Whisper encoder with LoRA and a classifier head."""

    def __init__(
        self,
        ssl_type: str,  # a local HF-format directory
        rank: int = 8,
        alpha: float = 16.0,
        target: str = "qv",  # 'qv' (peft variant) | 'ffn' (loralib variant)
        num_emotions: int = 8,
        seed: int = 7,
        dtype: str = "float32",
        device="cuda",  # "cpu" only when asked: no card raises
        n_devices: Optional[int] = None,  # ranks (one process each); None: the world's
    ):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        self.is_whisper = read_config(ssl_type).get("model_type") == "whisper"
        if self.is_whisper:
            if target != "qv":
                raise ValueError(
                    "whisper LoRA targets q/v projections (peft variant); 'ffn' matches no whisper parameter names"
                )
            model, self.cfg = build_whisper_encoder(ssl_type, dtype=dtype)
            self.do_normalize = False  # the Whisper frontend is a log-mel, not z-norm
            hidden = self.cfg.d_model
        else:
            model, self.cfg, self.do_normalize = build_speech_encoder(ssl_type, dtype=dtype)
            hidden = self.cfg.hidden_size
        self.model = model.to(self.device).requires_grad_(False).eval()
        self.rank, self.alpha = rank, alpha
        match = lora_lib.match_attention_qv if target == "qv" else lora_lib.match_ffn_dense
        self._set_lora(lora_lib.init_lora(torch.Generator().manual_seed(seed), self.model.state_dict(), match, rank))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.head = MeanPoolClassifier(hidden, num_emotions).to(self.device)
        self.num_emotions = num_emotions
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # the head's dropout
        replicate(self.mesh, self.trainable())

    def _set_lora(self, factors: lora_lib.Lora) -> None:
        self.lora = {p: {n: t.detach().to(self.device).float().contiguous().requires_grad_() for n, t in pair.items()}
                     for p, pair in factors.items()}
        self._base = lora_lib.lora_targets(self.model.state_dict(), self.lora)  # the frozen weights LoRA adapts
        if len(self._base) != len(self.lora):
            raise ValueError(f"{len(self.lora)} LoRA factors, {len(self._base)} match the encoder")

    def trainable(self):
        return [t for pair in self.lora.values() for t in pair.values()] + list(self.head.parameters())

    def forward(self, wav: torch.Tensor, mask: torch.Tensor, train: bool = False, plain: bool = False):
        """Logits [B, num_emotions] of waveforms [B, L] with sample mask [B, L].
        ``plain`` runs the plain attention (a reference run on the card)."""
        merged = lora_lib.merge_lora(self._base, self.lora, self.alpha, self.rank)
        kw = {"keep": (-1,), "plain": plain}
        if self.is_whisper:
            N = WhisperExtractionPipeline.N_SAMPLES
            L = wav.shape[1]
            w30 = wav[:, :N] if L >= N else F.pad(wav, (0, N - L))
            mel = whisper_log_mel(w30, self.cfg.num_mel_bins)
            out = torch.func.functional_call(self.model, merged, (mel,), kw)
            n_samp = mask.sum(dim=1).clamp_max(N)  # true frames: ceil(samples / 320)
            T = out["last_hidden_state"].shape[1]
            frame_mask = (torch.arange(T, device=wav.device)[None, :] * 320 < n_samp[:, None]).float()
        else:
            out = torch.func.functional_call(self.model, merged, (wav, mask), kw)
            frame_mask = out["frame_mask"]
        self.head.train(train)
        return self.head(out["last_hidden_state"], frame_mask, self.generator if train else None)

    def loss(self, wav, mask, y, smask, class_weights=None, plain: bool = False) -> torch.Tensor:
        """Weighted CE of one training forward (head dropout on); padding rows
        weigh 0. Each rank runs its rows; the CE is the whole batch's."""
        dev = self.device
        wav, mask = torch.as_tensor(wav, device=dev), torch.as_tensor(mask, device=dev)
        logits = data_parallel(self.mesh, lambda w, m: self.forward(w, m, True, plain), (wav, mask), wav.shape[0])
        return losses.weighted_cross_entropy(
            logits, torch.as_tensor(y, device=dev).long(),
            None if class_weights is None else torch.as_tensor(class_weights, device=dev),
            torch.as_tensor(smask, device=dev),
        )

    @staticmethod
    def epoch_batches(
        wavs: Sequence[np.ndarray], labels: np.ndarray, batch_size: int, rng: np.random.Generator
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """One epoch in the JAX engine's order: (indices, wav, mask, y, sample mask),
        every batch ``batch_size`` rows (the last padded with zero rows)."""
        order = rng.permutation(len(wavs))
        for s in range(0, len(wavs), batch_size):
            idxs = order[s: s + batch_size]
            wav, mask = pad_batch([wavs[i] for i in idxs], batch_size)
            y = np.zeros(batch_size, np.int64)
            y[: len(idxs)] = np.asarray(labels)[idxs]
            smask = (np.arange(batch_size) < len(idxs)).astype(np.float32)
            yield idxs, wav, mask, y, smask

    def train_epochs(
        self,
        wavs: Sequence[np.ndarray],
        labels: np.ndarray,
        dev_wavs: Sequence[np.ndarray],
        dev_labels: np.ndarray,
        epochs: int = 5,
        batch_size: int = 8,
        lr: float = 5e-4,
        class_weights: Optional[np.ndarray] = None,
        log=print,
    ) -> Dict:
        if self.device.type == "cuda" and self.cfg.dtype == "float32":  # f32 parity mode
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        rng = numpy_generator(0)
        log = self.mesh.main_only(log)
        opt = torch.optim.AdamW(self.trainable(), lr=lr, weight_decay=1e-2)
        sched = ReduceLROnPlateau(lr)
        norm = [normalize_waveform(w, self.do_normalize) for w in wavs]
        dev_norm = [normalize_waveform(w, self.do_normalize) for w in dev_wavs]
        lr_now = lr
        history, step_losses = [], []
        for epoch in range(epochs):
            for _, wav, mask, y, smask in self.epoch_batches(norm, labels, batch_size, rng):
                for group in opt.param_groups:
                    group["lr"] = lr_now
                opt.zero_grad(set_to_none=True)
                loss = self.loss(wav, mask, y, smask, class_weights)
                loss.backward()
                all_reduce_grads(self.mesh, self.trainable())
                opt.step()
                step_losses.append(loss.detach())
            dev_pred = self.predict(dev_norm, batch_size)
            dev_acc = float(np.mean(np.asarray(dev_labels) == dev_pred))
            dev_uar = uar(dev_labels, dev_pred, self.num_emotions)
            lr_now = sched.step(1.0 - dev_uar)
            log(
                f"epoch {epoch}: loss={float(step_losses[-1]):.4f} dev_acc={dev_acc:.4f} "
                f"dev_uar={dev_uar:.4f} lr={lr_now:.2e}"
            )
            history.append({"epoch": epoch, "acc": dev_acc, "uar": dev_uar, "lr": lr_now})
        return {"history": history, "losses": [float(x) for x in step_losses]}

    @torch.inference_mode()
    def predict(self, wavs: Sequence[np.ndarray], batch_size: int = 8) -> np.ndarray:
        """Arg-max classes of already-normalised waveforms, in order."""
        preds = np.zeros(len(wavs), np.int64)
        for s in range(0, len(wavs), batch_size):
            chunk = wavs[s: s + batch_size]
            wav, mask = pad_batch(chunk, batch_size)
            logits = data_parallel(self.mesh, self.forward, (torch.from_numpy(wav).to(self.device),
                                                             torch.from_numpy(mask).to(self.device)), batch_size)
            preds[s: s + len(chunk)] = logits[: len(chunk)].argmax(dim=1).cpu().numpy()
        return preds

    # -- checkpoints -----------------------------------------------------------

    def save(self, path: str) -> None:
        """The LoRA factors and the head in one state dict, the JAX package's
        names and orientations (head kernels [in, out]); rank 0 writes."""
        if not self.mesh.is_main:
            return
        sd = lora_lib.lora_state_dict(self.lora)
        for fc in ("fc1", "fc2"):
            lin = getattr(self.head, fc)
            sd[f"classifier.{fc}.kernel"] = lin.weight.detach().t().contiguous()
            sd[f"classifier.{fc}.bias"] = lin.bias.detach()
        ptio.save_state_dict(sd, path)

    def load(self, path: str) -> None:
        """A checkpoint of either package (or peft's factors)."""
        sd = ptio.load_state_dict(path)
        self._set_lora(lora_lib.lora_from_checkpoint(sd))
        if "classifier.fc1.kernel" in sd:
            with torch.no_grad():
                for fc in ("fc1", "fc2"):
                    lin = getattr(self.head, fc)
                    lin.weight.copy_(torch.as_tensor(sd[f"classifier.{fc}.kernel"]).t())
                    lin.bias.copy_(torch.as_tensor(sd[f"classifier.{fc}.bias"]))

    def merged_backbone_params(self) -> Dict[str, torch.Tensor]:
        """The LoRA-merged encoder state dict (HF names) for the *_pretrained CLIs."""
        with torch.no_grad():
            return lora_lib.merge_lora(self.model.state_dict(), self.lora, self.alpha, self.rank)
