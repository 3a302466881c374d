"""Information-encoder components: the reference encoder classifier and the
timbre perturbation.

Port of ``interspeech_ser_tpu/train/information_encoder.py`` (the
reference's ``src/information_encoder/utils.py``):

- ``ReferenceEncoderClassifier``: 6 x [Conv2d(3x3, stride 2, pad 1) ->
  BatchNorm -> ReLU] over a mel spectrogram, a unidirectional GRU (the plain
  ``gru_scan``: the JAX package runs ``lax.scan`` there, no kernel; K9 has
  no backward, so it is not put under a trained GRU), the last hidden state
  -> (optional tanh projection + dropout 0.5) -> classifier. BatchNorm keeps
  flax's running statistics (``ops/batch_norm.py``);
- ``train_reference_encoder``: Adam + CE epochs, ``checkpoint_<it>.pth`` and
  ``best_model_<it>.pth`` with the JAX trainer's flat flax names;
- the timbre perturbation, a host-side augmentation of waveforms:
  ``formant_shift_sampler``, ``timbre_perturb``, ``sliced_timbre_perturb``
  and ``fixed_timbre_perturb``. Without parselmouth (no machine of this
  project has it) the formant shift is the JAX package's spectral-envelope
  warp (scipy STFT, cepstral envelope, original phase), with the same draws
  from the caller's numpy ``Generator``, so both packages perturb a wav to
  the same samples; with parselmouth importable, Praat's 'Change gender'.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_core import dropout
from ..ops.batch_norm import RunningBatchNorm
from ..ops.gru import gru_scan

try:  # Praat's 'Change gender' when parselmouth is installed
    import parselmouth  # type: ignore

    _HAS_PRAAT = True
except Exception:
    _HAS_PRAAT = False

FILTERS = (32, 32, 64, 64, 128, 128)


def conv_out(n: int, layers: int = len(FILTERS)) -> int:
    """A length after ``layers`` convs of kernel 3, stride 2, padding 1."""
    for _ in range(layers):
        n = (n - 1) // 2 + 1
    return n


class ReferenceEncoderClassifier(nn.Module):
    """mel [B, T, num_mel] -> class logits [B, num_classes]."""

    def __init__(self, num_mel: int, embedding_dim: int, num_classes: int, use_nonlinear_proj: bool = False):
        super().__init__()
        chans = (1,) + FILTERS
        self.conv = nn.ModuleList(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1) for i in range(6))
        self.bn = nn.ModuleList(RunningBatchNorm(f) for f in FILTERS)
        H, I = embedding_dim, FILTERS[-1] * conv_out(num_mel)
        bound = 1.0 / H ** 0.5  # the JAX init: U(-1/sqrt(H), 1/sqrt(H))
        self.gru_weight_ih = nn.Parameter(torch.empty(3 * H, I).uniform_(-bound, bound))
        self.gru_weight_hh = nn.Parameter(torch.empty(3 * H, H).uniform_(-bound, bound))
        self.gru_bias_ih = nn.Parameter(torch.empty(3 * H).uniform_(-bound, bound))
        self.gru_bias_hh = nn.Parameter(torch.empty(3 * H).uniform_(-bound, bound))
        self.proj = nn.Linear(H, H) if use_nonlinear_proj else None
        self.classifier_layer = nn.Linear(H, num_classes)
        self.hidden = H

    def forward(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the projection's dropout (training); BatchNorm
        follows ``self.training``."""
        x = mel[:, None].float()  # [B, 1, T, mel]
        for conv, bn in zip(self.conv, self.bn):
            x = F.relu(bn(conv(x)))
        # flax's NHWC flatten [B, T', H', C] -> [B, T', H' * C]
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[2], -1)
        h0 = x.new_zeros(x.shape[0], self.hidden)
        out = gru_scan(x, h0, self.gru_weight_ih, self.gru_weight_hh, self.gru_bias_ih, self.gru_bias_hh)[:, -1]
        if self.proj is not None:
            out = dropout(torch.tanh(self.proj(out)), 0.5 if generator is not None else 0.0, generator)
        return self.classifier_layer(out)


def reference_encoder_flat(model: ReferenceEncoderClassifier) -> dict:
    """The JAX trainer's flat checkpoint names and flax layouts (Conv kernel
    [3, 3, in, out], Dense kernel [in, out], GRU ``[in, 3H]``) -> CPU
    tensors; running statistics under ``batch_stats.``."""
    flat = {}
    for i, (conv, bn) in enumerate(zip(model.conv, model.bn)):
        flat[f"conv{i}.kernel"] = conv.weight.permute(2, 3, 1, 0)
        flat[f"conv{i}.bias"] = conv.bias
        flat[f"bn{i}.scale"], flat[f"bn{i}.bias"] = bn.weight, bn.bias
    for n in ("ih", "hh"):
        flat[f"gru_w_{n}"] = getattr(model, f"gru_weight_{n}").t()
        flat[f"gru_b_{n}"] = getattr(model, f"gru_bias_{n}")
    for name in ("proj", "classifier_layer"):
        layer = getattr(model, name)
        if layer is not None:
            flat[f"{name}.kernel"], flat[f"{name}.bias"] = layer.weight.t(), layer.bias
    for i, bn in enumerate(model.bn):
        flat[f"batch_stats.bn{i}.mean"], flat[f"batch_stats.bn{i}.var"] = bn.running_mean, bn.running_var
    return {k: v.detach().cpu().contiguous().clone() for k, v in flat.items()}


# ---------------------------------------------------------------------------
# Timbre perturbation (host-side augmentation)
# ---------------------------------------------------------------------------


def formant_shift_sampler(ratio: float, rng: Optional[np.random.Generator] = None) -> float:
    """U(1, ratio), flipped to its inverse with p=0.5 (reference L187-197)."""
    rng = rng or np.random.default_rng()
    shift = rng.random() * (ratio - 1.0) + 1.0
    if rng.random() < 0.5:
        shift = shift ** -1
    return float(shift)


def _formant_shift_dsp(
    wav: np.ndarray, sr: int, shift: float, lift: int = 40
) -> np.ndarray:
    """Source-filter spectral-envelope warp (Praat-free approximation of
    'Change gender' at formant ratio ``shift``, pitch factors 1.0).

    Per STFT frame the log-magnitude is split into a cepstrally-smoothed
    envelope (quefrencies < ``lift``) and the harmonic excitation
    residual; only the ENVELOPE is resampled by ``shift`` along
    frequency, so formants move while pitch/harmonics stay put — which is
    what Praat's formant-shift does. Original phase kept.

    The JAX package's fidelity test of this function
    (tests/test_information_encoder.py::TestFormantShiftFidelity) holds
    for the port too: the two compute the same samples
    (tests/test_torch_information_encoder.py).
    """
    if len(wav) < 512 or abs(shift - 1.0) < 1e-3:
        return wav.astype(np.float32)
    from scipy.signal import stft as sp_stft, istft as sp_istft

    f, t, Z = sp_stft(wav, fs=sr, nperseg=512, noverlap=384)
    mag, phase = np.abs(Z), np.angle(Z)
    n_bins = mag.shape[0]
    logm = np.log(np.maximum(mag, 1e-10))
    # cepstral smoothing along frequency (even extension, low-quefrency keep)
    ext = np.concatenate([logm, logm[-2:0:-1]], axis=0)
    cep = np.fft.rfft(ext, axis=0)
    cep[lift:] = 0
    env = np.fft.irfft(cep, n=ext.shape[0], axis=0)[:n_bins]
    exc = logm - env
    src_bins = np.clip(np.arange(n_bins) / shift, 0, n_bins - 1)
    lo = np.floor(src_bins).astype(int)
    hi = np.minimum(lo + 1, n_bins - 1)
    frac = (src_bins - lo)[:, None]
    env_w = env[lo] * (1 - frac) + env[hi] * frac
    warped = np.exp(env_w + exc)
    _, out = sp_istft(warped * np.exp(1j * phase), fs=sr, nperseg=512, noverlap=384)
    out = out[: len(wav)]
    if len(out) < len(wav):
        out = np.pad(out, (0, len(wav) - len(out)))
    return out.astype(np.float32)


def timbre_perturb(
    wav: np.ndarray,
    sr: int,
    formant_shift: float = 1.0,
    pitch_steps: float = 0.01,
    pitch_floor: float = 75,
    pitch_ceil: float = 600,
    fname: str = "null",
) -> np.ndarray:
    """Single-shift perturbation (reference L211-258)."""
    if _HAS_PRAAT:  # exact Praat 'Change gender' path
        snd = parselmouth.Sound(wav, sampling_frequency=sr)
        try:
            pitch = parselmouth.praat.call(snd, "To Pitch", pitch_steps, pitch_floor, pitch_ceil)
        except Exception:
            return snd.values[0]
        ndpit = pitch.selected_array["frequency"]
        nonzero = ndpit > 1e-5
        if nonzero.sum() == 0:
            return snd.values[0]
        median = float(np.median(ndpit[nonzero]))
        (out,) = parselmouth.praat.call(
            (snd, pitch), "Change gender", formant_shift, median, 1.0, 1.0
        ).values
        return out
    return _formant_shift_dsp(np.asarray(wav, np.float32), sr, formant_shift)


def sliced_timbre_perturb(
    wav: np.ndarray,
    sr: int = 16000,
    segment_size: int = 16000 // 2,
    formant_rate: float = 1.4,
    pitch_steps: float = 0.01,
    pitch_floor: float = 75,
    pitch_ceil: float = 600,
    fname: str = "null",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Per-segment random formant shifts (reference L199-209)."""
    rng = rng or np.random.default_rng()
    out = []
    for i in range(len(wav) // segment_size + 1):
        seg = wav[segment_size * i : segment_size * (i + 1)]
        if len(seg) == 0:
            continue
        shift = formant_shift_sampler(formant_rate, rng)
        out.append(timbre_perturb(seg, sr, shift, pitch_steps, pitch_floor, pitch_ceil, fname))
    return np.concatenate(out) if out else np.asarray(wav)


def fixed_timbre_perturb(
    wav: np.ndarray,
    sr: int = 16000,
    segment_size: int = 16000 // 2,
    formant_rate: float = 1.4,
    pitch_steps: float = 0.01,
    pitch_floor: float = 75,
    pitch_ceil: float = 600,
    fname: str = "null",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """One sampled shift for the whole utterance (reference L260-281;
    the WavSet augmentation, benchmark/utils/dataset/dataset.py:176-179)."""
    shift = formant_shift_sampler(formant_rate, rng)
    return timbre_perturb(wav, sr, shift, pitch_steps, pitch_floor, pitch_ceil, fname)


def train_reference_encoder(
    model: ReferenceEncoderClassifier,
    train_batches: Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]],
    val_batches: Callable[[], Iterable[Tuple[np.ndarray, np.ndarray]]],
    epochs: int = 100,
    eval_epochs: int = 5,
    lr: float = 0.001,
    save_model_path: Optional[str] = None,
    checkpoint_every: int = 5000,
    seed: int = 0,
    log=print,
):
    """Adam + CE epochs for a ``ReferenceEncoderClassifier`` on its device.

    ``train_batches`` / ``val_batches`` return iterables of (mel [B, T, M],
    labels [B]) numpy pairs. Per epoch the train accuracy; every
    ``eval_epochs`` epochs the val loss and accuracy, and ``best_model_<it>.pth``
    when the mean val loss is the lowest yet; ``checkpoint_<it>.pth`` every
    ``checkpoint_every`` steps (flat flax names, ``reference_encoder_flat``).
    The projection's dropout draws from a ``torch.Generator`` seeded with
    ``seed``. -> (model, train losses, val losses, train accuracies, val
    accuracies)."""
    from ..utils import ptio

    device = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=device).manual_seed(seed)

    def save(name):
        if save_model_path is not None:
            os.makedirs(save_model_path, exist_ok=True)
            ptio.save_state_dict(reference_encoder_flat(model), os.path.join(save_model_path, name))

    train_loss, val_loss, train_acc, val_acc = [], [], [], []
    best_loss = float("inf")
    it = 0
    for epoch in range(epochs):
        model.train()
        correct = total = 0
        for mel, y in train_batches():
            y_t = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=device)
            logits = model(torch.as_tensor(np.asarray(mel), device=device), generator)
            loss = F.cross_entropy(logits.float(), y_t)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            train_loss.append(float(loss.detach()))
            correct += int((logits.argmax(-1) == y_t).sum())
            total += len(y)
            it += 1
            if it % checkpoint_every == 0:
                save(f"checkpoint_{it}.pth")
        train_acc.append(correct / max(total, 1))

        if epoch % eval_epochs == 0:
            model.eval()
            correct = total = 0
            losses_e = []
            with torch.no_grad():
                for mel, y in val_batches():
                    y_t = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=device)
                    logits = model(torch.as_tensor(np.asarray(mel), device=device))
                    loss = float(F.cross_entropy(logits.float(), y_t))
                    losses_e.append(loss)
                    val_loss.append(loss)
                    correct += int((logits.argmax(-1) == y_t).sum())
                    total += len(y)
            avg = float(np.mean(losses_e)) if losses_e else float("nan")
            val_acc.append(correct / max(total, 1))
            if avg < best_loss:
                best_loss = avg
                save(f"best_model_{it}.pth")
            log(f"epoch {epoch}: train acc={train_acc[-1]:.3f} val loss={avg:.4f} acc={val_acc[-1]:.3f}")
    return model, train_loss, val_loss, train_acc, val_acc
