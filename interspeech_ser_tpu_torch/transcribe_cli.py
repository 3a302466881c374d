"""Batched Whisper transcription -> a ``FileName,transcription`` CSV.

    python -m interspeech_ser_tpu_torch.transcribe_cli --model <HF Whisper dir> --wav_dir <wavs> \
        [--out_csv whisper_transcript.csv] [--batch_size 16] [--max_new_tokens 200] \
        [--dtype float32|bfloat16] [--device cuda|cpu]

Port of ``test/whisper_transcriptions.py`` with the same flags, plus
``--device`` (``cuda`` by default; ``cpu`` only when asked). The CSV is the
``txt_dir`` transcript that the fusion configs and ``preprocess_cli
roberta`` read. ``--model`` names a local HF ``WhisperForConditionalGeneration``
directory: ``config.json``, the weights of both halves, the tokenizer files
(``utils/whisper_tokenizer.py``) and, optionally, ``generation_config.json``.

- The prompt is ``decoder_start_token_id`` and then the ``forced_decoder_ids``
  of ``generation_config.json``; ``suppress_tokens`` are suppressed and its
  ``eos_token_id`` ends a row (``config.json``'s without that file). A
  ``null`` forced id (the language left to detection) raises: there is no
  language detection here.
- Every name of ``sorted(os.listdir(wav_dir))`` is read (``utils/audio.py``:
  a batch's wavs on the native loader's threads, python for a file it fails
  on), cut or zero-padded to 480,000 samples (30 s at
  16 kHz), in batches of ``--batch_size`` rows, the last filled with zero
  rows.
- Each batch: ``ops/mel.whisper_log_mel`` -> the Whisper encoder (K1 in each
  layer on the card) -> ``greedy_decode_cached`` -> each row cut at its first
  EOT after the prompt -> decode with special tokens skipped -> ``strip()``.
- The CSV is written with the ``csv`` module as pandas'
  ``to_csv(index=False)`` writes it (``\\n`` line ends, minimal quoting).

In float32 mode TF32 is off for matmuls and cuDNN convolutions, so f32 means
f32. ``main`` returns a :class:`TranscribeStats`; its rates are emitted
tokens (each wav's new tokens up to and including its first EOT) and token
slots (every row of every batch times ``max_new_tokens``, what the
fixed-length loop computes) a second of decoding.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from .utils.device import DEVICES

SAMPLES = 480000  # 30 s at 16 kHz: Whisper's window


@dataclasses.dataclass
class TranscribeStats:
    n_utts: int
    n_batches: int
    batch_size: int
    max_new_tokens: int
    prompt_ids: List[int]
    eot_id: int
    wall_seconds: float  # the batches: load, mel, encoder, decode, text
    encoder_seconds: float  # mel + encoder, synchronized
    decode_seconds: float  # greedy_decode_cached, synchronized
    emitted_tokens: int  # the wavs' new tokens up to and including each one's first EOT
    tokens: List[np.ndarray]  # each batch's [batch_size, P + N] ids
    rows: List[List[str]]

    @property
    def utts_per_sec(self) -> float:
        return self.n_utts / max(self.wall_seconds, 1e-9)

    @property
    def tokens_per_sec(self) -> float:
        """Emitted tokens a second of decoding."""
        return self.emitted_tokens / max(self.decode_seconds, 1e-9)

    @property
    def slots_per_sec(self) -> float:
        """Token slots (every row of every batch, padding rows and the EOT
        fill too) a second of decoding."""
        return self.n_batches * self.batch_size * self.max_new_tokens / max(self.decode_seconds, 1e-9)


def generation_setup(model_dir: str, hf: dict):
    """(prompt ids, suppressed ids or None, EOT id) as the JAX script reads
    them from ``config.json`` and ``generation_config.json``."""
    prompt = [hf["decoder_start_token_id"]]
    suppress, eot = None, hf.get("eos_token_id")
    path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(path):
        with open(path) as f:
            gen = json.load(f)
        forced = gen.get("forced_decoder_ids") or []
        if any(t is None for _, t in forced):
            raise ValueError(
                f"{path}: forced_decoder_ids {forced} leave a position to detection (null); set the "
                "language and task ids: this port runs no language detection"
            )
        prompt += [t for _, t in forced]
        suppress = [int(t) for t in gen.get("suppress_tokens", []) or []] or None
        eot = gen.get("eos_token_id", eot)
    return [int(t) for t in prompt], suppress, int(eot)


def load_batch(wav_dir: str, names: List[str], batch_size: int) -> np.ndarray:
    """[batch_size, 480000] f32: each wav cut or zero-padded to 30 s, zero
    rows after the last."""
    from .utils.audio import load_wavs

    wavs = np.zeros((batch_size, SAMPLES), np.float32)
    for i, y in enumerate(load_wavs([os.path.join(wav_dir, n) for n in names])):
        wavs[i, : min(len(y), SAMPLES)] = y[:SAMPLES]
    return wavs


def write_csv(path: str, rows: List[List[str]]) -> None:
    """``pd.DataFrame(rows, columns=["FileName", "transcription"]).to_csv(path, index=False)``."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerows([["FileName", "transcription"]] + rows)


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help="local HF Whisper directory")
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--out_csv", default="whisper_transcript.csv")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the encoder and decoder run; without a card 'cuda' raises")
    return p


def main(argv: Optional[list] = None) -> TranscribeStats:
    args = _parser().parse_args(argv)

    import torch

    from .models.loader import build_whisper_decoder, build_whisper_encoder, load_hf_state_dict, read_whisper_config
    from .models.whisper_decoder import greedy_decode_cached
    from .ops.mel import whisper_log_mel
    from .preprocess_cli import set_precision
    from .utils.device import resolve_device
    from .utils.whisper_tokenizer import WhisperTokenizer

    device = resolve_device(args.device)
    set_precision(args.dtype)
    hf = read_whisper_config(args.model)
    sd = load_hf_state_dict(args.model)
    encoder, enc_cfg = build_whisper_encoder(args.model, args.dtype, state_dict=sd)
    decoder, _ = build_whisper_decoder(args.model, args.dtype, state_dict=sd)
    del sd
    encoder, decoder = encoder.to(device), decoder.to(device)
    tokenizer = WhisperTokenizer.from_dir(args.model)
    prompt, suppress, eot = generation_setup(args.model, hf)
    P, bs = len(prompt), args.batch_size
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    names = sorted(os.listdir(args.wav_dir))
    rows, all_tokens = [], []
    t_enc = t_dec = 0.0
    emitted = 0
    t0 = time.perf_counter()
    for s in range(0, len(names), bs):
        chunk = names[s : s + bs]
        wavs = load_batch(args.wav_dir, chunk, bs)
        with torch.inference_mode():
            t1 = time.perf_counter()
            mel = whisper_log_mel(torch.from_numpy(wavs).to(device), num_mels=enc_cfg.num_mel_bins)
            enc = encoder(mel, keep=(-1,))["last_hidden_state"]
            sync()
            t2 = time.perf_counter()
            tokens = greedy_decode_cached(decoder, enc, prompt, eot, max_new_tokens=args.max_new_tokens,
                                          suppress_ids=suppress).cpu().numpy()
            t3 = time.perf_counter()
        t_enc += t2 - t1
        t_dec += t3 - t2
        all_tokens.append(tokens)
        for i, n in enumerate(chunk):
            ids = tokens[i].tolist()
            if eot in ids[P:]:
                ids = ids[: P + ids[P:].index(eot)]
                emitted += 1
            emitted += len(ids) - P
            rows.append([n, tokenizer.decode(ids, skip_special_tokens=True).strip()])
        print(f"{min(s + bs, len(names))}/{len(names)}")
    wall = time.perf_counter() - t0
    write_csv(args.out_csv, rows)
    print(f"wrote {args.out_csv}")
    n_batches = len(all_tokens)
    stats = TranscribeStats(len(names), n_batches, bs, args.max_new_tokens, prompt, eot, wall, t_enc, t_dec,
                            emitted, all_tokens, rows)
    print(f"transcribed {stats.n_utts} wavs in {n_batches} batches of {bs} on {device} ({args.dtype}): "
          f"{wall:.2f} s = {stats.utts_per_sec:.2f} utt/s; encoder {t_enc:.2f} s, decode {t_dec:.2f} s = "
          f"{stats.tokens_per_sec:.1f} emitted tokens/s ({stats.slots_per_sec:.1f} token slots/s)")
    return stats


if __name__ == "__main__":
    main()
