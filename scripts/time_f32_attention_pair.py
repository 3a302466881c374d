#!/usr/bin/env python3
"""Time the port's redesigned kernels (the f32 attention pairs, K8 and K2)
where their users run them, on one CUDA card, for the package of the
checkout under ``--root`` (default: this one). Phases (``--phases``, default all):

- ``btd``: K1 + K4, the [B, T, D] pair. K1 at Whisper-large-v3's layer (B=8,
  T=1500, D=1280, H=20, no mask), f32 and bf16, against its plain version and
  beside SDPA; the median Whisper-large-v3 LoRA step (``LoRAFTEngine``, batch
  8 of seeded 3-30 s wavs, rank 8 on q/v, all 32 layers at full width, random
  weights from a seed) in f32, the engine's default and what ``lora_cli``
  runs, and in bf16, each with a profile of 2 steps (K1's and K4's shares of
  device time).
- ``bhtd``: K7 (one-shot) + K6 (streaming), the [B, H, T, 64] pair. Both
  against their plain versions and beside SDPA with the float mask at every
  shape of ``chip_smoke.py``'s ``check_attention_bhtd`` (RoBERTa-large B=64
  H=16 T=80, WavLM-large + gated bias B=8 H=16 T=499, K6 long B=8 H=20 T=1500
  with and without a ragged mask, a fully masked row, K7 at Tk = 2048, views
  off 16 bytes), f32 and bf16; then ``chip_smoke.py``'s text phase:
  RoBERTa-large extraction over 256 seeded transcripts (texts/s, f32 and
  bf16, K6's run against K7's) and a profile of one warm run (K7's share of
  device time).
- ``conv``: K8 (grouped positional conv) and K2 (the waveform frontend)
  against their plain versions at every shape of ``chip_smoke.py``'s
  ``check_pos_conv`` (C = 120 / 64 / 48, f32 and bf16, beside cuDNN
  ``F.conv1d``) and ``check_conv_frontend`` (wav [8, 160000], depths 1-7);
  then a seeded random-init WavLM-large through ``profile_wavlm_large``: one
  B=32 batch of 10-s wavs in bf16 (timed) and in f32, each profiled (device
  busy ms, the shares of K1, K2 and K8).
- ``fingerprints``: SHA-256 of the f32 K1 and K4 outputs at the speech shapes
  of ``check_attention_bwd`` and of the bf16 K6 / K7 outputs at the shapes
  above, from seeded inputs: two checkouts whose fingerprints agree gave the
  same bits.

It runs this checkout's ``chip_smoke.py`` phases against the other checkout's
package, so two trees are measured by the same code (an A/B runs it once per
tree in turns, parent P and change T: P/T/T/P/T/P/P/T):

    python3 scripts/time_f32_attention_pair.py [--root DIR] [--phases btd bhtd conv fingerprints] [--out FILE]
    python3 scripts/time_f32_attention_pair.py --compare FILE FILE   # exit 1 if a fingerprint differs

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("btd", "bhtd", "conv", "fingerprints")


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (any dtype: bf16 has no numpy dtype)."""
    import torch

    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def phase_btd(cs, torch, smi) -> dict:
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parity: dict = {}
    cs.check_attention_whisper(g, parity)
    with tempfile.TemporaryDirectory(prefix="f32_pair_") as tmp:
        whisper = {"dir": os.path.join(tmp, "whisper-large-v3"), "wav_dir": os.path.join(tmp, "whisper_wavs")}
        cs.write_wavs(whisper["wav_dir"], 8, (3.0, 30.0), cs.SEED + 3)  # phase 7's wavs
        cs.write_whisper(whisper["dir"])
        steps = {**cs.time_lora_steps(whisper, "float32"), **cs.time_lora_steps(whisper, "bfloat16")}
    return {"k1_whisper": parity["attention_btd"], **steps}


def phase_bhtd(cs, torch, smi) -> dict:
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parity: dict = {}
    cs.check_attention_bhtd(g, parity)
    result = {"bhtd": {n: parity[n] for n in ("attention_bhtd", "flash_attention")}}
    with tempfile.TemporaryDirectory(prefix="bhtd_pair_") as tmp:
        result["text"] = cs.phase_text(tmp, smi)
    return result


def phase_conv(cs, torch, smi) -> dict:
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parity: dict = {}
    cs.check_pos_conv(g, parity)
    cs.check_conv_frontend(g, parity)
    result = {"conv": {n: parity[n] for n in ("pos_conv", "conv_frontend", "conv_frontend_layer")}}
    with tempfile.TemporaryDirectory(prefix="conv_pair_") as tmp:
        # written afresh from the seed in every run (a few seconds), so every tree gets the same weights
        model_dir = os.path.join(tmp, "wavlm-large")
        cs.write_wavlm_large(model_dir)
        result["wavlm_b32"] = cs.profile_wavlm_large(tmp, model_dir, smi)
    return result


def phase_fingerprints(cs, torch, smi) -> dict:
    """SHA-256 of f32 K1 (out, lse) and K4 (dq, dk, dv, dgate, dbias) and of
    bf16 K6 / K7, each from inputs made by a generator seeded afresh."""
    k_attn, k_bhtd = cs.k_attn, cs.k_bhtd
    out = {}
    wavlm_lengths = [499, 480, 451, 400, 333, 250, 130, 64]
    zoo_lengths = wavlm_lengths + [499, 470, 402, 380, 310, 222, 160, 90]
    for shape, (B, T, D, H), lengths, bias in (("whisper", (8, 1500, 1280, 20), None, False),
                                               ("wavlm", (8, 499, 1024, 16), wavlm_lengths, True),
                                               ("hd80", (16, 499, 1280, 16), zoo_lengths, False),
                                               ("hd80_bias", (16, 499, 1280, 16), zoo_lengths, True),
                                               ("hd120", (16, 499, 1920, 16), zoo_lengths, False),
                                               ("hd120_bias", (16, 499, 1920, 16), zoo_lengths, True)):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        (q, k, v, _), kw = cs._attention_inputs(g, B, T, D, H, lengths, bias, torch.float32)
        gr = torch.randn(B, T, D, generator=g, device="cuda")
        o, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
        grads = k_attn.attention_btd_bwd(q, k, v, gr, H, **kw, out=o, lse=lse)
        out[f"k1_f32_{shape}"] = [digest(o), digest(lse)]
        out[f"k4_f32_{shape}"] = [None if t is None else digest(t) for t in grads]
        del q, k, v, gr, kw, o, lse, grads
        torch.cuda.empty_cache()
    rng = cs.np.random.default_rng(cs.SEED)
    roberta_lengths = [80] * 8 + [int(n) for n in rng.integers(3, 81, 56)]
    for shape, (B, H, T), lengths, bias, offset, kernels in (
            ("roberta", (64, 16, 80), roberta_lengths, False, False, ("attention_bhtd", "flash_attention")),
            ("wavlm", (8, 16, 499), wavlm_lengths, True, False, ("attention_bhtd", "flash_attention")),
            ("long", (8, 20, 1500), None, False, False, ("flash_attention",)),
            ("tk2048", (2, 16, 2048), [2048, 1337], True, False, ("attention_bhtd",)),
            ("offset", (4, 16, 80), [80, 0, 51, 7], False, True, ("attention_bhtd",))):
        g = torch.Generator(device="cuda").manual_seed(cs.SEED)
        args, kw = cs._bhtd_case(g, B, H, T, lengths, bias, torch.bfloat16, offset)
        for name in kernels:
            fn = k_bhtd.attention_bhtd if name == "attention_bhtd" else k_bhtd.flash_attention
            out[f"{name}_bf16_{shape}"] = digest(fn(*args, **kw))
    return {"fingerprints": out}


def compare(a_path: str, b_path: str) -> int:
    a, b = (json.load(open(p))["fingerprints"] for p in (a_path, b_path))
    diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    print(json.dumps({"compared": len(set(a) | set(b)), "differ": diff}), flush=True)
    return 1 if diff else 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose interspeech_ser_tpu_torch is measured")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES), help="what to run, in this order")
    ap.add_argument("--out", help="write the result's JSON here too")
    ap.add_argument("--compare", nargs=2, metavar="FILE", help="compare the fingerprints of two --out files")
    opts = ap.parse_args()
    if opts.compare:
        sys.exit(compare(*opts.compare))
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)  # its package, before anything else of that name
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    smi = cs.phase_device()
    cs.set_tf32(False)
    cs.phase_build()
    result = {"root": root, "card": smi}
    runs = {"btd": phase_btd, "bhtd": phase_bhtd, "conv": phase_conv, "fingerprints": phase_fingerprints}
    for name in opts.phases:
        result.update(runs[name](cs, torch, smi))
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
