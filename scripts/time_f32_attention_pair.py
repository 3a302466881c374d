#!/usr/bin/env python3
"""Time the f32 attention pair (K1 + K4 of the PyTorch + CUDA port) where
its users run it, on one CUDA card, for the package of the checkout under
``--root`` (default: this one):

- K1 at Whisper-large-v3's layer (B=8, T=1500, D=1280, H=20, no mask), f32
  and bf16, against its plain version and beside SDPA;
- the median Whisper-large-v3 LoRA step (``LoRAFTEngine``, batch 8 of seeded
  3-30 s wavs, rank 8 on q/v, all 32 layers at full width, random weights
  from a seed) in f32, the engine's default and what ``lora_cli`` runs, and
  in bf16, each with a profile of 2 steps (K1's and K4's shares of device
  time).

It runs this checkout's ``chip_smoke.py`` phases (``check_attention_whisper``,
``time_lora_steps``) against the other checkout's package, so two trees are
measured by the same code:

    python3 scripts/time_f32_attention_pair.py [--root DIR]

The last line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout whose interspeech_ser_tpu_torch is measured")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)  # its package, before anything else of that name
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    smi = cs.phase_device()
    cs.set_tf32(False)
    cs.phase_build()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parity: dict = {}
    cs.check_attention_whisper(g, parity)
    with tempfile.TemporaryDirectory(prefix="f32_pair_") as tmp:
        whisper = {"dir": os.path.join(tmp, "whisper-large-v3"), "wav_dir": os.path.join(tmp, "whisper_wavs")}
        cs.write_wavs(whisper["wav_dir"], 8, (3.0, 30.0), cs.SEED + 3)  # phase 7's wavs
        cs.write_whisper(whisper["dir"])
        steps = {**cs.time_lora_steps(whisper, "float32"), **cs.time_lora_steps(whisper, "bfloat16")}
    print(json.dumps({"root": root, "card": smi, "k1_whisper": parity["attention_btd"], **steps}), flush=True)


if __name__ == "__main__":
    main()
