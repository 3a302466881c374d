"""LoRA fine-tuning CLI: the port's ``lora_wavlm/ft_lora.py``.

    python -m interspeech_ser_tpu_torch.lora_cli --ssl_type <HF model dir> \
        --label_path labels.csv --wav_dir <wavs> --model_path <out> [--device cuda]

The same flags as ``lora_wavlm/ft_lora.py``, plus ``--device`` (``cuda`` by
default; ``cpu`` only when asked). Trains the LoRA factors and the
mean-pool head on the label CSV's Train split, tracks UAR and accuracy on
its Development split, and writes ``<model_path>/whisper_lora_ser.pt``
(the JAX package's checkpoint format), which the ``*_pretrained`` commands
of ``preprocess_cli`` merge into the encoder. Under ``torchrun
--nproc_per_node N -m interspeech_ser_tpu_torch.lora_cli ...`` the
fine-tune runs data-parallel over the N ranks; rank 0 alone writes and prints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .utils.device import DEVICES, init_distributed, is_main, teardown


def main(argv=None) -> dict:
    """-> ``train_epochs``'s result (per-epoch history, per-step losses) and the
    checkpoint's path under ``checkpoint``."""
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--ssl_type", type=str, default="microsoft/wavlm-base-plus")
    p.add_argument("--label_path", type=str, required=True)
    p.add_argument("--wav_dir", type=str, required=True)
    p.add_argument("--model_path", type=str, default="./experiments/LORA_WAVLM")
    p.add_argument("--finetune_method", type=str, default="lora", choices=["lora"])
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    # 'qv' = peft production variant; 'ffn' = loralib lora_wavlm variant
    p.add_argument("--lora_target", type=str, default="qv", choices=["qv", "ffn"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--num_emotions", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the encoder trains; without a card 'cuda' raises")
    args = p.parse_args(argv)

    from .baseline import data as bdata
    from .baseline.podcast import load_cat_emo_label
    from .train.lora_engine import LoRAFTEngine
    from .utils.seeding import set_deterministic

    init_distributed(args.device)
    set_deterministic(args.seed, verbose=is_main())
    if is_main():
        os.makedirs(args.model_path, exist_ok=True)
    train_utts, train_labs = load_cat_emo_label(args.label_path, "train")
    dev_utts, dev_labs = load_cat_emo_label(args.label_path, "dev")
    train_wavs = bdata.load_audio(args.wav_dir, train_utts)
    dev_wavs = bdata.load_audio(args.wav_dir, dev_utts)
    y_train = np.argmax(train_labs, axis=1)
    y_dev = np.argmax(dev_labs, axis=1)
    freq = np.asarray(train_labs).sum(axis=0)
    cw = np.where(freq > 0, len(y_train) / (args.num_emotions * np.maximum(freq, 1)), 0.0)

    engine = LoRAFTEngine(
        args.ssl_type, rank=args.lora_rank, alpha=args.lora_alpha, target=args.lora_target,
        num_emotions=args.num_emotions, seed=args.seed, device=args.device,
    )
    result = engine.train_epochs(
        train_wavs, y_train, dev_wavs, y_dev, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, class_weights=cw.astype(np.float32),
    )
    out = os.path.join(args.model_path, "whisper_lora_ser.pt")
    engine.save(out)
    if is_main():
        print(f"saved LoRA checkpoint to {out}")
    return {**result, "checkpoint": out}


if __name__ == "__main__":
    main()
    teardown()
