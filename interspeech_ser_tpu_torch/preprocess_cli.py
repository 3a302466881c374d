"""Speech embedding extraction CLI.

    python -m interspeech_ser_tpu_torch.preprocess_cli speech \
        --ssl_type <HF model dir> --wav_dir <wavs> --save_path <out> [--dtype bfloat16]

Port of ``interspeech_ser_tpu/preprocess_cli.py::speech_main`` with the same
flags, plus ``--device`` (``cuda`` by default; ``cpu`` only when asked).
``--ssl_type`` names a local HF-format directory (config.json +
pytorch_model.bin or model.safetensors); there is no hub access. In float32
mode TF32 is off for matmuls and cuDNN convolutions alike, so f32 means f32;
``--matmul_precision highest`` turns it off in bfloat16 mode too.
``--model_parallel`` above 1 is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

from .utils.device import DEVICES


def _speech_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--ssl_type", type=str, default="wavlm-large")
    p.add_argument("--save_path", type=str, default="./")
    p.add_argument("--wav_dir", type=str, default="./")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--n_layer", type=int, default=-1)
    p.add_argument("--use_average", type=str, default="n")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--matmul_precision", type=str, default="default",
                   choices=["default", "high", "highest"],
                   help="'highest' = TF32 off for matmuls and convolutions in every dtype")
    p.add_argument("--replicate_dir_count_bug", action="store_true",
                   help="reproduce the reference's hidden_states[len(os.listdir(save_path))] quirk")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel degree (only 1 is supported for now)")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the encoder runs; without a card 'cuda' raises")
    return p


def _audit_wavs(wav_dir: str):
    """Missing-file audit, as the reference does before extracting."""
    wav_names = sorted(os.listdir(wav_dir))
    print(f"{len(wav_names)} file are going to be processed...")
    missing = [w for w in wav_names if not os.path.isfile(os.path.join(wav_dir, w))]
    if missing:
        print("Missing files:")
        for m in missing:
            print(f" - {m}")
        return None
    return wav_names


def set_precision(dtype: str, matmul_precision: str = "default") -> None:
    """TF32 off in f32 mode (and everywhere under 'highest')."""
    import torch

    allow = not (dtype == "float32" or matmul_precision == "highest")
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def speech_main(argv=None):
    args = _speech_parser().parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError("--model_parallel > 1 comes with the multi-device port")
    import torch

    torch.manual_seed(args.seed)
    set_precision(args.dtype, args.matmul_precision)
    average = args.use_average == "y"
    print(f"Using average = {average}")
    wav_names = _audit_wavs(args.wav_dir)
    if wav_names is None:
        print("Something went wrong, make sure everything is correct before running again!")
        return None

    from .extract.pipeline import SpeechExtractionPipeline
    from .models.loader import build_speech_encoder

    print(f"Extracting features using {args.ssl_type}")
    model, cfg, do_normalize = build_speech_encoder(args.ssl_type, dtype=args.dtype)
    pipe = SpeechExtractionPipeline(
        model, cfg, n_layer=args.n_layer, use_average=average, do_normalize=do_normalize,
        num_workers=args.num_workers, replicate_dir_count_bug=args.replicate_dir_count_bug,
        device=args.device,
    )
    stats = pipe.run(args.wav_dir, args.save_path, wav_names)
    print(
        f"extracted {stats.n_utts} utts ({stats.audio_seconds:.1f} audio-s) in "
        f"{stats.wall_seconds:.1f}s = {stats.utts_per_sec:.1f} utt/s on {pipe.device}; "
        f"{stats.n_failed} failed"
    )
    return stats


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "speech":
        raise SystemExit("usage: python -m interspeech_ser_tpu_torch.preprocess_cli speech [flags]")
    speech_main(argv[1:])


if __name__ == "__main__":
    main()
