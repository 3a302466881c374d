"""Speech, Whisper and text embedding extraction CLIs.

    python -m interspeech_ser_tpu_torch.preprocess_cli speech \
        --ssl_type <HF model dir> --wav_dir <wavs> --save_path <out> [--dtype bfloat16]
    python -m interspeech_ser_tpu_torch.preprocess_cli whisper ...           (same flags)
    python -m interspeech_ser_tpu_torch.preprocess_cli speech_pretrained \
        ... --lora_ckpt whisper_lora_ser.pt [--lora_rank 8 --lora_alpha 16]
    python -m interspeech_ser_tpu_torch.preprocess_cli whisper_pretrained ...  (same flags)
    python -m interspeech_ser_tpu_torch.preprocess_cli roberta \
        --roberta_type <HF model dir> --df_path <csv> --save_path <out> [--use_average y] [--max_len 80]
    python -m interspeech_ser_tpu_torch.preprocess_cli deroberta ...          (same flags)
    python -m interspeech_ser_tpu_torch.preprocess_cli ns3_prosody \
        --wav_dir <wavs> --save_path <out> --decoder_ckpt ns3_facodec_decoder_v2.bin [--codes] [--batch_size 16]
    python -m interspeech_ser_tpu_torch.preprocess_cli ns3_prosody_speaker ... --encoder_ckpt ns3_facodec_encoder_v2.bin

Port of ``interspeech_ser_tpu/preprocess_cli.py::speech_main``,
``whisper_main``, ``speech_pretrained_main``, ``whisper_pretrained_main``,
``roberta_main``, ``deroberta_main`` and ``ns3_prosody_main`` with the same flags, plus
``--device`` (``cuda`` by default; ``cpu`` only when asked). The ``*_pretrained`` CLIs merge a LoRA checkpoint (the port's
or the JAX package's ``whisper_lora_ser.pt``, or a peft one) into the
encoder before extracting.
``roberta`` / ``deroberta`` read the CSV's ``FileName`` and
``transcription`` columns (with the ``csv`` module; a cell pandas would
read as missing, such as an empty one or ``NA``, is the empty text) and
write one full padded [max_len, D] ``.pt`` per row, in batches of 64
(RoBERTa) or 32 (DeBERTa); the tokenizer comes from the model directory
(``utils/spm.py::auto_tokenizer``).
``--ssl_type`` / ``--roberta_type`` name a local HF-format directory (config.json +
pytorch_model.bin or model.safetensors); there is no hub access. In float32
mode TF32 is off for matmuls and cuDNN convolutions alike, so f32 means f32;
``--matmul_precision highest`` turns it off in bfloat16 mode too.
Multi-device: launch with ``torchrun --nproc_per_node N -m
interspeech_ser_tpu_torch.preprocess_cli <command> ...`` (``--device cpu``
for gloo ranks on the CPU): each data rank extracts whole batches of the
one-device plan and writes their files, and rank 0 alone prints.
``--model_parallel mp`` (``speech`` / ``speech_pretrained``) shards the
encoder's attentions and feed-forwards over mp ranks a model group
(``parallel/tp.py``); ``whisper`` with mp above 1 raises.
``ns3_prosody`` / ``ns3_prosody_speaker`` run the NS3 FACodec prosody
extractor (``models/ns3/facodec.py``) through
``extract/pipeline.py::ProsodyExtractionPipeline`` in f32 with TF32 off,
from the reference's ``.bin`` files, with the JAX CLI's host behaviour: each wav
padded by ``200 - len % 200`` zeros (200 when the length is already a
multiple), files sorted by length, batches of ``--batch_size`` rows (zero
rows fill the last) padded to a multiple of 3200 samples, each utterance
reflect-padded on the host for the mel, and ``[len / 200, 256]`` (speaker:
512) float32 ``.pt`` files, or with ``--codes`` the ``[len / 200]`` int32 VQ
indices of the literal forward on the zero-padded batch.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import sys

from .utils.device import DEVICES, teardown
from .utils.labels import PANDAS_NA


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
                   help="tensor-parallel degree: ranks a model group (torchrun ranks; must divide the heads)")
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


def _pretrained_parser():
    p = _speech_parser()
    p.add_argument("--lora_ckpt", type=str, default="whisper_lora_ser.pt")
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    return p


def _setup(args):
    """Process group (under torchrun), seed, precision and the missing-file
    audit -> the wav names (None on a missing file). Rank 0 alone prints."""
    import torch

    from .utils.device import init_distributed, is_main

    init_distributed(args.device)
    torch.manual_seed(args.seed)
    set_precision(args.dtype, args.matmul_precision)
    with _quiet_unless(is_main()):
        print(f"Using average = {args.use_average == 'y'}")
        wav_names = _audit_wavs(args.wav_dir)
        if wav_names is None:
            print("Something went wrong, make sure everything is correct before running again!")
    return wav_names


@contextlib.contextmanager
def _quiet_unless(main: bool):
    """Silence this rank's prints unless it is rank 0."""
    if main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _merge_checkpoint(model, args) -> None:
    """Merge the LoRA factors of ``args.lora_ckpt`` into ``model``'s weights."""
    from .models import lora
    from .utils import ptio

    factors = lora.lora_from_checkpoint(ptio.load_state_dict(args.lora_ckpt))
    sd = model.state_dict()
    merged = lora.merge_lora(lora.lora_targets(sd, factors), factors, args.lora_alpha, args.lora_rank)
    if len(merged) != len(factors):
        raise ValueError(f"{args.lora_ckpt}: {len(factors)} LoRA factors, {len(merged)} match the encoder")
    model.load_state_dict(merged, strict=False)


def _report(stats, device) -> None:
    from .utils.device import is_main

    if not is_main():
        return
    print(
        f"extracted {stats.n_utts} utts ({stats.audio_seconds:.1f} audio-s) in "
        f"{stats.wall_seconds:.1f}s = {stats.utts_per_sec:.1f} utt/s on {device}; "
        f"{stats.n_failed} failed"
    )


def speech_main(argv=None, with_lora: bool = False):
    args = (_pretrained_parser() if with_lora else _speech_parser()).parse_args(argv)
    wav_names = _setup(args)
    if wav_names is None:
        return None

    from .extract.pipeline import SpeechExtractionPipeline
    from .models.loader import build_speech_encoder

    from .utils.device import is_main

    with _quiet_unless(is_main()):
        print(f"Extracting features using {args.ssl_type}" + (f" + LoRA {args.lora_ckpt}" if with_lora else ""))
    model, cfg, do_normalize = build_speech_encoder(args.ssl_type, dtype=args.dtype)
    if with_lora:
        _merge_checkpoint(model, args)
    pipe = SpeechExtractionPipeline(
        model, cfg, n_layer=args.n_layer, use_average=args.use_average == "y", do_normalize=do_normalize,
        num_workers=args.num_workers, replicate_dir_count_bug=args.replicate_dir_count_bug,
        device=args.device, model_parallel=args.model_parallel,
    )
    stats = pipe.run(args.wav_dir, args.save_path, wav_names)
    _report(stats, pipe.device)
    return stats


def whisper_main(argv=None, with_lora: bool = False):
    args = (_pretrained_parser() if with_lora else _speech_parser()).parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError(f"--model_parallel {args.model_parallel}: tensor parallelism shards the speech "
                         "encoders (speech / speech_pretrained); Whisper extraction is data-parallel only")
    wav_names = _setup(args)
    if wav_names is None:
        return None

    from .extract.pipeline import WhisperExtractionPipeline
    from .models.loader import build_whisper_encoder
    from .utils.device import is_main

    with _quiet_unless(is_main()):
        print(f"Extracting features using {args.ssl_type}" + (f" + LoRA {args.lora_ckpt}" if with_lora else ""))
    model, cfg = build_whisper_encoder(args.ssl_type, dtype=args.dtype)
    if with_lora:
        _merge_checkpoint(model, args)
    pipe = WhisperExtractionPipeline(
        model, cfg, n_layer=args.n_layer, use_average=args.use_average == "y",
        num_workers=args.num_workers, device=args.device,
    )
    stats = pipe.run(args.wav_dir, args.save_path, wav_names)
    _report(stats, pipe.device)
    return stats


def speech_pretrained_main(argv=None):
    """LoRA-fine-tuned speech-encoder extraction (preprocess_speech_pretrained.py).
    The reference extracts with peft's adapters active; the merged weights
    give the same forward with dropout off."""
    return speech_main(argv, with_lora=True)


def whisper_pretrained_main(argv=None):
    """LoRA-fine-tuned Whisper-encoder extraction (preprocess_whisper_pretrained.py)."""
    return whisper_main(argv, with_lora=True)


def _text_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--roberta_type", type=str, default="roberta")
    p.add_argument("--df_path", type=str, default="./")
    p.add_argument("--save_path", type=str, default="./")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_len", type=int, default=80)
    p.add_argument("--use_average", type=str, default="n")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the encoder runs; without a card 'cuda' raises")
    return p


def read_transcripts(path: str):
    """-> (FileName list, transcription list); a missing cell is ``None``."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return ([r["FileName"] for r in rows],
            [None if r["transcription"] in PANDAS_NA else r["transcription"] for r in rows])


def _text_main(argv, family: str):
    args = _text_parser().parse_args(argv)
    import torch

    from .extract.pipeline import TextExtractionPipeline
    from .models.loader import build_deberta_v2, build_roberta
    from .utils.device import init_distributed, is_main
    from .utils.spm import auto_tokenizer

    init_distributed(args.device)
    torch.manual_seed(args.seed)
    set_precision(args.dtype)
    with _quiet_unless(is_main()):
        print(f"Using average = {args.use_average == 'y'}")
    names, texts = read_transcripts(args.df_path)
    model, cfg = (build_roberta if family == "roberta" else build_deberta_v2)(args.roberta_type, dtype=args.dtype)
    tokenizer = auto_tokenizer(args.roberta_type)

    def tokenize(batch):
        return tokenizer(batch, padding="max_length", max_length=args.max_len, truncation=True, return_tensors="np")

    pipe = TextExtractionPipeline(
        model, cfg, tokenize, use_average=args.use_average == "y", num_workers=args.num_workers,
        batch_size=32 if family == "deberta" else 64, device=args.device,
    )
    stats = pipe.run(names, texts, args.save_path)
    with _quiet_unless(is_main()):
        print(f"extracted {stats.n_utts} texts in {stats.wall_seconds:.1f}s = {stats.utts_per_sec:.1f} texts/s "
              f"on {pipe.device}; {stats.n_skipped} skipped")
    return stats


def roberta_main(argv=None):
    """RoBERTa transcript embeddings (preprocess_roberta.py)."""
    return _text_main(argv, "roberta")


def deroberta_main(argv=None):
    """DeBERTa-v2 transcript embeddings (preprocess_deroberta.py)."""
    return _text_main(argv, "deberta")


def _ns3_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--save_path", type=str, default="./")
    p.add_argument("--wav_dir", type=str, default="./")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--encoder_ckpt", type=str, default="./pretrained_models/ns3/ns3_facodec_encoder_v2.bin")
    p.add_argument("--decoder_ckpt", type=str, default="./pretrained_models/ns3/ns3_facodec_decoder_v2.bin")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--codes", action="store_true", help="save the prosody VQ indices instead of the embeddings")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the extractor runs; without a card 'cuda' raises")
    return p


def ns3_prosody_main(argv=None, speaker: bool = False):
    """NS3 FACodec prosody (256-d) or prosody + speaker (512-d) features
    (preprocess_ns3_prosody[_speaker].py): each utterance's reference batch-1
    output, computed in padded batches (``ProsodyExtractor.extract_batched``)."""
    args = _ns3_parser().parse_args(argv)
    import torch

    from .extract.pipeline import ProsodyExtractionPipeline
    from .models.loader import build_prosody_extractor
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    set_precision("float32")
    wav_names = _audit_wavs(args.wav_dir)
    if wav_names is None:
        return None
    extractor = build_prosody_extractor(args.decoder_ckpt, args.encoder_ckpt, with_speaker=speaker)
    pipe = ProsodyExtractionPipeline(extractor, args.batch_size, args.codes, args.num_workers, device)
    stats = pipe.run(args.wav_dir, args.save_path, wav_names)
    print(f"extracted {stats.n_utts} utts ({stats.audio_seconds:.1f} audio-s, {stats.n_batches} batches) in "
          f"{stats.wall_seconds:.1f}s = {stats.utts_per_sec:.1f} utt/s on {device}; {stats.n_failed} failed")
    return stats


def ns3_prosody_speaker_main(argv=None):
    """NS3 FACodec prosody + speaker features (preprocess_ns3_prosody_speaker.py)."""
    return ns3_prosody_main(argv, speaker=True)


COMMANDS = {
    "speech": speech_main,
    "whisper": whisper_main,
    "speech_pretrained": speech_pretrained_main,
    "whisper_pretrained": whisper_pretrained_main,
    "roberta": roberta_main,
    "deroberta": deroberta_main,
    "ns3_prosody": ns3_prosody_main,
    "ns3_prosody_speaker": ns3_prosody_speaker_main,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m interspeech_ser_tpu_torch.preprocess_cli {{{'|'.join(COMMANDS)}}} [flags]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
    teardown()
