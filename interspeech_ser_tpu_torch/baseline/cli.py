"""The challenge baseline's train and eval entry points.

Port of ``interspeech_ser_tpu/baseline/cli.py`` (``train_main``,
``eval_main``, and ``legacy_train_main`` for the three ``bin/old``
baselinelike trainers, ``LEGACY_STEMS``): the reference scripts' flags
(``benchmark/train_eval_files/{train,eval}_{cat,dim}_ser.py``), the wav
directory and label CSV from ``configs/config_cat.json``, and
``final_{ser,pool,ssl}.pt`` + ``train_norm_stat.pkl`` in ``--model_path``,
plus ``--device`` (``cuda`` by default; ``cpu`` only when asked). ``dim``
trains in bf16, as the JAX package does; eval runs in f32. Eval writes
``results/dev.csv`` (``--dev``) or ``results/test3.csv`` (the wav
directory's ``*test3*`` files): ``FileName,EmoClass`` for ``cat``,
``FileName,EmoAct,EmoVal,EmoDom`` (each ``clip(v * 6 + 1, 1, 7)``) for
``dim``, and prints the inference time per audio second on test3.

    python -m interspeech_ser_tpu_torch.baseline.cli train --task cat --ssl_type <HF dir> \\
        --config_path configs/config_cat.json --model_path <out> [--device cpu]
    python -m interspeech_ser_tpu_torch.baseline.cli eval --task dim [--dev] --ssl_type <HF dir> \\
        --config_path configs/config_cat.json --model_path <out> [--device cpu]
    python -m interspeech_ser_tpu_torch.baseline.cli train_cat_baselinelike_focalloss \\
        --config_path <cfg> [--seed 7] [--device cpu]

Under ``torchrun --nproc_per_node N -m interspeech_ser_tpu_torch.baseline.cli
...`` every command runs data-parallel over the N ranks; rank 0 alone writes
files and prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.device import DEVICES, init_distributed, is_main, teardown

SSL_BOOK = {
    "wavlm-large": "microsoft/wavlm-large",
    "wavlm-base": "microsoft/wavlm-base",
}


def get_ssl_type(name: str):
    """The reference's name book; a path that exists passes through, else None."""
    if name in SSL_BOOK:
        return SSL_BOOK[name]
    return name if os.path.exists(name) else None


def _common(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--ssl_type", type=str, default="wavlm-large")
    p.add_argument("--head_dim", type=int, default=1024)
    p.add_argument("--pooling_type", type=str, default="AttentiveStatisticsPooling")
    p.add_argument("--config_path", type=str, default="configs/config_cat.json")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the model runs; without a card 'cuda' raises")
    return p


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--model_path", type=str, default="./temp")
    return _common(p)


def _eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, default="./model/cat_ser/7/")
    p.add_argument("--store_path")
    return _common(p)


def _load_paths(config_path: str):
    with open(config_path) as f:
        cfg = json.load(f)
    return cfg["wav_dir"], cfg["label_path"]


def _engine(args, task: str, dtype: str = "float32"):
    from .engine import BaselineEngine

    init_distributed(args.device)
    ssl = get_ssl_type(args.ssl_type)
    if ssl is None:
        raise ValueError(f"Invalid SSL type! {args.ssl_type!r} is neither a known name nor a path")
    return BaselineEngine(ssl, task=task, head_dim=args.head_dim, seed=getattr(args, "seed", 100), dtype=dtype,
                          device=args.device)


def train_main(task: str = "cat", argv=None) -> dict:
    """-> ``BaselineEngine.fit``'s result (the best epoch, its dev loss and
    predictions, every epoch's dev loss)."""
    args = _train_parser().parse_args(argv)
    audio_path, label_path = _load_paths(args.config_path)
    engine = _engine(args, task, dtype="bfloat16" if task == "dim" else "float32")
    return engine.fit(label_path, audio_path, args.model_path, batch_size=args.batch_size,
                      accumulation_steps=args.accumulation_steps, epochs=args.epochs, lr=args.lr)


def eval_main(task: str = "cat", dev: bool = False, argv=None) -> str:
    """-> the path of the results CSV written."""
    from . import data as bdata
    from .engine import labelled_split, write_rows, write_test3_submission

    args = _eval_parser().parse_args(argv)
    audio_path, label_path = _load_paths(args.config_path)
    engine = _engine(args, task)
    engine.load_checkpoints(args.model_path)
    mean, std = bdata.load_norm_stat(os.path.join(args.model_path, "train_norm_stat.pkl"))

    timing: dict = {}
    if dev:
        ds = labelled_split(task, label_path, audio_path, "dev", mean, std)
        utts = ds.utts
        res = engine.evaluate(ds)
        if is_main():
            print(f"dev loss = {res['loss']}")
        preds, split = res["preds"], "dev"
    else:
        utts = sorted(f for f in os.listdir(audio_path) if "test3" in f)
        ds = bdata.WavDataset(bdata.load_audio(audio_path, utts), None, utts, wav_mean=mean, wav_std=std)
        preds, split = engine.predict(ds, timing=timing), "test3"

    if task == "cat":
        out = write_test3_submission(preds, utts, args.model_path, split)
    else:
        clip = lambda v: float(min(max(1.0, v * 6 + 1), 7.0))  # noqa: E731
        rows = [[u, clip(p[0]), clip(p[2]), clip(p[1])] for u, p in zip(utts, preds)]
        out = write_rows(os.path.join(args.model_path, "results", f"{split}.csv"),
                         ["FileName", "EmoAct", "EmoVal", "EmoDom"], rows)

    if timing.get("audio_sec") and is_main():
        print("Duration of whole dev+test set", timing["audio_sec"], "sec")
        print("Inference time", timing["inference"], "sec")
        print("Inference time per sec", timing["inference"] / timing["audio_sec"], "sec")
    if args.store_path and is_main():
        with open(args.store_path, "w") as f:
            f.write(out + "\n")
    return out


# bin/old wrapper stem -> legacy_train_main variant
LEGACY_STEMS = {
    "train_cat_baselinelike": "base",
    "train_cat_baselinelike_focalloss": "focalloss",
    "train_cat_baselinelike_xvector": "xvector",
}


def legacy_train_main(variant: str = "base", argv=None) -> dict:
    """The config-JSON trainers of ``bin/old``: ``base``
    (train_cat_baselinelike.py, weighted CE), ``focalloss`` (unweighted CE +
    focal loss with gamma 3 and dynamic alpha) and ``xvector``
    (``XVectorEngine`` instead of an SSL encoder). Flags: ``--seed`` (7),
    ``--config_path``, ``--device``. Config keys: ``wav_dir``,
    ``label_path``, ``ssl_type``, ``batch_size``, ``accum_step``, ``epochs``,
    ``lr``, ``model_path``, ``head_dim``, ``weight_decay`` (1e-2),
    ``dropout_head`` (0.5), ``use_timbre_perturb`` with ``tp_prob``,
    ``use_balanced_batch``, ``normalize_wav`` (true), and for ``xvector``
    ``xvector_ckpt`` (a speechbrain checkpoint). -> the engine's ``fit``
    result."""
    from ..train.engine import setup_run_logging

    if variant not in LEGACY_STEMS.values():
        raise ValueError(f"variant {variant!r}: one of {sorted(LEGACY_STEMS.values())}")
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--config_path", type=str, default="./configs/config_cat.json")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the model trains; without a card 'cuda' raises")
    args = p.parse_args(argv)
    init_distributed(args.device)
    with open(args.config_path) as f:
        cfg = json.load(f)
    logger = setup_run_logging(cfg["model_path"])
    common = dict(label_path=cfg["label_path"], audio_path=cfg["wav_dir"], model_path=cfg["model_path"],
                  batch_size=cfg["batch_size"], accumulation_steps=cfg["accum_step"], epochs=cfg["epochs"],
                  lr=cfg["lr"], use_balanced_batch=cfg.get("use_balanced_batch", False),
                  normalize_wav=cfg.get("normalize_wav", True), log=logger.info)
    if variant == "xvector":
        from .xvector_engine import XVectorEngine

        engine = XVectorEngine(head_dim=cfg["head_dim"], seed=args.seed, xvector_ckpt=cfg.get("xvector_ckpt"),
                               device=args.device)
        return engine.fit(**common)

    from .engine import BaselineEngine

    engine = BaselineEngine(get_ssl_type(cfg["ssl_type"]) or cfg["ssl_type"], task="cat", head_dim=cfg["head_dim"],
                            seed=args.seed, dropout=cfg.get("dropout_head", 0.5),
                            loss_mode="ce_focal3" if variant == "focalloss" else "wce", device=args.device)
    return engine.fit(weight_decay=cfg.get("weight_decay", 1e-2),
                      use_timbre_perturb=cfg.get("use_timbre_perturb", False), tp_prob=cfg.get("tp_prob", 0.0),
                      **common)


def main(argv=None):
    """``train --task cat|dim [flags]``, ``eval --task cat|dim [--dev] [flags]``,
    or a ``LEGACY_STEMS`` stem and ``legacy_train_main``'s flags."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in LEGACY_STEMS:
        return legacy_train_main(LEGACY_STEMS[argv[0]], argv[1:])
    p = argparse.ArgumentParser(prog="python -m interspeech_ser_tpu_torch.baseline.cli")
    p.add_argument("command", choices=("train", "eval"))
    p.add_argument("--task", choices=("cat", "dim"), default="cat")
    p.add_argument("--dev", action="store_true", help="eval: the Development split instead of test3")
    args, rest = p.parse_known_args(argv)
    if args.command == "train":
        if args.dev:
            p.error("--dev is an eval flag")
        return train_main(args.task, rest)
    return eval_main(args.task, args.dev, rest)


if __name__ == "__main__":
    main()
    teardown()
