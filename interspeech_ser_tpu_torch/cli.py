"""Fusion CLIs: train, dev / blind-test scoring, train-split extraction.

    python -m interspeech_ser_tpu_torch.cli train --config_path <cfg> [--ranking] [--trimodal] [--resume]
    python -m interspeech_ser_tpu_torch.cli eval --config_path <cfg> [--ranking] [--trimodal]
    python -m interspeech_ser_tpu_torch.cli test --config_path <cfg> --test_df <csv> [--ranking] [--trimodal]
    python -m interspeech_ser_tpu_torch.cli extract_train --config_path <cfg> --train_df <csv> [--trimodal]

Port of ``interspeech_ser_tpu/cli.py`` (``train_main``, ``eval_main``,
``test_main``, ``extract_train_main``) with the reference's config JSON.
``--ranking`` / ``--trimodal`` are the arguments the ``bin/`` scripts pass:
the four trainers are ``train`` with each pair of them. The model goes to
and comes from ``<model_path>/multimodal_ser.pt``; the CSVs go to
``<model_path>/results/{dev,test,train}.csv``. Every command runs on the
card (``--device cuda``, the default; no card raises) unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .utils import labels as L
from .utils.config import load_fusion_config
from .utils.device import DEVICES
from .utils.seeding import set_deterministic


def _parser(train: bool = False, scoring: bool = False, test: bool = False,
            extract: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--config_path", type=str, default="./configs/config_cat.json")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES)
    p.add_argument("--trimodal", action="store_true",
                   help="three modalities (the config must have lazy_dir3); focal loss with dynamic alpha")
    if train or scoring:
        p.add_argument("--ranking", action="store_true",
                       help="the neutral-vs-rest head, soft-margin loss and neutral-balanced sampling")
    if train:
        p.add_argument("--resume", action="store_true",
                       help="resume from <model_path>/train_state.pt, the per-epoch full-state checkpoint")
    if test:
        p.add_argument("--test_df", type=str, default="./test/Categorical_test.csv")
    if extract:
        p.add_argument("--train_df", type=str, default="./test/train_stacking_sample.csv")
    return p


def _engine(args, cfg, ranking: bool):
    from .train.engine import FusionEngine

    return FusionEngine(cfg, seed=args.seed, device=args.device, ranking=ranking,
                        focal_dynamic_alpha=args.trimodal)


def train_main(argv=None) -> dict:
    """Fusion trainer -> the best epoch's record; ``multimodal_ser.pt`` holds its model."""
    from .train.engine import setup_run_logging

    args = _parser(train=True).parse_args(argv)
    set_deterministic(seed=args.seed)
    cfg = load_fusion_config(args.config_path, trimodal=args.trimodal or None)
    logger = setup_run_logging(cfg.model_path)
    logger.info(f"Starting a lazy fusion experiment in model path = {cfg.model_path}")
    logger.info(
        f"Using LR = {cfg.lr} Epochs = {cfg.epochs} Batch size = {cfg.batch_size} "
        f"Accum steps = {cfg.accum_step}"
    )
    logger.info(f"Using balanced batch = {cfg.use_balanced_batch}")
    logger.info(f"Using focalloss = {cfg.use_focalloss}")
    rows = L.load_merged(cfg.label_path, cfg.txt_dir)
    train_rows, val_rows = L.split(rows, "Train"), L.split(rows, "Development")
    logger.info(f"Class weights: {L.class_weights(train_rows)}")
    engine = _engine(args, cfg, args.ranking)
    logger.info("Starting training...")
    best = engine.fit(train_rows, val_rows, log=logger, resume=args.resume)
    logger.info(f"Best epoch {best['epoch']+1}: dev macro-F1 = {best['macro_f1']:.6f}")
    return best


def _scoring_engine(args, ranking: bool, strict: bool):
    set_deterministic(seed=args.seed, verbose=False)
    cfg = load_fusion_config(args.config_path, trimodal=args.trimodal or None)
    engine = _engine(args, cfg, ranking)
    engine.load_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"), strict=strict)
    return cfg, engine


def eval_main(argv=None) -> str:
    """Dev-split scoring -> results/dev.csv."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs, setup_run_logging

    args = _parser(scoring=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, args.ranking, strict=False)
    logger = setup_run_logging(cfg.model_path)
    val = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Development")
    names = L.column(val, "FileName")
    ds = LazyFeatureDataset(names, L.matrix(val), cfg.lazy_dirs, cfg.feat_dims)
    logger.info("Starting evaluation...")
    res = engine.evaluate(ds)
    logger.info(f"|Metrics| eval_loss = {res['loss']:.6f} eval f1 = {res['macro_f1']:.6f}")
    return save_predictions_with_probs(
        res["logits"], names, cfg.model_path, dtype="dev", filename_header="Filename"
    )


def test_main(argv=None) -> str:
    """Blind-test scoring -> results/test.csv."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs

    args = _parser(scoring=True, test=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, args.ranking, strict=True)
    names = L.column(L.read_csv(args.test_df), "FileName")
    dummy = np.zeros((len(names), cfg.num_emotions), np.float32)
    ds = LazyFeatureDataset(names, dummy, cfg.lazy_dirs, cfg.feat_dims)
    logits = engine.predict(ds)
    return save_predictions_with_probs(
        logits, names, cfg.model_path, dtype="test", filename_header="FileName"
    )


def extract_train_main(argv=None) -> str:
    """Train-subset scoring -> results/train.csv, for the stacking model."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs

    args = _parser(extract=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, ranking=False, strict=False)
    sub = L.split(L.load_merged(args.train_df, cfg.txt_dir), "Train")
    names = L.column(sub, "FileName")
    ds = LazyFeatureDataset(names, L.matrix(sub), cfg.lazy_dirs, cfg.feat_dims)
    logits = engine.predict(ds)
    return save_predictions_with_probs(
        logits, names, cfg.model_path, dtype="train", filename_header="Filename"
    )


RUNNERS = {"train": train_main, "eval": eval_main, "test": test_main, "extract_train": extract_train_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in RUNNERS:
        raise SystemExit(
            f"usage: python -m interspeech_ser_tpu_torch.cli {'|'.join(RUNNERS)} --config_path ..."
        )
    print(RUNNERS[argv[0]](argv[1:]))


if __name__ == "__main__":
    main()
