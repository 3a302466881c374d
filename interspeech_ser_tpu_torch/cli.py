"""Fusion CLIs: train, dev / blind-test scoring, train-split extraction, and
the dimensional task's dev / blind-test scoring.

    python -m interspeech_ser_tpu_torch.cli train --config_path <cfg> [--ranking] [--trimodal] [--resume]
    python -m interspeech_ser_tpu_torch.cli eval --config_path <cfg> [--ranking] [--trimodal]
    python -m interspeech_ser_tpu_torch.cli test --config_path <cfg> --test_df <csv> [--ranking] [--trimodal]
    python -m interspeech_ser_tpu_torch.cli extract_train --config_path <cfg> --train_df <csv> [--trimodal]
    python -m interspeech_ser_tpu_torch.cli eval_dim --config_path <cfg>
    python -m interspeech_ser_tpu_torch.cli test_dim --config_path <cfg> --test_df <csv>
    python -m interspeech_ser_tpu_torch.cli <runner> --legacy <bin/old script stem> --config_path <cfg> ...

Port of ``interspeech_ser_tpu/cli.py`` (``train_main``, ``eval_main``,
``test_main``, ``extract_train_main``, ``eval_dim_main``, ``test_dim_main``)
with the reference's config JSON and the JAX runners' keyword overrides
(the ``EngineOptions`` fields, plus ``ranking`` / ``trimodal``).
``--ranking`` / ``--trimodal`` are the arguments the ``bin/`` scripts pass:
the four trainers are ``train`` with each pair of them. ``LEGACY`` holds
the keyword arguments each ``bin/old`` wrapper passes to the JAX runners;
``--legacy <stem>`` applies them. The gender trainers read the gender
labels CSV from ``--gender_labels_csv`` (default: ``$GENDER_LABELS_CSV``, as
the wrappers do). The model goes to and comes from
``<model_path>/multimodal_ser.pt``; the CSVs go to
``<model_path>/results/{dev,test,train}.csv``. Every command runs on the
card (``--device cuda``, the default; no card raises) unless given
``--device cpu``. Under ``torchrun --nproc_per_node N -m
interspeech_ser_tpu_torch.cli ...`` every command runs data-parallel over
the N ranks (``FusionEngine``); rank 0 alone writes the checkpoint, the
CSVs and the logs.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from .utils import labels as L
from .utils.config import load_fusion_config
from .utils.device import DEVICES, init_distributed, is_main, teardown
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
        p.add_argument("--gender_labels_csv", type=str, default=os.environ.get("GENDER_LABELS_CSV"),
                       help="FileName,Gender CSV of the gender trainers (default: $GENDER_LABELS_CSV)")
    if test:
        p.add_argument("--test_df", type=str, default="./test/Categorical_test.csv")
    if extract:
        p.add_argument("--train_df", type=str, default="./test/train_stacking_sample.csv")
    return p


# the keyword arguments each bin/old wrapper passes to interspeech_ser_tpu.cli:
# stem -> (runner, overrides); the gender wrappers' gender_labels_csv is
# --gender_labels_csv, whose default is the same $GENDER_LABELS_CSV
LEGACY = {
    "eval_cat_bimodal_lazy": ("eval", {"attention_heads": 4}),
    "eval_cat_bimodal_lazy_fiona": ("eval", {"gated_pool": True, "attention_heads": 8}),
    "eval_cat_bimodal_lazy_moe": ("eval", {"model_variant": "moe"}),
    "eval_cat_trimodal_lazy": ("eval", {"trimodal": True}),
    "eval_dim_bimodal_lazy": ("eval_dim", {}),
    "extract_train_cat_bimodal_lazy": ("extract_train", {}),
    "test_cat_bimodal_lazy": ("test", {"attention_heads": 4}),
    "test_cat_bimodal_lazy_1head": ("test", {}),
    "test_cat_bimodal_lazy_stacking": ("test", {"attention_heads": 4}),
    "test_dim_bimodal_lazy": ("test_dim", {}),
    "train_cat_bimodal_lazy": ("train", {"attention_heads": 4}),
    "train_cat_bimodal_lazy_1head_clustered": ("train", {}),
    "train_cat_bimodal_lazy_1head_labelsmooth": ("train", {"loss_type": "labelsmooth"}),
    "train_cat_bimodal_lazy_cka": ("train", {"cka_weight": 0.1}),
    "train_cat_bimodal_lazy_cka_inv": ("train", {"cka_weight": -0.1}),
    "train_cat_bimodal_lazy_f1loss": ("train", {"loss_type": "f1"}),
    "train_cat_bimodal_lazy_f1loss_wce": ("train", {"loss_type": "f1", "add_ce_to_f1": True}),
    "train_cat_bimodal_lazy_fiona": ("train", {"gated_pool": True, "attention_heads": 8, "cka_weight": 1.0,
                                              "focal_dynamic_alpha": True}),
    "train_cat_bimodal_lazy_focaloss_gamma3": ("train", {"loss_type": "focal", "focal_gamma": 3.0}),
    "train_cat_bimodal_lazy_gender": ("train", {"gender_mode": "aux"}),
    "train_cat_bimodal_lazy_gender_svm": ("train", {"gender_mode": "svm", "attention_heads": 8,
                                                   "modality_norm": False, "focal_dynamic_alpha": True}),
    "train_cat_bimodal_lazy_grlgender": ("train", {"gender_mode": "grl"}),
    "train_cat_bimodal_lazy_hierarquicalloss": ("train", {"loss_type": "hierarchical"}),
    "train_cat_bimodal_lazy_labelsmoothing": ("train", {"loss_type": "labelsmooth", "attention_heads": 4}),
    "train_cat_bimodal_lazy_moe": ("train", {"model_variant": "moe"}),
    "train_cat_bimodal_lazy_nowce": ("train", {"unweighted_ce": True}),
    "train_cat_bimodal_lazy_prosodycodes": ("train", {}),
    "train_cat_bimodal_lazy_prosodyembeddings_focaloss": ("train", {"loss_type": "focal"}),
    "train_cat_wavlm_lazy": ("train", {"model_variant": "single"}),
    "train_cat_wavlmbaseplussv_lazy": ("train", {"model_variant": "single"}),
    "train_dim_bimodal_lazy": ("train", {"task": "dim"}),
    "train_dim_bimodal_lazy_arousal": ("train", {"task": "dim", "dim_columns": ("EmoAct",)}),
    "train_dim_bimodal_lazy_cka": ("train", {"task": "dim", "cka_weight": 0.1}),
    "train_dim_bimodal_lazy_dominance": ("train", {"task": "dim", "dim_columns": ("EmoDom",)}),
    "train_dim_bimodal_lazy_fromcat": ("train", {"task": "dim", "init_from_pretrained": True}),
    "train_dim_bimodal_lazy_valence": ("train", {"task": "dim", "dim_columns": ("EmoVal",)}),
}


def _options(args, overrides: dict):
    """-> (trimodal, EngineOptions): ``ranking`` / ``trimodal`` from the flags
    or the overrides; ``focal_dynamic_alpha`` defaults to ``trimodal``."""
    from .train.engine import EngineOptions

    overrides = dict(overrides)
    trimodal = bool(args.trimodal or overrides.pop("trimodal", False))
    ranking = bool(getattr(args, "ranking", False) or overrides.pop("ranking", False))
    overrides.setdefault("focal_dynamic_alpha", trimodal)
    return trimodal, EngineOptions(ranking=ranking, **overrides)


def train_main(argv=None, gender_labels_csv: str = None, **overrides) -> dict:
    """Fusion trainer -> the best epoch's record; ``multimodal_ser.pt`` holds
    its model. ``overrides``: the legacy surface (``task='dim'``,
    ``loss_type``, ``cka_weight``, ``gender_mode``, ``model_variant`` ...,
    see ``EngineOptions``)."""
    from .train.engine import FusionEngine, setup_run_logging

    args = _parser(train=True).parse_args(argv)
    init_distributed(args.device)
    trimodal, options = _options(args, overrides)
    set_deterministic(seed=args.seed)
    cfg = load_fusion_config(args.config_path, trimodal=trimodal or None)
    logger = setup_run_logging(cfg.model_path)
    logger.info(f"Starting a lazy fusion experiment in model path = {cfg.model_path}")
    logger.info(
        f"Using LR = {cfg.lr} Epochs = {cfg.epochs} Batch size = {cfg.batch_size} "
        f"Accum steps = {cfg.accum_step}"
    )
    logger.info(f"Using balanced batch = {cfg.use_balanced_batch}")
    logger.info(f"Using focalloss = {cfg.use_focalloss}")
    rows = L.load_merged(cfg.label_path, cfg.txt_dir)
    if options.gender_mode is not None:
        gender_csv = gender_labels_csv or args.gender_labels_csv
        if not gender_csv:
            raise ValueError(f"gender_mode={options.gender_mode!r} needs the gender labels CSV (FileName, Gender): "
                             "pass --gender_labels_csv or set GENDER_LABELS_CSV")
        rows = L.merge_gender(rows, gender_csv)
    train_rows, val_rows = L.split(rows, "Train"), L.split(rows, "Development")
    if options.task != "dim":
        logger.info(f"Class weights: {L.class_weights(train_rows)}")
    engine = FusionEngine(cfg, seed=args.seed, device=args.device, options=options)
    if options.init_from_pretrained:
        # warm start from the config's pretrained_path, name + shape matches only
        kept, skipped = engine.load_torch_checkpoint_filtered(cfg.raw["pretrained_path"])
        logger.info(f"Warm-started from {cfg.raw['pretrained_path']}: {len(kept)} tensors loaded, "
                    f"skipped {skipped}")
    logger.info("Starting training...")
    best = engine.fit(train_rows, val_rows, log=logger, resume=args.resume)
    if options.task == "dim":
        logger.info(f"Best epoch {best['epoch']+1}: dev loss = {best['dev_loss']:.6f}")
    else:
        logger.info(f"Best epoch {best['epoch']+1}: dev macro-F1 = {best['macro_f1']:.6f}")
    return best


def _scoring_engine(args, overrides: dict, strict: bool):
    from .train.engine import FusionEngine

    init_distributed(args.device)
    trimodal, options = _options(args, overrides)
    set_deterministic(seed=args.seed, verbose=False)
    cfg = load_fusion_config(args.config_path, trimodal=trimodal or None)
    engine = FusionEngine(cfg, seed=args.seed, device=args.device, options=options)
    engine.load_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"), strict=strict)
    return cfg, engine


def eval_main(argv=None, **overrides) -> str:
    """Dev-split scoring -> results/dev.csv."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs, setup_run_logging

    args = _parser(scoring=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, overrides, strict=False)
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


def test_main(argv=None, **overrides) -> str:
    """Blind-test scoring -> results/test.csv."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs

    args = _parser(scoring=True, test=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, overrides, strict=True)
    names = L.column(L.read_csv(args.test_df), "FileName")
    dummy = np.zeros((len(names), cfg.num_emotions), np.float32)
    ds = LazyFeatureDataset(names, dummy, cfg.lazy_dirs, cfg.feat_dims)
    logits = engine.predict(ds)
    return save_predictions_with_probs(
        logits, names, cfg.model_path, dtype="test", filename_header="FileName"
    )


def extract_train_main(argv=None, **overrides) -> str:
    """Train-subset scoring -> results/train.csv, for the stacking model."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs

    args = _parser(extract=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, overrides, strict=False)
    sub = L.split(L.load_merged(args.train_df, cfg.txt_dir), "Train")
    names = L.column(sub, "FileName")
    ds = LazyFeatureDataset(names, L.matrix(sub), cfg.lazy_dirs, cfg.feat_dims)
    logits = engine.predict(ds)
    return save_predictions_with_probs(
        logits, names, cfg.model_path, dtype="train", filename_header="Filename"
    )


def _write_dim_csv(path: str, header: str, names, cols, preds: np.ndarray) -> str:
    """``<header>, <dim columns>`` rows, values at 4 decimals (rank 0 writes)."""
    if not is_main():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([header] + list(cols))
        for name, row in zip(names, preds):
            w.writerow([name] + [f"{v:.4f}" for v in row])
    return path


def eval_dim_main(argv=None, **overrides) -> str:
    """Dim-task dev scoring -> results/dev.csv (``Filename`` + the attributes)."""
    from .train.data import LazyFeatureDataset
    from .train.engine import setup_run_logging
    from .utils.metrics import concordance_ccc

    args = _parser().parse_args(argv)
    cfg, engine = _scoring_engine(args, {**overrides, "task": "dim"}, strict=False)
    logger = setup_run_logging(cfg.model_path)
    val = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Development")
    names, cols = L.column(val, "FileName"), engine.dim_columns
    labels = L.matrix(val, cols)
    preds = engine.predict(LazyFeatureDataset(names, labels, cfg.lazy_dirs, cfg.feat_dims))
    cccs = [concordance_ccc(preds[:, i], labels[:, i]) for i in range(len(cols))]
    logger.info(f"|Metrics| dev CCC = {cccs}")
    return _write_dim_csv(os.path.join(cfg.model_path, "results", "dev.csv"), "Filename", names, cols, preds)


def test_dim_main(argv=None, **overrides) -> str:
    """Dim-task blind-test scoring -> results/test.csv (``FileName`` + the attributes)."""
    from .train.data import LazyFeatureDataset

    args = _parser(test=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, {**overrides, "task": "dim"}, strict=True)
    names, cols = L.column(L.read_csv(args.test_df), "FileName"), engine.dim_columns
    dummy = np.zeros((len(names), len(cols)), np.float32)
    preds = engine.predict(LazyFeatureDataset(names, dummy, cfg.lazy_dirs, cfg.feat_dims))
    return _write_dim_csv(os.path.join(cfg.model_path, "results", "test.csv"), "FileName", names, cols, preds)


RUNNERS = {"train": train_main, "eval": eval_main, "test": test_main, "extract_train": extract_train_main,
           "eval_dim": eval_dim_main, "test_dim": test_dim_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in RUNNERS:
        raise SystemExit(
            f"usage: python -m interspeech_ser_tpu_torch.cli {'|'.join(RUNNERS)} [--legacy STEM] --config_path ..."
        )
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--legacy", choices=sorted(LEGACY))
    known, rest = pre.parse_known_args(argv[1:])
    overrides = {}
    if known.legacy:
        runner, overrides = LEGACY[known.legacy]
        if runner != argv[0]:
            raise SystemExit(f"--legacy {known.legacy} runs `{runner}`, not `{argv[0]}`")
    print(RUNNERS[argv[0]](rest, **overrides))


if __name__ == "__main__":
    main()
    teardown()
