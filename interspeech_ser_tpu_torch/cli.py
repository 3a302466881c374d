"""Fusion scoring CLI: dev and blind-test CSVs from cached features.

    python -m interspeech_ser_tpu_torch.cli eval --config_path <config.json>
    python -m interspeech_ser_tpu_torch.cli test --config_path <config.json> --test_df <csv>

Port of ``interspeech_ser_tpu/cli.py::eval_main`` / ``test_main`` with the
reference's config JSON: the model comes from
``<model_path>/multimodal_ser.pt`` and the CSVs go to
``<model_path>/results/{dev,test}.csv``.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from .utils import labels as L
from .utils.config import load_fusion_config


def _parser(test: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--config_path", type=str, default="./configs/config_cat.json")
    if test:
        p.add_argument("--test_df", type=str, default="./test/Categorical_test.csv")
    return p


def _scoring_engine(args, strict: bool):
    from .train.engine import FusionEngine

    random.seed(args.seed)
    np.random.seed(args.seed)
    cfg = load_fusion_config(args.config_path)
    engine = FusionEngine(cfg, seed=args.seed)
    engine.load_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"), strict=strict)
    return cfg, engine


def eval_main(argv=None) -> str:
    """Dev-split scoring -> results/dev.csv."""
    from .train.data import LazyFeatureDataset
    from .train.engine import save_predictions_with_probs, setup_run_logging

    args = _parser().parse_args(argv)
    cfg, engine = _scoring_engine(args, strict=False)
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

    args = _parser(test=True).parse_args(argv)
    cfg, engine = _scoring_engine(args, strict=True)
    names = L.column(L.read_csv(args.test_df), "FileName")
    dummy = np.zeros((len(names), cfg.num_emotions), np.float32)
    ds = LazyFeatureDataset(names, dummy, cfg.lazy_dirs, cfg.feat_dims)
    logits = engine.predict(ds)
    return save_predictions_with_probs(
        logits, names, cfg.model_path, dtype="test", filename_header="FileName"
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    runners = {"eval": eval_main, "test": test_main}
    if not argv or argv[0] not in runners:
        raise SystemExit("usage: python -m interspeech_ser_tpu_torch.cli eval|test --config_path ...")
    print(runners[argv[0]](argv[1:]))


if __name__ == "__main__":
    main()
