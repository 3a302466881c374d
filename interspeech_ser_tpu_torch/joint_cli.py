"""The joint RoBERTa + WavLM trainers and the text-only RoBERTa trainer.

    python -m interspeech_ser_tpu_torch.joint_cli <bin/old stem> --config_path <cfg> [--seed 7] [--device cpu]

Port of ``interspeech_ser_tpu/joint_cli.py`` (``train_main``,
``train_text_main``) with the same flags and config JSON: ``wav_dir``,
``txt_dir`` (the ``FileName,transcription`` CSV), ``label_path``,
``ssl_type``, ``batch_size``, ``accum_step``, ``epochs``, ``lr``,
``model_path``, ``head_dim``, and the optional ``weight_decay`` (1e-6),
``use_balanced_batch``, ``normalize_wav`` (true), ``use_timbre_perturb``
with ``tp_prob`` (the joint trainers' timbre perturbation of training wavs)
and ``use_focalloss`` (text only); ``pooling_type``
and ``dropout_head`` are read by the reference and used by neither package.
``text_type`` names the RoBERTa directory (default ``roberta-base`` for
``base`` / ``ftall``, ``roberta-large`` otherwise, which resolve only as
local directories: the port has no hub access) and ``tokenizer_path`` the
directory of its ``vocab.json`` / ``merges.txt`` (default: ``text_type``).
Transcripts are tokenized by the port's byte-level BPE
(``utils/bpe.RobertaBpeTokenizer``), framed, truncated and padded to 128
tokens, as the JAX package's ``AutoTokenizer`` call does.

``main`` takes the stem of a ``bin/old/train_cat_roberta*.py`` wrapper
first (``STEMS``: the text-only trainer, or a ``train.joint_engine.VARIANTS``
entry), then the flags. Every run is on the card (``--device cuda``, the
default; no card raises) unless given ``--device cpu``. The run writes
``final_ser.pt`` (``ftall`` also ``final_text_model.pt`` and
``final_ssl.pt``; the text-only trainer ``text_ser.pt``),
``train_norm_stat.pkl`` and a ``loggingtxt-*.log`` into ``model_path``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .utils.device import DEVICES, init_distributed, teardown

MAX_LENGTH = 128  # the JAX tokenizer's padding="max_length"

# bin/old wrapper stem -> JointEngine variant (None: the text-only trainer)
STEMS = {
    "train_cat_roberta": None,
    "train_cat_roberta_wavlm": "base",
    "train_cat_roberta_wavlm_ftall": "ftall",
    "train_cat_roberta_wavlm_large": "large",
    "train_cat_roberta_wavlm_large_cka": "cka",
    "train_cat_roberta_wavlm_large_ckainv": "ckainv",
    "train_cat_roberta_wavlm_small_cka": "small_cka",
}


def make_bpe_tokenize(path: str, max_length: int = MAX_LENGTH):
    """``texts -> {"input_ids", "attention_mask"}`` [N, max_length] int64 from
    the directory's byte-level BPE files; a missing text is the empty one."""
    from .utils.bpe import RobertaBpeTokenizer

    tokenizer = RobertaBpeTokenizer.from_pretrained(path)

    def tokenize(texts):
        return tokenizer([t if isinstance(t, str) else "" for t in texts], padding="max_length", truncation=True,
                         max_length=max_length, return_tensors="np")

    return tokenize


def _parse(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--config_path", type=str, default="./configs/config_cat.json")
    p.add_argument("--device", type=str, default="cuda", choices=DEVICES,
                   help="where the models run; without a card 'cuda' raises")
    args = p.parse_args(argv)
    init_distributed(args.device)
    with open(args.config_path) as f:
        return args, json.load(f)


def train_main(variant: str, argv: Optional[list] = None, tokenize=None, dtype: str = "float32") -> dict:
    """Train one joint variant (``train.joint_engine.VARIANTS``) -> ``JointEngine.fit``'s result."""
    from .baseline.cli import get_ssl_type
    from .train.engine import setup_run_logging
    from .train.joint_engine import VARIANTS, JointEngine

    args, config = _parse(argv)
    model_path = config["model_path"]
    logger = setup_run_logging(model_path)
    ssl_type = get_ssl_type(config["ssl_type"]) or config["ssl_type"]
    text_type = config.get("text_type", "roberta-base" if variant in ("base", "ftall") else "roberta-large")
    if tokenize is None:
        tokenize = make_bpe_tokenize(config.get("tokenizer_path", text_type))
    engine = JointEngine(ssl_type, text_type, tokenize, VARIANTS[variant], head_dim=config["head_dim"],
                         seed=args.seed, dtype=dtype, device=args.device)
    logger.info(f"Starting an experimento in model path = {model_path}")
    logger.info(f"Using ssl = {ssl_type} LR = {config['lr']} Epochs = {config['epochs']} "
                f"Batch size = {config['batch_size']} Accum steps = {config['accum_step']}")
    return engine.fit(
        label_path=config["label_path"], audio_path=config["wav_dir"], txt_path=config["txt_dir"],
        model_path=model_path, batch_size=config["batch_size"], accumulation_steps=config["accum_step"],
        epochs=config["epochs"], lr=config["lr"], weight_decay=config.get("weight_decay", 1e-6),
        use_balanced_batch=config.get("use_balanced_batch", False), normalize_wav=config.get("normalize_wav", True),
        use_timbre_perturb=config.get("use_timbre_perturb", False), tp_prob=config.get("tp_prob", 0.0),
        log=logger.info,
    )


def train_text_main(argv: Optional[list] = None, tokenize=None, dtype: str = "float32") -> dict:
    """The text-only RoBERTa fine-tune -> ``TextOnlyEngine.fit``'s result."""
    from .train.engine import setup_run_logging
    from .train.joint_engine import TextOnlyEngine

    args, config = _parse(argv)
    model_path = config["model_path"]
    logger = setup_run_logging(model_path)
    text_type = config.get("text_type", "roberta-base")
    if tokenize is None:
        tokenize = make_bpe_tokenize(config.get("tokenizer_path", text_type))
    engine = TextOnlyEngine(text_type, tokenize, seed=args.seed, dtype=dtype, device=args.device)
    return engine.fit(
        label_path=config["label_path"], txt_path=config["txt_dir"], model_path=model_path,
        batch_size=config["batch_size"], accumulation_steps=config["accum_step"], epochs=config["epochs"],
        lr=config["lr"], use_focalloss=config.get("use_focalloss", False),
        use_balanced_batch=config.get("use_balanced_batch", False), log=logger.info,
    )


def main(argv: Optional[list] = None) -> dict:
    """``<stem> [flags]``: the ``bin/old`` wrapper of that stem's trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in STEMS:
        raise SystemExit(f"usage: joint_cli <stem> [--config_path cfg] [--seed N] [--device cuda|cpu]; "
                         f"stems: {', '.join(STEMS)}")
    variant = STEMS[argv[0]]
    return train_text_main(argv[1:]) if variant is None else train_main(variant, argv[1:])


if __name__ == "__main__":
    main()
    teardown()
