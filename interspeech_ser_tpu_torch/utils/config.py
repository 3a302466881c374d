"""Fusion config loading with the reference JSON schema.

Port of ``interspeech_ser_tpu/utils/config.py``: required keys raise
``KeyError`` when absent; ``use_balanced_batch`` / ``use_focalloss`` default
to False; ``lazy_dir3`` makes a config trimodal. ``raw`` keeps the whole
JSON, so keys outside the schema (``pretrained_path`` of the ``fromcat``
trainer) stay readable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional


@dataclasses.dataclass
class FusionConfig:
    wav_dir: str
    txt_dir: str
    lazy_dir1: str
    lazy_dir2: str
    label_path: str
    feat1_dim: int
    feat2_dim: int
    epochs: int
    lr: float
    model_path: str
    batch_size: int
    accum_step: int
    lazy_dir3: Optional[str] = None
    feat3_dim: Optional[int] = None
    use_balanced_batch: bool = False
    use_focalloss: bool = False
    fusion_hidden_dim: int = 512
    num_emotions: int = 8
    dropout: float = 0.5
    raw: Mapping[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if not (self.accum_step > 0 and self.batch_size % self.accum_step == 0):
            raise ValueError(
                f"accum_step must divide batch_size: got batch_size="
                f"{self.batch_size}, accum_step={self.accum_step}"
            )

    @property
    def is_trimodal(self) -> bool:
        return self.lazy_dir3 is not None

    @property
    def feat_dims(self) -> tuple:
        if self.is_trimodal:
            return (self.feat1_dim, self.feat2_dim, self.feat3_dim)
        return (self.feat1_dim, self.feat2_dim)

    @property
    def lazy_dirs(self) -> tuple:
        if self.is_trimodal:
            return (self.lazy_dir1, self.lazy_dir2, self.lazy_dir3)
        return (self.lazy_dir1, self.lazy_dir2)


def load_fusion_config(config_path: str, trimodal: Optional[bool] = None) -> FusionConfig:
    """``trimodal=None``: a config with ``lazy_dir3`` is trimodal (and then
    needs ``feat3_dim``); ``trimodal=True`` requires ``lazy_dir3`` (the
    trimodal trainers read it unconditionally); ``False`` ignores it."""
    with open(config_path, "r") as f:
        cfg = json.load(f)
    has3 = "lazy_dir3" in cfg
    if trimodal and not has3:
        raise KeyError("lazy_dir3")
    use3 = has3 if trimodal is None else trimodal
    return FusionConfig(
        wav_dir=cfg["wav_dir"],
        txt_dir=cfg["txt_dir"],
        lazy_dir1=cfg["lazy_dir1"],
        lazy_dir2=cfg["lazy_dir2"],
        lazy_dir3=cfg["lazy_dir3"] if use3 else None,
        label_path=cfg["label_path"],
        feat1_dim=int(cfg["feat1_dim"]),
        feat2_dim=int(cfg["feat2_dim"]),
        feat3_dim=int(cfg["feat3_dim"]) if use3 else None,
        epochs=int(cfg["epochs"]),
        lr=float(cfg["lr"]),
        model_path=cfg["model_path"],
        batch_size=int(cfg["batch_size"]),
        accum_step=int(cfg["accum_step"]),
        use_balanced_batch=bool(cfg.get("use_balanced_batch", False)),
        use_focalloss=bool(cfg.get("use_focalloss", False)),
        fusion_hidden_dim=int(cfg.get("fusion_hidden_dim", 512)),
        num_emotions=int(cfg.get("num_emotions", 8)),
        dropout=float(cfg.get("dropout", 0.5)),
        raw=cfg,
    )
