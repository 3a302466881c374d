"""The legacy fusion variants (MoE, gender heads, gated pool, single modality)
and their checkpoints against the JAX package, on the CPU.

- one train step of each variant from the same weights as the JAX engine's
  ``_loss_terms`` (loss and every gradient within 2e-5, the eval logits
  within 1e-5; ``test_torch_legacy_engine.check_step_against_jax``): the MoE,
  the ``grl`` / ``aux`` / ``svm`` gender modes (``svm`` with and without focal
  loss, without the modality norms, 8 heads) and the single-modality model;
- the SVM trainer's quirk: without focal loss its CE is the gender head's;
- checkpoints: the param tree of each variant against the JAX model's
  (``jax.eval_shape``), the port's ``multimodal_ser.pt`` against the JAX
  engine's ``save_torch_checkpoint`` of the same weights, key for key and
  value for value (reference names for ``fusion`` without a gender head,
  flat flax keys otherwise), and loads both ways;
- the ``fromcat`` warm start: name + shape matches only, as the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interspeech_ser_tpu_torch.models import convert
from interspeech_ser_tpu_torch.train.engine import EngineOptions, FusionEngine
from interspeech_ser_tpu_torch.utils.config import load_fusion_config
from test_torch_legacy_engine import (
    _port_step, carried_pair, check_step_against_jax, config, port_params, train_batch, write_legacy_corpus,
)

torch.set_num_threads(2)

VARIANT_STEPS = {
    "moe": ({"model_variant": "moe"}, {}),
    "grl": ({"gender_mode": "grl"}, {}),
    "aux": ({"gender_mode": "aux"}, {}),
    "svm": ({"gender_mode": "svm", "attention_heads": 8, "modality_norm": False, "focal_dynamic_alpha": True}, {}),
    "svm_focal": ({"gender_mode": "svm", "attention_heads": 8, "modality_norm": False,
                   "focal_dynamic_alpha": True}, {"use_focalloss": True}),
    "single": ({"model_variant": "single"}, {}),
}

# every model the legacy trainers build: name -> (EngineOptions fields, whether the file has flat flax keys)
CHECKPOINTS = {
    "fusion": ({}, False),
    "ranking": ({"ranking": True}, False),
    "heads4": ({"attention_heads": 4}, False),
    "fiona": ({"gated_pool": True, "attention_heads": 8}, False),
    "no_norm": ({"modality_norm": False}, False),
    "dim": ({"task": "dim"}, False),
    "grl": ({"gender_mode": "grl"}, True),
    "aux": ({"gender_mode": "aux"}, True),
    "svm": ({"gender_mode": "svm", "attention_heads": 8, "modality_norm": False}, True),
    "moe": ({"model_variant": "moe"}, True),
    "single": ({"model_variant": "single"}, True),
    "dim_moe": ({"task": "dim", "model_variant": "moe"}, True),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy_variants")
    write_legacy_corpus(root)
    return root


@pytest.mark.parametrize("case", sorted(VARIANT_STEPS))
def test_variant_train_step_matches_jax(corpus, case):
    check_step_against_jax(corpus, case, *VARIANT_STEPS[case])


def test_svm_non_focal_branch_trains_the_gender_head_only(corpus):
    """The reference quirk, kept: without focal loss the SVM trainer's CE is
    the gender head's, so the emotion classifier gets no gradient."""
    path = config(corpus, "svm_quirk", dropout=0.0)
    port = FusionEngine(load_fusion_config(path), device="cpu", options=EngineOptions(**VARIANT_STEPS["svm"][0]))
    batch, class_w = train_batch(path, port, gender_csv=str(corpus / "gender.csv"))
    _port_step(port, batch, class_w)
    assert port.model.classifier[3].weight.grad is None
    assert float(port.model.gender_classifier.fc2.weight.grad.abs().max()) > 0.0


def _jax_param_shapes(jeng, cfg) -> dict:
    """The JAX model's param shapes, flattened, from ``jax.eval_shape`` of its init."""
    key = jax.random.PRNGKey(0)
    if jeng.opt.model_variant == "single":
        init = lambda k: jeng.model.init(k, jnp.zeros((2, 64, cfg.feat1_dim)), jnp.ones((2, 64)),  # noqa: E731
                                         deterministic=True)
    else:
        feats = [jnp.zeros((2, 8, d)) for d in cfg.feat_dims]
        masks = [jnp.ones((2, 8)) for _ in cfg.feat_dims]
        init = lambda k: jeng.model.init(k, feats, masks=masks, deterministic=True)  # noqa: E731
    tree = jax.eval_shape(init, key)["params"]
    return {k: tuple(v.shape) for k, v in convert.flatten_flax(jax.tree.map(lambda s: np.zeros(s.shape), tree)).items()}


@pytest.mark.parametrize("case", sorted(CHECKPOINTS))
def test_checkpoint_matches_the_jax_engine(corpus, tmp_path, case):
    opts, flat = CHECKPOINTS[case]
    path = config(corpus, f"ckpt_{case}")
    jeng, port, cfg = carried_pair(path, **opts)
    ours = convert.port_to_flax_flat(port.model.state_dict(), port.renames)
    assert {k: v.shape for k, v in ours.items()} == _jax_param_shapes(jeng, cfg)

    port.save_torch_checkpoint(str(tmp_path / "port.pt"))
    jeng.save_torch_checkpoint(str(tmp_path / "jax.pt"))
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert convert.is_flax_flat(got) == flat
    if not flat:  # the reference's names: the port's own state dict
        assert set(got) == set(port.model.state_dict())

    for src in ("port.pt", "jax.pt"):  # both files load into a fresh engine of another seed
        other = FusionEngine(cfg, seed=11, device="cpu", options=EngineOptions(**opts))
        other.load_torch_checkpoint(str(tmp_path / src), strict=True)
        for k, v in port.model.state_dict().items():
            assert torch.equal(other.model.state_dict()[k], v), (src, k)
    if not flat:  # the JAX engine reads the port's reference-named file
        jeng.load_torch_checkpoint(str(tmp_path / "port.pt"))
        for k, v in port_params(jeng.params, port.opt, len(cfg.feat_dims)).items():
            assert torch.equal(v, port.model.state_dict()[k]), k


@pytest.mark.parametrize("cat_opts", [{}, {"ranking": True}], ids=["cat", "cat_ranking"])
def test_fromcat_warm_start_keeps_name_and_shape_matches(corpus, tmp_path, cat_opts):
    """A dim engine warm-started from a cat checkpoint keeps every name +
    shape match and skips the 8-way head (and the neutral head), with the
    same result as the JAX engine's ``load_torch_checkpoint_filtered``."""
    path = config(corpus, "fromcat")
    cfg = load_fusion_config(path)
    cat = FusionEngine(cfg, seed=3, device="cpu", options=EngineOptions(**cat_opts))
    cat.save_torch_checkpoint(str(tmp_path / "cat.pt"))
    jeng, dim, _ = carried_pair(path, task="dim")
    before = {k: v.clone() for k, v in dim.model.state_dict().items()}
    kept, skipped = dim.load_torch_checkpoint_filtered(str(tmp_path / "cat.pt"))
    head = {"classifier.3.weight", "classifier.3.bias"}
    assert set(kept) == set(before) - head
    assert set(skipped) == head | {k for k in cat.model.state_dict() if k.startswith("neutral_")}
    after = dim.model.state_dict()
    for k in before:
        want = before[k] if k in head else cat.model.state_dict()[k]
        assert torch.equal(after[k], want), k
    jeng.load_torch_checkpoint_filtered(str(tmp_path / "cat.pt"))
    for k, v in port_params(jeng.params, dim.opt, len(cfg.feat_dims)).items():
        assert torch.equal(v, after[k]), k


def test_jax_engine_cannot_load_its_flat_checkpoints(corpus, tmp_path):
    """The JAX engine writes flat keys for the MoE but reads only reference
    names (ROADMAP §C): its load raises where the port's succeeds."""
    path = config(corpus, "moe_roundtrip")
    jeng, port, cfg = carried_pair(path, model_variant="moe")
    jeng.save_torch_checkpoint(str(tmp_path / "moe.pt"))
    with pytest.raises(KeyError, match="speech_projection.weight"):
        jeng.load_torch_checkpoint(str(tmp_path / "moe.pt"))
    port.load_torch_checkpoint(str(tmp_path / "moe.pt"), strict=True)
