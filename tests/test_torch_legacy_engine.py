"""The port's legacy fusion trainers (``EngineOptions``) against the JAX engine, on the CPU.

A small corpus in the reference's file contract (label CSV with the 8
emotions, ``EmoAct`` / ``EmoDom`` / ``EmoVal`` and ``Split_Set``, a
``FileName,Gender`` CSV, transcripts, per-utterance ``.pt`` dirs for three
modalities; feature dims 24/16/12, H=16), ``dropout: 0.0``:

- one train step from carried flax params on a batch with a padding row:
  the loss and every gradient against ``jax.value_and_grad`` of the JAX
  ``_loss_terms``, atol 2e-5, for every ``loss_type``, ``cka_weight`` +-0.1,
  the dim task with and without ``mse_weight``, each gender mode, the MoE,
  the gated pool, ``masked=False`` and the single-modality model (its
  dropout is hard-coded, so in eval mode with autograd on);
- padded batches against unpadded ones for the variants whose losses mask
  the padding rows; CKA and diff-F1 read the whole padded batch, as the JAX
  engine's do (ROADMAP §C, kept for parity);
- option checks: ``n_devices``, unknown values, a gender mode without targets.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interspeech_ser_tpu_torch.models import convert
from interspeech_ser_tpu_torch.train import data as tdata
from interspeech_ser_tpu_torch.train.engine import EngineOptions, FusionEngine
from interspeech_ser_tpu_torch.utils import labels as L
from interspeech_ser_tpu_torch.utils.config import load_fusion_config

torch.set_num_threads(2)

DIMS = (24, 16, 12)
HID = 16
N_TRAIN, N_DEV, N_TEST = 16, 8, 4
DIM_COLS = ("EmoAct", "EmoDom", "EmoVal")


def write_legacy_corpus(root) -> None:
    """Seeded features, the label CSV (classes, attributes, splits), the
    gender CSV (one row missing, one not Female / Male), transcripts, a test
    CSV and ``base.json`` (bimodal, batch 8, one epoch) under ``root``."""
    rng = np.random.default_rng(17)
    dirs = [root / f"lazy{m + 1}" for m in range(3)]
    for d in dirs:
        d.mkdir()
    means = rng.normal(scale=2.0, size=(8, DIMS[0]))
    rows, genders = [], []
    for i in range(N_TRAIN + N_DEV + N_TEST):
        cls = i % 8
        name = f"MSP-PODCAST_{i:04d}.wav"
        lengths = (int(rng.integers(20, 65)), int(rng.integers(5, 30)), int(rng.integers(10, 40)))
        for m, (d, t) in enumerate(zip(dirs, lengths)):
            f = rng.normal(size=(t, DIMS[m])).astype(np.float32) + (means[cls] if m == 0 else 0.0)
            torch.save(torch.from_numpy(f), str(d / name.replace(".wav", ".pt")))
        split = "Train" if i < N_TRAIN else "Development" if i < N_TRAIN + N_DEV else "Test3"
        attrs = [round(float(v), 3) for v in rng.uniform(1.0, 7.0, 3) + 0.3 * (cls - 3.5)]
        rows.append([name] + [float(c == cls) for c in range(8)] + attrs + [split])
        if i != 5:
            genders.append([name, "Unknown" if i == 7 else ("Male" if rng.random() < 0.5 else "Female")])
    header = ["FileName"] + L.CLASSES + list(DIM_COLS) + ["Split_Set"]
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([header] + rows)
    with open(root / "gender.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "Gender"]] + genders)
    with open(root / "train_stacking_sample.csv", "w", newline="") as f:
        csv.writer(f).writerows([header] + rows[:10])
    with open(root / "transcripts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[r[0], "hi"] for r in rows])
    with open(root / "test.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName"]] + [[r[0]] for r in rows if r[-1] == "Test3"])
    base = {
        "wav_dir": str(root), "txt_dir": str(root / "transcripts.csv"),
        "lazy_dir1": str(dirs[0]), "lazy_dir2": str(dirs[1]), "label_path": str(root / "labels.csv"),
        "feat1_dim": DIMS[0], "feat2_dim": DIMS[1], "use_balanced_batch": False, "use_focalloss": False,
        "epochs": 1, "lr": 5e-3, "model_path": str(root / "exp"), "batch_size": 8, "accum_step": 1,
        "fusion_hidden_dim": HID,
    }
    with open(root / "base.json", "w") as f:
        json.dump(base, f)


def config(root, name, **over) -> str:
    with open(root / "base.json") as f:
        cfg = json.load(f)
    cfg.update(model_path=str(root / f"exp_{name}"))
    if over.pop("trimodal", False):
        cfg.update(lazy_dir3=str(root / "lazy3"), feat3_dim=DIMS[2])
    cfg.update(over)
    path = root / f"{name}.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def unflatten(flat: dict) -> dict:
    """``{"a.b.leaf": array}`` -> nested flax params."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return tree


def port_params(params, options: EngineOptions, n_mod: int):
    """JAX params (or gradients) of an engine with ``options`` -> the port's state dict."""
    host = jax.tree.map(np.asarray, params)
    if options.model_variant == "fusion":
        return convert.fusion_params_from_flax(host, n_mod)
    return convert.variant_params_from_flax(host)


def carried_pair(path, **opts):
    """(JAX engine, port engine on the CPU, loaded config): the port's initial
    weights carried into the JAX engine's ``params`` by ``port_to_flax_flat``
    (the JAX init would cost a compile per model)."""
    from interspeech_ser_tpu.train.engine import EngineOptions as JaxOptions
    from interspeech_ser_tpu.train.engine import FusionEngine as JaxEngine
    from interspeech_ser_tpu.utils.config import load_fusion_config as jax_load

    cfg = load_fusion_config(path)
    port = FusionEngine(cfg, device="cpu", options=EngineOptions(**opts))
    jeng = JaxEngine(jax_load(path), options=JaxOptions(**opts))
    jeng.params = unflatten(convert.port_to_flax_flat(port.model.state_dict(), port.renames))
    return jeng, port, cfg


def train_batch(path, port, rows=range(7), batch_size=8, gender_csv=None):
    """A collated train batch (the task's label columns, gender targets when
    ``gender_csv``) and the train class weights."""
    cfg = load_fusion_config(path)
    train_rows = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Train")
    aux = None
    if gender_csv is not None:
        train_rows = L.merge_gender(train_rows, gender_csv)
        aux = np.asarray([int(r["target_gender"]) for r in train_rows], np.int64)
    cols = port.dim_columns if port.opt.task == "dim" else L.CLASSES
    ds = tdata.LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows, cols), cfg.lazy_dirs,
                                  cfg.feat_dims, aux_labels=aux)
    class_w = None if port.opt.task == "dim" else L.class_weights(train_rows)
    return ds.collate(list(rows), batch_size), class_w


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy_engine")
    write_legacy_corpus(root)
    return root


def _port_step(port, batch, class_w, eval_mode: bool = False):
    """One forward + backward -> (loss, logged value); ``eval_mode`` keeps the
    model in eval mode with autograd on (the single model's fixed dropout)."""
    cw = None if class_w is None else torch.from_numpy(class_w)
    if not eval_mode:
        return port.accumulate_gradients(batch, cw)
    port.model.eval()
    feats, masks, labels, smask, aux = port._to_device(batch)
    backward, ce = port._loss_terms(port._forward(feats, masks), labels, smask, cw, aux)
    backward.backward()
    return backward.detach(), ce.detach()


def check_step_against_jax(corpus, name: str, opts: dict, over: dict) -> None:
    """One train step (7 rows and a padding row) of the port and of the JAX
    ``_loss_terms`` from the same weights: the loss, the logged value and every
    gradient within 2e-5; then the eval forward's logits within 1e-5."""
    path = config(corpus, f"step_{name}", dropout=0.0, **over)
    jeng, port, cfg = carried_pair(path, **opts)
    gender_csv = str(corpus / "gender.csv") if opts.get("gender_mode") else None
    batch, class_w = train_batch(path, port, gender_csv=gender_csv)
    assert batch.sample_mask[-1] == 0.0

    jbatch = ([jnp.asarray(f) for f in batch.feats], [jnp.asarray(m) for m in batch.masks],
              jnp.asarray(batch.labels), jnp.asarray(batch.sample_mask),
              None if batch.aux is None else jnp.asarray(batch.aux))
    jcw = None if class_w is None else jnp.asarray(class_w)
    (want, (want_ce, want_logits)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jeng._loss_terms(p, jbatch, jax.random.PRNGKey(0), jcw, True), has_aux=True
    ))(jeng.params)
    loss, ce = _port_step(port, batch, class_w, eval_mode=opts.get("model_variant") == "single")
    np.testing.assert_allclose(loss.item(), float(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ce.item(), float(want_ce), atol=2e-5, rtol=0)
    want_grads = port_params(jgrads, port.opt, len(cfg.feat_dims))
    got = dict(port.model.named_parameters())
    assert set(got) == set(want_grads)
    for pname, g in want_grads.items():
        grad = got[pname].grad  # None where the loss does not reach (the SVM trainer's emotion head)
        grad = torch.zeros_like(got[pname]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), atol=2e-5, rtol=0, err_msg=pname)
    port.model.eval()
    with torch.no_grad():
        feats, masks, *_ = port._to_device(batch)
        logits = port._forward(feats, masks)["logits"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-5, rtol=0)


# name -> (EngineOptions fields, config overrides); the variants' cases are in
# test_torch_fusion_variants.py
STEP_CASES = {
    "ce_cka_inv": ({"cka_weight": -0.1}, {}),  # a negative weight adds nothing, as in the JAX engine
    "focal_gamma3_unmasked": ({"loss_type": "focal", "focal_gamma": 3.0, "masked": False}, {}),
    "labelsmooth_heads4_cka": ({"loss_type": "labelsmooth", "attention_heads": 4, "cka_weight": 0.1}, {}),
    "hierarchical_nowce": ({"loss_type": "hierarchical", "unweighted_ce": True}, {}),
    "f1_wce": ({"loss_type": "f1", "add_ce_to_f1": True}, {}),
    "fiona": ({"gated_pool": True, "attention_heads": 8, "cka_weight": 1.0, "focal_dynamic_alpha": True},
              {"use_focalloss": True}),
    "dim_cka": ({"task": "dim", "cka_weight": 0.1}, {}),
    "dim_mse_valence": ({"task": "dim", "mse_weight": 10.0, "dim_columns": ("EmoVal",)}, {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_train_step_matches_jax(corpus, case):
    check_step_against_jax(corpus, case, *STEP_CASES[case])


PADDING_CASES = {
    "labelsmooth_heads4": {"loss_type": "labelsmooth", "attention_heads": 4},
    "hierarchical": {"loss_type": "hierarchical"},
    "gated_heads8_focal3": {"gated_pool": True, "attention_heads": 8, "loss_type": "focal", "focal_gamma": 3.0},
    "moe": {"model_variant": "moe"},
    "dim_mse": {"task": "dim", "mse_weight": 10.0},
    "grl": {"gender_mode": "grl"},
    "aux": {"gender_mode": "aux"},
    "svm": {"gender_mode": "svm", "attention_heads": 8, "modality_norm": False},
}


@pytest.mark.parametrize("case", sorted(PADDING_CASES))
def test_padding_rows_leave_the_step_unchanged(corpus, case):
    """3 real rows, then the same 3 with two all-padding rows: equal loss and
    gradients (the single model pools over padded frames by design, and
    ``masked=False`` / CKA / diff-F1 read the padding: not cases here)."""
    opts = PADDING_CASES[case]
    path = config(corpus, f"pad_{case}", dropout=0.0)
    gender_csv = str(corpus / "gender.csv") if opts.get("gender_mode") else None
    results = []
    for batch_size in (3, 5):
        port = FusionEngine(load_fusion_config(path), device="cpu", options=EngineOptions(**opts))
        batch, class_w = train_batch(path, port, rows=[0, 1, 2], batch_size=batch_size, gender_csv=gender_csv)
        loss, _ = _port_step(port, batch, class_w)
        results.append((loss, {n: p.grad for n, p in port.model.named_parameters()}))
    torch.testing.assert_close(results[1][0], results[0][0], atol=1e-6, rtol=1e-5)
    for name, g in results[1][1].items():
        if g is None:  # the SVM trainer's emotion head (its CE is the gender head's)
            assert results[0][1][name] is None, name
        else:
            torch.testing.assert_close(g, results[0][1][name], atol=1e-6, rtol=1e-5, msg=name)


@pytest.mark.parametrize("opts", [{"cka_weight": 1.0}, {"loss_type": "f1"}], ids=["cka", "f1"])
def test_cka_and_diff_f1_read_the_padding_rows_as_jax_does(corpus, opts):
    """CKA (on the pooled pair) and diff-F1 take the whole padded batch in the
    JAX engine: the port's loss on 3 rows padded to 5 equals JAX's on the same
    batch and differs from its loss on the 3 rows alone."""
    path = config(corpus, f"quirk_{'_'.join(opts)}", dropout=0.0)
    jeng, port, _ = carried_pair(path, **opts)
    losses = {}
    for batch_size in (3, 5):
        port.model.zero_grad(set_to_none=True)
        batch, class_w = train_batch(path, port, rows=[0, 1, 2], batch_size=batch_size)
        losses[batch_size], _ = _port_step(port, batch, class_w)
    jbatch = ([jnp.asarray(f) for f in batch.feats], [jnp.asarray(m) for m in batch.masks],
              jnp.asarray(batch.labels), jnp.asarray(batch.sample_mask), None)
    want = jax.jit(lambda p: jeng._loss_terms(p, jbatch, jax.random.PRNGKey(0), jnp.asarray(class_w), True)[0])(
        jeng.params)
    np.testing.assert_allclose(losses[5].item(), float(want), atol=2e-5, rtol=0)
    assert abs(losses[5].item() - losses[3].item()) > 1e-3, losses  # 50x the JAX bar above


def test_options_refuse_what_the_port_cannot_run(corpus):
    with pytest.raises(ValueError, match="loss_type"):
        EngineOptions(loss_type="angular")
    with pytest.raises(ValueError, match="model_variant"):
        EngineOptions(model_variant="xvector")
    cfg = load_fusion_config(config(corpus, "refuse"))
    # n_devices counts the ranks of a process group: 4 in a one-process run raises
    with pytest.raises(ValueError, match="n_devices=4, but this run has 1 rank"):
        FusionEngine(cfg, device="cpu", options=EngineOptions(n_devices=4))
    with pytest.raises(ValueError, match="inside options"):
        FusionEngine(cfg, device="cpu", ranking=True, options=EngineOptions())
    rows = L.load_merged(cfg.label_path, cfg.txt_dir)
    engine = FusionEngine(cfg, device="cpu", options=EngineOptions(gender_mode="grl"))
    with pytest.raises(ValueError, match="target_gender"):
        engine.fit(L.split(rows, "Train"), L.split(rows, "Development"))


def test_gender_merge_matches_pandas(corpus):
    """The left merge of ``interspeech_ser_tpu/cli.py``: Female 0, Male 1, missing or other 0."""
    import pandas as pd

    rows = L.merge_gender(L.load_merged(str(corpus / "labels.csv")), str(corpus / "gender.csv"))
    df = pd.read_csv(corpus / "labels.csv").merge(pd.read_csv(corpus / "gender.csv")[["FileName", "Gender"]],
                                                  on="FileName", how="left")
    want = df["Gender"].map({"Female": 0, "Male": 1}).fillna(0).astype(int).tolist()
    assert [int(r["target_gender"]) for r in rows] == want
    assert L.column(rows, "FileName") == df["FileName"].tolist()
    assert 0 in want and 1 in want
