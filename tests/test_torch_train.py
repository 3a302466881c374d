"""The port's fusion training path against the JAX package's, on the CPU.

A small synthetic fixture in the reference's file contract (label and
transcript CSVs, per-utterance ``.pt`` dirs for three modalities, config
JSONs; feature dims 24/16/12, H=16), separable so a short fit beats chance.

- one train step from carried flax params, ``dropout: 0.0``, one batch with
  a padding row: loss and every gradient against ``jax.value_and_grad`` of
  the JAX ``_loss_terms`` (ce, focal, focal with dynamic alpha, ranking),
  atol 1e-5 on the loss and 2e-5 on gradients (f32, other summation order);
- AdamW: 3 steps against the JAX package's optax recipe, params atol 1e-6;
- batches: ``epoch_batches`` and the label weights equal the JAX ones;
- the same fit from the same initial params and seed as the JAX trainer:
  equal per-epoch dev macro-F1, final parameters within atol 1e-5 (those
  with a gradient of 0 in exact arithmetic within the Adam step budget);
- end to end through the port's CLI with ``--device cpu``, resume, mean
  gradient accumulation, padding rows, and the card default without a card.
"""

import csv
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu_torch import cli
from interspeech_ser_tpu_torch.models.convert import fusion_params_from_flax
from interspeech_ser_tpu_torch.train import data as tdata
from interspeech_ser_tpu_torch.train.engine import FusionEngine, cosine_epoch_lr
from interspeech_ser_tpu_torch.utils import labels as L
from interspeech_ser_tpu_torch.utils.config import load_fusion_config
from interspeech_ser_tpu_torch.utils.seeding import numpy_generator

torch.set_num_threads(2)

DIMS = (24, 16, 12)
N_TRAIN, N_DEV, N_TEST = 48, 24, 8
HID = 16
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("sertrain")
    rng = np.random.default_rng(7)
    dirs = [root / f"lazy{m + 1}" for m in range(3)]
    for d in dirs:
        d.mkdir()
    means = rng.normal(scale=2.0, size=(8, DIMS[0]))
    rows = []
    for i in range(N_TRAIN + N_DEV + N_TEST):
        cls = i % 8
        name = f"MSP-PODCAST_{i:04d}.wav"
        lengths = (int(rng.integers(20, 90)), int(rng.integers(5, 30)), int(rng.integers(10, 40)))
        for m, (d, t) in enumerate(zip(dirs, lengths)):
            f = rng.normal(size=(t, DIMS[m])).astype(np.float32) + (means[cls] if m == 0 else 0.0)
            torch.save(torch.from_numpy(f), str(d / name.replace(".wav", ".pt")))
        split = "Train" if i < N_TRAIN else "Development" if i < N_TRAIN + N_DEV else "Test3"
        rows.append([name] + [float(c == cls) for c in range(8)] + [split])
    header = ["FileName"] + L.CLASSES + ["Split_Set"]
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([header] + rows)
    with open(root / "train_stacking_sample.csv", "w", newline="") as f:
        csv.writer(f).writerows([header] + rows[:16])
    with open(root / "transcripts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[r[0], "hi"] for r in rows])
    with open(root / "test.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName"]] + [[r[0]] for r in rows if r[-1] == "Test3"])
    base = {
        "wav_dir": str(root), "txt_dir": str(root / "transcripts.csv"),
        "lazy_dir1": str(dirs[0]), "lazy_dir2": str(dirs[1]), "label_path": str(root / "labels.csv"),
        "feat1_dim": DIMS[0], "feat2_dim": DIMS[1], "use_balanced_batch": False, "use_focalloss": False,
        "epochs": 3, "lr": 5e-3, "model_path": str(root / "exp"), "batch_size": 16, "accum_step": 1,
        "fusion_hidden_dim": HID,
    }
    with open(root / "base.json", "w") as f:
        json.dump(base, f)
    return root


def _config(root, name, **over) -> str:
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


def _rows(path):
    cfg = load_fusion_config(path)
    rows = L.load_merged(cfg.label_path, cfg.txt_dir)
    return cfg, L.split(rows, "Train"), L.split(rows, "Development")


def _jax_engine(path, seed=7, ranking=False, dynamic_alpha=False):
    from interspeech_ser_tpu.train.engine import EngineOptions
    from interspeech_ser_tpu.train.engine import FusionEngine as JaxEngine
    from interspeech_ser_tpu.utils.config import load_fusion_config as jax_load

    engine = JaxEngine(jax_load(path), seed=seed,
                       options=EngineOptions(ranking=ranking, focal_dynamic_alpha=dynamic_alpha))
    engine.init_params()
    return engine


def _carry(jax_engine, port: FusionEngine) -> None:
    sd = fusion_params_from_flax(jax.tree.map(np.asarray, jax_engine.params), len(port.cfg.feat_dims))
    port.model.load_state_dict(sd, strict=True)


# -- one step ------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["ce", "focal", "focal_dynamic_alpha", "ranking"])
def test_one_train_step_matches_jax(fixture_dir, variant):
    path = _config(fixture_dir, f"step_{variant}", dropout=0.0, use_focalloss=variant.startswith("focal"))
    cfg, train_rows, _ = _rows(path)
    ranking, dyn = variant == "ranking", variant == "focal_dynamic_alpha"
    jeng = _jax_engine(path, ranking=ranking, dynamic_alpha=dyn)
    port = FusionEngine(cfg, device="cpu", ranking=ranking, focal_dynamic_alpha=dyn)
    _carry(jeng, port)
    ds = tdata.LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    batch = ds.collate(list(range(7)), 8)  # one padding row
    class_w = L.class_weights(train_rows)

    jbatch = ([jnp.asarray(f) for f in batch.feats], [jnp.asarray(m) for m in batch.masks],
              jnp.asarray(batch.labels), jnp.asarray(batch.sample_mask), None)
    (want, (want_ce, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jeng._loss_terms(p, jbatch, jax.random.PRNGKey(0), jnp.asarray(class_w), True), has_aux=True
    ))(jeng.params)
    loss, ce = port.accumulate_gradients(batch, torch.from_numpy(class_w))
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ce.item(), float(want_ce), atol=1e-5, rtol=0)
    want_grads = fusion_params_from_flax(jax.tree.map(np.asarray, jgrads), 2)
    got = dict(port.model.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), atol=2e-5, rtol=0, err_msg=name)


def test_padding_rows_give_finite_gradients_equal_to_unpadded(fixture_dir):
    path = _config(fixture_dir, "padding", dropout=0.0)
    cfg, train_rows, _ = _rows(path)
    ds = tdata.LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    grads = []
    for batch_size in (3, 5):  # 3 real rows; two all-padding rows (sample_mask 0, all-zero masks)
        eng = FusionEngine(cfg, device="cpu")
        batch = ds.collate([0, 1, 2], batch_size)
        assert batch.sample_mask.tolist() == [1.0] * 3 + [0.0] * (batch_size - 3)
        loss, _ = eng.accumulate_gradients(batch, torch.from_numpy(L.class_weights(train_rows)))
        assert torch.isfinite(loss)
        grads.append({n: p.grad.clone() for n, p in eng.model.named_parameters()})
    for name, g in grads[1].items():
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, grads[0][name], atol=1e-6, rtol=1e-5, msg=name)


# -- optimizer and data --------------------------------------------------------


def test_adamw_matches_optax(fixture_dir):
    import optax
    from interspeech_ser_tpu.train.engine import FusionEngine as JaxEngine

    path = _config(fixture_dir, "adamw", lr=3e-3)
    cfg = load_fusion_config(path)
    jeng = _jax_engine(path)
    port = FusionEngine(cfg, device="cpu")
    _carry(jeng, port)
    tx = JaxEngine.make_tx(types.SimpleNamespace(cfg=jeng.cfg))
    params, state = jeng.params, tx.init(jeng.params)
    port.optimizer = port.make_optimizer()
    rng = np.random.default_rng(5)
    named = dict(port.model.named_parameters())
    for step in range(3):
        lr = cosine_epoch_lr(cfg.lr, step, 3)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        state.hyperparams["learning_rate"] = lr
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, g in fusion_params_from_flax(grads, 2).items():
            named[name].grad = g
        port.apply_gradients(lr)
    for name, want in fusion_params_from_flax(jax.tree.map(np.asarray, params), 2).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("sampler", ["shuffle", "balanced", "neutral"])
@pytest.mark.parametrize("bucket_window", [1, 2, 8])
def test_epoch_batches_match_jax(fixture_dir, sampler, bucket_window):
    import pandas as pd
    from interspeech_ser_tpu.train import data as jdata
    from interspeech_ser_tpu.utils import labels as JL
    from interspeech_ser_tpu.utils.seeding import numpy_generator as jax_numpy_generator

    path = _config(fixture_dir, "batches")
    cfg, train_rows, _ = _rows(path)
    df = JL.split(JL.load_merged(cfg.label_path, cfg.txt_dir), "Train")
    weights = {"shuffle": (None, None),
               "balanced": (L.balanced_sample_weights(train_rows), JL.balanced_sample_weights(df)),
               "neutral": (L.neutral_balanced_sample_weights(train_rows), JL.neutral_balanced_sample_weights(df))}
    ours_w, jax_w = weights[sampler]
    if ours_w is not None:
        np.testing.assert_array_equal(ours_w, jax_w)
    assert isinstance(df, pd.DataFrame)
    ours_ds = tdata.LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    jax_ds = jdata.LazyFeatureDataset(df["FileName"].tolist(), df[JL.CLASSES].values, cfg.lazy_dirs, cfg.feat_dims)
    ours_rng, jax_rng = numpy_generator(11), jax_numpy_generator(11)
    for _ in range(2):  # two epochs from one generator
        ours = tdata.epoch_batches(ours_ds, 10, ours_rng, sample_weights=ours_w, bucket_window=bucket_window)
        want = jdata.epoch_batches(jax_ds, 10, jax_rng, sample_weights=jax_w, bucket_window=bucket_window)
        assert [[int(i) for i in b] for b in ours] == [[int(i) for i in b] for b in want]


def test_class_weights_match_jax(fixture_dir):
    from interspeech_ser_tpu.utils import labels as JL

    path = _config(fixture_dir, "weights")
    cfg, train_rows, _ = _rows(path)
    rows = train_rows[:-5]  # uneven class counts
    df = JL.split(JL.load_merged(cfg.label_path, cfg.txt_dir), "Train").iloc[:-5]
    np.testing.assert_array_equal(L.class_weights(rows), JL.class_weights(df))
    np.testing.assert_array_equal(L.balanced_sample_weights(rows), JL.balanced_sample_weights(df))


# -- whole fits ----------------------------------------------------------------


def _record_evaluations(engine):
    seen = []
    evaluate = engine.evaluate

    def wrapped(*a, **kw):
        res = evaluate(*a, **kw)
        seen.append(res["macro_f1"])
        return res

    engine.evaluate = wrapped
    return seen


def test_fit_matches_jax_trainer(fixture_dir):
    """Same initial params, seed, batches and (no) dropout as the JAX fit."""
    from interspeech_ser_tpu.utils import labels as JL

    path = _config(fixture_dir, "fit_parity", dropout=0.0, epochs=2, lr=2e-3)
    cfg, train_rows, val_rows = _rows(path)
    jeng = _jax_engine(path)
    port = FusionEngine(cfg, device="cpu")
    _carry(jeng, port)
    df = JL.load_merged(cfg.label_path, cfg.txt_dir)
    jax_f1, port_f1 = _record_evaluations(jeng), _record_evaluations(port)
    jax_best = jeng.fit(JL.split(df, "Train"), JL.split(df, "Development"))
    port_best = port.fit(train_rows, val_rows)
    assert len(port_f1) == 2 and port_f1 == jax_f1
    assert port_best["epoch"] == jax_best["epoch"]
    final = fusion_params_from_flax(jax.tree.map(np.asarray, jeng.params), 2)
    # Parameters whose gradient is 0 in exact arithmetic get float noise of
    # either sign, which Adam turns into steps of up to ~lr: the pooling
    # scorers' biases (a shift of every score of a softmax over time) and the
    # key third of in_proj_bias (a shift of every score of a query). Their bar
    # is the sum of the learning rates of all steps; every other parameter's
    # is atol 1e-5.
    steps = -(-N_TRAIN // cfg.batch_size)
    adam_budget = steps * sum(cosine_epoch_lr(cfg.lr, e, cfg.epochs) for e in range(cfg.epochs))
    E = 2 * HID
    for name, p in port.model.state_dict().items():
        got, want = p.numpy(), final[name].numpy()
        if name.endswith("_attn.bias"):
            np.testing.assert_allclose(got, want, atol=adam_budget, rtol=0, err_msg=name)
            continue
        if name.endswith("in_proj_bias"):
            np.testing.assert_allclose(got[E : 2 * E], want[E : 2 * E], atol=adam_budget, rtol=0, err_msg=name)
            got, want = np.delete(got, np.s_[E : 2 * E]), np.delete(want, np.s_[E : 2 * E])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_train_eval_test_extract_through_cli(fixture_dir):
    path = _config(fixture_dir, "e2e")
    best = cli.train_main(["--config_path", path, "--seed", "7", *CPU])
    assert best["macro_f1"] > 0.5, "separable synthetic task must beat chance"
    cfg = load_fusion_config(path)
    sd = torch.load(os.path.join(cfg.model_path, "multimodal_ser.pt"), weights_only=True)
    assert sd["speech_projection.weight"].shape == (HID, DIMS[0])
    assert "speech_gru.weight_ih_l0" in sd and "text_attention.in_proj_weight" in sd
    assert all(t.device.type == "cpu" for t in sd.values())
    dev = _read(cli.eval_main(["--config_path", path, *CPU]))
    assert dev[0][:2] == ["Filename", "Prediction"] and len(dev) == 1 + N_DEV
    assert all(len(v.split(".")[1]) == 4 for v in dev[1][2:])
    test = _read(cli.test_main(["--config_path", path, "--test_df", str(fixture_dir / "test.csv"), *CPU]))
    assert test[0][:2] == ["FileName", "Prediction"] and len(test) == 1 + N_TEST
    train = _read(cli.extract_train_main(
        ["--config_path", path, "--train_df", str(fixture_dir / "train_stacking_sample.csv"), *CPU]))
    assert train[0][:2] == ["Filename", "Prediction"] and len(train) == 1 + 16
    assert {r[1] for r in dev[1:] + test[1:] + train[1:]} <= set(L.CLASS_LETTERS)


@pytest.mark.parametrize("ranking", [False, True])
@pytest.mark.parametrize("trimodal", [False, True])
def test_four_trainers_run(fixture_dir, ranking, trimodal):
    """The four bin/train_cat_* trainers (focal loss on, as the trimodal
    configs have it), then eval and test with the same flags."""
    name = f"trainer_r{int(ranking)}_t{int(trimodal)}"
    path = _config(fixture_dir, name, epochs=1, use_focalloss=True, trimodal=trimodal)
    flags = ["--config_path", path, *CPU] + ["--ranking"] * ranking + ["--trimodal"] * trimodal
    cli.train_main(flags)
    cfg = load_fusion_config(path)
    sd = torch.load(os.path.join(cfg.model_path, "multimodal_ser.pt"), weights_only=True)
    assert ("neutral_classifier.3.weight" in sd) == ranking
    assert ("prosody_gru.weight_hh_l0" in sd) == trimodal
    assert len(_read(cli.eval_main(flags))) == 1 + N_DEV
    assert len(_read(cli.test_main(flags + ["--test_df", str(fixture_dir / "test.csv")]))) == 1 + N_TEST


def test_trimodal_flag_requires_lazy_dir3(fixture_dir):
    with pytest.raises(KeyError, match="lazy_dir3"):
        load_fusion_config(_config(fixture_dir, "bimodal_only"), trimodal=True)


def test_resume_equals_uninterrupted_run(fixture_dir):
    """Dropout on (0.5), so the generator's saved state matters."""
    results = {}
    for name in ("straight", "resumed"):
        path = _config(fixture_dir, f"resume_{name}", epochs=3)
        cfg, train_rows, val_rows = _rows(path)
        if name == "straight":
            FusionEngine(cfg, seed=3, device="cpu").fit(train_rows, val_rows)
        else:
            FusionEngine(cfg, seed=3, device="cpu").fit(train_rows, val_rows, stop_after_epoch=0)
            FusionEngine(cfg, seed=3, device="cpu").fit(train_rows, val_rows, resume=True)
        results[name] = (
            torch.load(os.path.join(cfg.model_path, "train_state.pt"), weights_only=True),
            torch.load(os.path.join(cfg.model_path, "multimodal_ser.pt"), weights_only=True),
        )
    (a_state, a_best), (b_state, b_best) = results["straight"], results["resumed"]
    assert a_state["epoch"] == b_state["epoch"] == 2 and a_state["best"] == b_state["best"]
    for k in a_state["model"]:
        assert torch.equal(a_state["model"][k], b_state["model"][k]), k
    for k in a_best:
        assert torch.equal(a_best[k], b_best[k]), k


def test_accumulation_steps_on_the_mean_gradient(fixture_dir):
    """fit with accum_step=2 against a hand loop over the same batches that
    averages each pair's gradients (the odd last batch alone)."""
    path = _config(fixture_dir, "accum", dropout=0.0, epochs=1, accum_step=2, batch_size=10)
    cfg, train_rows, val_rows = _rows(path)
    fitted = FusionEngine(cfg, seed=4, device="cpu")
    fitted.fit(train_rows, val_rows)

    manual = FusionEngine(cfg, seed=4, device="cpu")
    manual.optimizer = manual.make_optimizer()
    ds = tdata.LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    batches = tdata.epoch_batches(ds, cfg.batch_size, numpy_generator(4))
    assert len(batches) == 5
    class_w = torch.from_numpy(L.class_weights(train_rows))
    params = list(manual.model.parameters())
    for group in (batches[0:2], batches[2:4], batches[4:]):
        per_batch = []
        for idxs in group:
            manual.accumulate_gradients(ds.collate(idxs, cfg.batch_size), class_w)
            per_batch.append([p.grad.clone() for p in params])
            manual.optimizer.zero_grad(set_to_none=True)
        for p, *gs in zip(params, *per_batch):
            p.grad = sum(gs) / len(gs)
        manual.apply_gradients(cosine_epoch_lr(cfg.lr, 0, cfg.epochs))
    for (name, a), b in zip(fitted.model.state_dict().items(), manual.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)


# -- the card by default -------------------------------------------------------


def test_entry_points_default_to_the_card(fixture_dir, monkeypatch):
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _config(fixture_dir, "default_device")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FusionEngine(load_fusion_config(path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.train_main(["--config_path", path])
    scfg = SpeechConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                        conv_dim=(16,), conv_kernel=(10,), conv_stride=(5,), feat_extract_norm="layer",
                        do_stable_layer_norm=True, num_conv_pos_embeddings=16, conv_pos_groups=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SpeechExtractionPipeline(SpeechEncoderModel(scfg), scfg)
    assert FusionEngine(load_fusion_config(path), device="cpu").device.type == "cpu"
