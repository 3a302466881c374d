"""The timbre perturbation in the port's baseline and joint trainers, and the
legacy baselinelike trainers (``baseline.cli.legacy_train_main``: ``base``,
``focalloss``, ``xvector``), against the JAX package.

The corpora and engine helpers are ``tests/test_torch_baseline.py``'s and
``tests/test_torch_joint_engine.py``'s; dropout is off on both sides and the
port starts from the JAX engine's weights. With ``use_timbre_perturb`` both
engines draw one seed from their generator for the perturbation (at the same
point of the draw sequence) and the later draws (the epoch order) stay
equal: the test records every draw. Bars: the perturbed batches within 1e-6,
the dev losses within 1e-5, the rows equal.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from interspeech_ser_tpu.baseline import cli as jcli
from interspeech_ser_tpu.baseline import data as jdata
from interspeech_ser_tpu.baseline.engine import BaselineEngine as JaxEngine
from interspeech_ser_tpu.baseline.xvector_engine import XVectorEngine as JaxXVectorEngine
from interspeech_ser_tpu_torch.baseline import cli
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.baseline import engine as pengine
from interspeech_ser_tpu_torch.baseline import xvector_engine as pxe
from interspeech_ser_tpu_torch.models.convert import emotion_regression_params_from_flax, xvector_params_from_flax
from test_torch_baseline import carry as carry_baseline
from test_torch_baseline import write_corpus
from test_torch_joint_engine import engines as joint_engines
from test_torch_joint_engine import write_joint_corpus
from test_torch_xvector import write_xvector_corpus

torch.set_num_threads(2)


class DrawLog:
    """A numpy Generator that records each draw (method, result)."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def draw(*args, **kw):
            out = fn(*args, **kw)
            self.draws.append((name, np.asarray(out).tolist()))
            return out
        return draw


def record_batches(monkeypatch, field="collate_wav"):
    """Both packages' ``field`` wrapped: -> {"jax": [...], "port": [...]} of
    (the dataset's size, the rows, the batch's wav)."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jdata), ("port", bdata)):
        real = getattr(mod, field)

        def wrapped(*args, _r=real, _n=name):
            out = _r(*args)
            wav = out.wav if hasattr(out, "wav") else out[0].wav
            seen[_n].append((len(args[0]), [int(i) for i in args[-2]], np.asarray(wav).copy()))
            return out
        monkeypatch.setattr(mod, field, wrapped)
    return seen


def same_batches(seen):
    assert len(seen["jax"]) == len(seen["port"]) > 0
    for (jn, jr, jw), (pn, pr, pw) in zip(seen["jax"], seen["port"]):
        assert (jn, jr) == (pn, pr)
        np.testing.assert_allclose(pw, jw, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("legacy_baseline"))


@pytest.mark.parametrize("loss_mode", ["wce", "ce_focal3"])
def test_baseline_fit_with_timbre_perturbation_matches_jax(corpus, tmp_path, monkeypatch, loss_mode):
    """One epoch at batch 4 in micro-batches of 2 with ``tp_prob`` 0.8: the
    same draws from the engines' generators, the same train batches (rows
    perturbed against the same rows without), the dev loss within 1e-5."""
    seen = record_batches(monkeypatch)
    je = JaxEngine(str(corpus / "hf"), head_dim=16, seed=100, n_devices=1, dropout=0.0, loss_mode=loss_mode)
    pe = pengine.BaselineEngine(str(corpus / "hf"), head_dim=16, seed=100, dropout=0.0, loss_mode=loss_mode,
                                device="cpu")
    carry_baseline(je, pe)
    je.rng, pe.rng = DrawLog(je.rng), DrawLog(pe.rng)
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "wavs"), batch_size=4,
              accumulation_steps=2, epochs=1, lr=1e-3, use_timbre_perturb=True, tp_prob=0.8)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **kw)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **kw)
    assert pe.rng.draws == je.rng.draws and pe.rng.draws[0][0] == "integers"
    same_batches(seen)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5

    # against the same rows unperturbed: some train rows changed
    plain = pengine.labelled_split("cat", str(corpus / "labels.csv"), str(corpus / "wavs"), "train")
    train = [(rows, w) for n, rows, w in seen["port"] if n == len(plain)]
    changed = [not np.allclose(w[i], bdata.collate_wav(plain, rows, w.shape[0]).wav[i], atol=1e-4)
               for rows, w in train for i in range(len(rows))]
    assert sum(changed) > 0


def test_joint_fit_with_timbre_perturbation_matches_jax(tmp_path_factory, tmp_path, monkeypatch):
    """``JointEngine.fit`` (variant ``large``) for one epoch with ``tp_prob`` 0.8:
    the same draws, the same perturbed wavs, the dev loss within 1e-5."""
    corpus = write_joint_corpus(tmp_path_factory.mktemp("joint_timbre"))
    seen = record_batches(monkeypatch, "collate_txt_wav")
    je, pe = joint_engines(corpus, "large")
    real = je._apply
    je._apply = lambda p, w, wm, ti, tm, det, dkey=None: real(p, w, wm, ti, tm, True)
    pe.generator = None
    je.rng, pe.rng = DrawLog(je.rng), DrawLog(pe.rng)
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "audio"),
              txt_path=str(corpus / "transcripts.csv"), batch_size=4, accumulation_steps=2, epochs=1, lr=1e-3,
              use_timbre_perturb=True, tp_prob=0.8)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **kw)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **kw)
    assert pe.rng.draws == je.rng.draws and pe.rng.draws[0][0] == "integers"
    same_batches(seen)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5


def legacy_config(corpus, tmp_path, side, **extra):
    wavs = corpus / ("audio" if (corpus / "audio").exists() else "wavs")
    cfg = {"wav_dir": str(wavs), "label_path": str(corpus / "labels.csv"), "ssl_type": str(corpus / "hf"),
           "batch_size": 4, "accum_step": 2, "epochs": 1, "lr": 1e-4, "model_path": str(tmp_path / side),
           "head_dim": 16, "pooling_type": "AttentiveStatisticsPooling", "weight_decay": 1e-2, "dropout_head": 0.0,
           "use_timbre_perturb": False, "tp_prob": 0.0, **extra}
    path = tmp_path / f"{side}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("variant,extra", [
    ("base", {}),
    ("focalloss", {"use_timbre_perturb": True, "tp_prob": 0.8, "use_balanced_batch": True}),
    ("xvector", {"use_balanced_batch": True}),
])
def test_legacy_train_main_matches_jax(corpus, tmp_path, monkeypatch, variant, extra):
    """Each variant through both packages' ``legacy_train_main`` (the port
    starting from the JAX engine's weights, the head's dropout 0): the dev
    loss within 1e-5, the best epoch equal, the same files with the same
    keys (``final_{ser,pool,ssl}.pt``, or ``final_{ser,xvector}.pt``, and
    ``train_norm_stat.pkl``)."""
    captured = {}
    if variant == "xvector":  # whole-second wavs (tests/test_torch_xvector.py says why)
        corpus = write_xvector_corpus(tmp_path)
        real_j, real_p = JaxXVectorEngine.fit, pxe.XVectorEngine.fit

        def jfit(self, **kw):
            from interspeech_ser_tpu.baseline import models as jbmodels

            self.head = jbmodels.EmotionRegression(512, self.head_dim, 1, 8, dropout=0.0)
            captured.update(xv=jax.tree.map(np.asarray, self.xv_params), stats=jax.tree.map(np.asarray, self.xv_stats),
                            head=jax.tree.map(np.asarray, self.head_params))  # before training moves them
            return real_j(self, **kw)

        def pfit(self, **kw):
            self.xvector.load_state_dict(xvector_params_from_flax(captured["xv"], captured["stats"]))
            self.head.load_state_dict(emotion_regression_params_from_flax(captured["head"]))
            self.generator = None
            return real_p(self, **kw)

        monkeypatch.setattr(JaxXVectorEngine, "fit", lambda self, **kw: jfit(self, **kw))
        monkeypatch.setattr(pxe.XVectorEngine, "fit", pfit)
    else:
        real_j, real_p = JaxEngine.fit, pengine.BaselineEngine.fit

        def jfit(self, **kw):
            captured["je"] = SimpleNamespace(params=jax.tree.map(np.asarray, self.params), ssl_cfg=self.ssl_cfg)
            return real_j(self, **kw)

        def pfit(self, **kw):
            carry_baseline(captured["je"], self)
            return real_p(self, **kw)

        monkeypatch.setattr(JaxEngine, "fit", jfit)
        monkeypatch.setattr(pengine.BaselineEngine, "fit", pfit)
        real_init = JaxEngine.__init__
        monkeypatch.setattr(JaxEngine, "__init__", lambda self, *a, **kw: real_init(self, *a, n_devices=1, **kw))
    jbest = jcli.legacy_train_main(variant, ["--config_path", legacy_config(corpus, tmp_path, "jax", **extra)])
    pbest = cli.main([next(s for s, v in cli.LEGACY_STEMS.items() if v == variant), "--config_path",
                      legacy_config(corpus, tmp_path, "port", **extra), "--device", "cpu"])
    assert pbest["epoch"] == jbest["epoch"] and abs(pbest["loss"] - jbest["loss"]) <= 1e-5
    files = ["final_ser.pt", "train_norm_stat.pkl"] + (["final_xvector.pt"] if variant == "xvector"
                                                        else ["final_pool.pt", "final_ssl.pt"])
    for name in files:
        assert (tmp_path / "jax" / name).exists() and (tmp_path / "port" / name).exists(), name
        if name.endswith(".pt"):
            assert set(torch.load(tmp_path / "jax" / name, weights_only=True)) == \
                set(torch.load(tmp_path / "port" / name, weights_only=True)), name


def test_legacy_stems_and_the_card_default(corpus, tmp_path):
    """``baseline.cli`` reaches ``legacy_train_main`` from the three
    ``bin/old/train_cat_baselinelike*`` stems; without a card the default
    device raises; an unknown variant raises."""
    assert cli.LEGACY_STEMS == {"train_cat_baselinelike": "base", "train_cat_baselinelike_focalloss": "focalloss",
                                "train_cat_baselinelike_xvector": "xvector"}
    if not torch.cuda.is_available():
        for stem in cli.LEGACY_STEMS:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                cli.main([stem, "--config_path", legacy_config(corpus, tmp_path, "m")])
    with pytest.raises(ValueError, match="variant"):
        cli.legacy_train_main("nothing", ["--config_path", legacy_config(corpus, tmp_path, "m")])
