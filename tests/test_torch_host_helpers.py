"""The port's last host helpers against the JAX package's: ``lora_evaluation``
(``EvalMetric`` and the fairness metrics), ``utils.labels``
(``process_labels_for_categorical``, its ``python -m`` entry,
``labels_to_index``, ``neutral_margin_targets``), the ``baseline.podcast``
attribute and speaker loaders, ``utils.metrics`` (``micro_f1``, ``calc_err``,
``calc_acc``, ``ccc``) and ``ops.gru.gru_scan_bidir_stacked``.

Host numpy: results equal (the CSV byte for byte), floats within 1e-12;
the f32 ``ccc`` within 1e-6 and the stacked BiGRU within 1e-5 of JAX's.
"""

import importlib.util
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.baseline import podcast as jpodcast
from interspeech_ser_tpu.ops.gru import gru_scan_bidir_stacked as jax_stacked
from interspeech_ser_tpu.utils import labels as jlabels
from interspeech_ser_tpu.utils import metrics as jmetrics
from interspeech_ser_tpu_torch import lora_evaluation as ev
from interspeech_ser_tpu_torch.baseline import podcast
from interspeech_ser_tpu_torch.ops.gru import gru_scan, gru_scan_bidir_stacked
from interspeech_ser_tpu_torch.utils import labels, metrics

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _jax_evaluation():
    spec = importlib.util.spec_from_file_location("lora_wavlm_evaluation",
                                                  os.path.join(ROOT, "lora_wavlm", "evaluation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == pytest.approx(b, abs=1e-12)


def test_eval_metric_and_fairness_match_jax():
    J = _jax_evaluation()
    rng = np.random.default_rng(0)
    y_true, y_pred = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    groups = rng.integers(0, 2, 50)
    ours, theirs = ev.EvalMetric(4), J.EvalMetric(4)
    for m in (ours, theirs):
        m.append_classification_results(y_true[:30], y_pred[:30], loss=0.7)
        m.append_classification_results(y_true[30:], y_pred[30:], loss=0.3)
    a, b = ours.classification_summary(), theirs.classification_summary()
    np.testing.assert_array_equal(a["conf"], b["conf"])
    for k in ("acc", "uar", "loss"):
        _same(a[k], b[k])
    empty_a, empty_b = ev.EvalMetric(3).classification_summary(), J.EvalMetric(3).classification_summary()
    np.testing.assert_array_equal(empty_a["conf"], empty_b["conf"])
    assert [empty_a[k] for k in ("acc", "uar", "loss")] == [empty_b[k] for k in ("acc", "uar", "loss")]
    for g in (groups, np.zeros(50, np.int64)):  # the second: group 1 empty
        _same(ev.demographic_parity(y_pred, g), J.demographic_parity(y_pred, g))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # an empty group's mean, in both packages
            _same(ev.statistical_parity(y_pred, g, 2), J.statistical_parity(y_pred, g, 2))
        _same(ev.equality_of_opportunity(y_true, y_pred, g, 1), J.equality_of_opportunity(y_true, y_pred, g, 1))


CONSENSUS = (
    "FileName,EmoClass,EmoAct,EmoVal,EmoDom,SpkrID,Gender,Split_Set\n"
    "MSP-PODCAST_0001_0001.wav,A,4.2,2.0,3.8,127,Female,Train\n"
    "MSP-PODCAST_0001_0002.wav,X,3.0,3.0,3.0,127,Female,Train\n"
    "MSP-PODCAST_0002_0001.wav,N,3.4,4.0,3.2,Unknown,Male,Development\n"
    "MSP-PODCAST_0003_0001.wav,O,2.0,4.5,2.2,54,Male,Train\n"
    "\"MSP-PODCAST_0003,0002.wav\",S,1.8,2.1,2.5,54,Male,Train\n"
    "MSP-PODCAST_0004_0001.wav,C,5.0,1.2,6.0,9,Female,Development\n"
    "MSP-PODCAST_0005_0001.wav,H,4.8,6.1,4.0,300,Female,Train\n"
    "MSP-PODCAST_0006_0001.wav,U,5.5,5.0,4.1,9,Male,Test1\n"
    "MSP-PODCAST_0007_0001.wav,F,3.9,2.2,2.0,127,Female,Train\n"
    "MSP-PODCAST_0008_0001.wav,D,3.2,1.9,4.4,300,Male,Development\n"
    "NA,N,3.0,4.0,3.0,12,Male,Train\n"
)


def test_process_labels_bytes_equal_pandas(tmp_path):
    src = tmp_path / "labels_consensus.csv"
    src.write_text(CONSENSUS)
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    rows = labels.process_labels_for_categorical(str(src), str(ours))
    df = jlabels.process_labels_for_categorical(str(src), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(rows) == len(df) == 9  # the X and O rows dropped
    np.testing.assert_array_equal(labels.matrix(rows), df[labels.CLASSES].to_numpy(np.float32))
    cli = tmp_path / "cli.csv"
    res = subprocess.run([sys.executable, "-m", "interspeech_ser_tpu_torch.utils.labels", str(src), str(cli)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"wrote {cli}" and cli.read_bytes() == theirs.read_bytes()


def test_label_helpers_match_jax():
    onehot = np.eye(8, dtype=np.float32)[np.random.default_rng(1).integers(0, 8, 20)]
    onehot[3] = 0.5 * onehot[3] + 0.5 * onehot[4]  # a soft row: the first maximum wins in both
    np.testing.assert_array_equal(labels.labels_to_index(onehot), jlabels.labels_to_index(onehot))
    got, want = labels.neutral_margin_targets(onehot), jlabels.neutral_margin_targets(onehot)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", ["train", "dev", "test1"])
def test_podcast_loaders_match_jax(tmp_path, split):
    src = tmp_path / "labels.csv"
    src.write_text(CONSENSUS[: CONSENSUS.index("NA,")])  # file names as written (pandas reads "NA" as a NaN)
    for name in ("load_adv_arousal", "load_adv_dominance", "load_adv_valence"):
        (a_utts, a_lab), (b_utts, b_lab) = getattr(podcast, name)(str(src), split), getattr(jpodcast, name)(
            str(src), split)
        assert list(a_utts) == list(b_utts) and a_lab.shape == b_lab.shape
        np.testing.assert_array_equal(a_lab, b_lab.astype(np.float64))
    (a_utts, a_spk, a_n), (b_utts, b_spk, b_n) = podcast.load_spk_id(str(src), split), jpodcast.load_spk_id(
        str(src), split)
    assert list(a_utts) == list(b_utts) and a_n == b_n and a_spk.dtype == b_spk.dtype
    np.testing.assert_array_equal(a_spk, b_spk)


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    y, logits = rng.integers(0, 5, 40), rng.standard_normal((40, 5))
    pred = logits.argmax(1)
    assert metrics.micro_f1(y, pred) == jmetrics.micro_f1(y, pred)
    assert metrics.calc_err(logits, y) == jmetrics.calc_err(logits, y)
    assert metrics.calc_acc(logits, y) == jmetrics.calc_acc(logits, y)
    pred32, lab32 = (rng.standard_normal(40).astype(np.float32) for _ in range(2))
    got = float(metrics.ccc(torch.from_numpy(pred32), torch.from_numpy(lab32 + 0.5 * pred32)))
    assert got == pytest.approx(float(jmetrics.ccc(jnp.asarray(pred32), jnp.asarray(lab32 + 0.5 * pred32))), abs=1e-6)


def test_stacked_bigru_matches_jax_and_two_scans():
    rng = np.random.default_rng(3)
    B, T, I, H = 3, 9, 5, 6
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray([9, 6, 1])[:, None]).astype(np.float32)
    h0 = np.zeros((B, H), np.float32)
    fwd, bwd = ([rng.standard_normal(s).astype(np.float32) * 0.4 for s in ((3 * H, I), (3 * H, H), (3 * H,), (3 * H,))]
                for _ in range(2))
    t = lambda ps: [torch.from_numpy(p) for p in ps]  # noqa: E731
    ours = gru_scan_bidir_stacked(torch.from_numpy(x), torch.from_numpy(h0), t(fwd), t(bwd), torch.from_numpy(mask))
    flax = lambda ps: (jnp.asarray(ps[0].T), jnp.asarray(ps[1].T), jnp.asarray(ps[2]), jnp.asarray(ps[3]))  # noqa: E731
    ref = np.asarray(jax_stacked(jnp.asarray(x), jnp.asarray(h0), flax(fwd), flax(bwd), jnp.asarray(mask)))
    assert ours.shape == (B, T, 2 * H)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    two = torch.cat([gru_scan(torch.from_numpy(x), torch.from_numpy(h0), *t(fwd), mask=torch.from_numpy(mask)),
                     gru_scan(torch.from_numpy(x), torch.from_numpy(h0), *t(bwd), mask=torch.from_numpy(mask),
                              reverse=True)], dim=-1)
    np.testing.assert_allclose(ours.numpy(), two.numpy(), atol=1e-6, rtol=0)
