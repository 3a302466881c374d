"""The port's challenge baseline against the JAX package: the data stack,
the pooling and head, the CCC loss and metric, one engine step (loss and
every gradient) for ``wce``, ``ce_focal3`` and ``dim``, gradient
accumulation over a short last micro-batch, and a 2-epoch fit.

A tiny WavLM written by transformers (hidden 32, 2 layers, 4 heads, the
7-layer conv frontend's kernels and strides at 16 channels: a frame every
320 samples, as the pooling assumes) and wavs under 1 s. Both engines load
the same directory; the encoder, pooling and head parameters are carried
from the JAX engine to the port (``speech_params_from_flax``,
``baseline_params_from_flax``), and the head's dropout is 0 on both sides.
Bars: modules at atol 1e-6; f32 losses and gradients within 1e-5 relative
to each tensor's largest magnitude (same math, other summation orders,
through an encoder); the bf16 ``dim`` gradients against the JAX bf16
engine's by cosine per tensor over ten micro-batches (bars in
``test_bf16_engine_step_matches_jax``); parameters after a step within
1e-5; per-epoch dev losses within 1e-4.
"""

import itertools
import os
import pickle
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.baseline import data as jdata
from interspeech_ser_tpu.baseline import models as jmodels
from interspeech_ser_tpu.baseline import podcast as jpodcast
from interspeech_ser_tpu.baseline.engine import BaselineEngine as JaxEngine
from interspeech_ser_tpu.train import losses as jlosses
from interspeech_ser_tpu.utils import metrics as jmetrics
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.baseline import podcast
from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine
from interspeech_ser_tpu_torch.baseline.models import AttentiveStatisticsPooling, EmotionRegression
from interspeech_ser_tpu_torch.models.convert import baseline_params_from_flax, speech_params_from_flax
from interspeech_ser_tpu_torch.train.losses import ccc_loss
from interspeech_ser_tpu_torch.utils.metrics import LogManager, concordance_ccc
from interspeech_ser_tpu_torch.utils.seeding import numpy_generator

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RNG = np.random.default_rng(31)
N_TRAIN, N_DEV = 5, 4


def write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def write_corpus(root, n_train=N_TRAIN, n_dev=N_DEV, n_test3=3):
    """A tiny HF WavLM (``hf``), wavs of 0.3-0.9 s named as the challenge's,
    a label CSV (8 emotions, 3 attributes, the split) and
    ``configs/config_cat.json``."""
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(5)
    WavLMModel(WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=64,
        do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
        conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        num_feat_extract_layers=7,
    )).save_pretrained(str(root / "hf"))
    (root / "wavs").mkdir()
    rng = np.random.default_rng(3)
    header = ["FileName"] + podcast.CAT_COLUMNS + podcast.ADV_COLUMNS + ["Split_Set"]
    lines = [",".join(header)]
    for i in range(n_train + n_dev):
        cls = i % 4
        name = f"MSP-PODCAST_{i:04d}.wav"
        n = int(rng.uniform(0.3, 0.9) * 16000)
        write_wav(root / "wavs" / name, 0.3 * np.sin(np.arange(n) * (0.03 + 0.04 * cls)) + 0.02 * rng.standard_normal(n))
        attrs = [f"{v:.3f}" for v in rng.uniform(0.1, 0.9, 3)]
        onehot = [str(float(c == cls)) for c in range(8)]
        lines.append(",".join([name] + onehot + attrs + ["Train" if i < n_train else "Development"]))
    for i in range(n_test3):
        n = int(rng.uniform(0.3, 0.9) * 16000)
        write_wav(root / "wavs" / f"MSP-PODCAST_test3_{i:04d}.wav", 0.2 * np.sin(np.arange(n) * 0.07))
    (root / "labels.csv").write_text("\n".join(lines) + "\n")
    (root / "configs").mkdir()
    (root / "configs" / "config_cat.json").write_text(
        '{"wav_dir": "%s", "label_path": "%s"}' % (root / "wavs", root / "labels.csv"))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("baseline_port"))


def carry(je, pe):
    """The JAX engine's encoder, pooling and head into the port's engine."""
    pe.ssl.load_state_dict(speech_params_from_flax(jax.tree.map(np.asarray, je.params["ssl"]), je.ssl_cfg))
    pool, head = baseline_params_from_flax(jax.tree.map(np.asarray, je.params["pool"]),
                                           jax.tree.map(np.asarray, je.params["head"]))
    pe.pool.load_state_dict(pool)
    pe.head.load_state_dict(head)


def engines(corpus, task="cat", dtype="float32", loss_mode="wce"):
    je = JaxEngine(str(corpus / "hf"), task=task, head_dim=16, seed=100, dtype=dtype, n_devices=1, dropout=0.0,
                   loss_mode=loss_mode)
    pe = BaselineEngine(str(corpus / "hf"), task=task, head_dim=16, seed=100, dtype=dtype, dropout=0.0,
                        loss_mode=loss_mode, device="cpu")
    carry(je, pe)
    return je, pe


def port_params(pe):
    """{name: numpy} of the port's encoder (HF names), pooling and head."""
    out = {f"ssl.{k}": v.detach().numpy() for k, v in pe.ssl.state_dict().items()}
    out.update({f"pool.{k}": v.detach().numpy() for k, v in pe.pool.state_dict().items()})
    out.update({f"head.{k}": v.detach().numpy() for k, v in pe.head.state_dict().items()})
    return out


def jax_params(tree, cfg):
    """The same names for a JAX param (or gradient) tree."""
    np_tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    out = {f"ssl.{k}": v.numpy() for k, v in speech_params_from_flax(np_tree["ssl"], cfg).items()}
    pool, head = baseline_params_from_flax(np_tree["pool"], np_tree["head"])
    out.update({f"pool.{k}": v.numpy() for k, v in pool.items()})
    out.update({f"head.{k}": v.numpy() for k, v in head.items()})
    return out


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# -- data ------------------------------------------------------------------------


def test_labels_and_norm_stats_match_jax(corpus, tmp_path):
    """The label loaders, the streaming mean / std, and the pickle: the JAX
    package reads the port's, and the port reads the shipped reference one."""
    labels = str(corpus / "labels.csv")
    for split in ("train", "dev"):
        assert list(podcast.load_utts(labels, split)) == list(jpodcast.load_utts(labels, split))
        for mine, theirs in ((podcast.load_cat_emo_label, jpodcast.load_cat_emo_label),
                             (podcast.load_adv_emo_label, jpodcast.load_adv_emo_label)):
            (u1, l1), (u2, l2) = mine(labels, split), theirs(labels, split)
            assert list(u1) == list(u2)
            np.testing.assert_array_equal(l1, l2.astype(np.float64))
    wavs = [RNG.normal(size=n).astype(np.float32) for n in (100, 300, 77)]
    assert bdata.get_norm_stat_for_wav(wavs) == jdata.get_norm_stat_for_wav(wavs)
    path = str(tmp_path / "train_norm_stat.pkl")
    bdata.save_norm_stat(path, *bdata.get_norm_stat_for_wav(wavs))
    assert jdata.load_norm_stat(path) == bdata.get_norm_stat_for_wav(wavs)
    shipped = os.path.join(ROOT, "benchmark", "model", "cat_ser", "7", "train_norm_stat.pkl")
    with open(shipped, "rb") as f:
        want = tuple(float(v) for v in pickle.load(f))
    mean, std = bdata.load_norm_stat(shipped)
    assert (mean, std) == want and np.isfinite(mean) and std > 0


def test_dataset_collate_and_epoch_order_match_jax(corpus):
    """``WavDataset.get`` (12-s cap, z-norm + 1e-6), ``collate_wav`` (the
    16000-sample quantum, fixed rows, padding rows with sample_mask 0), the
    epoch order of one seed with its length windows, and the balanced
    sampler's weights."""
    lens = [3000, 200000, 17000, 16000, 9000, 40000]
    wavs = [RNG.normal(size=n).astype(np.float32) for n in lens]
    labs = np.eye(8)[[0, 3, 3, 5, 0, 0]]
    utts = [f"u{i}" for i in range(6)]
    mine, theirs = bdata.WavDataset(wavs, labs, utts), jdata.WavDataset(wavs, labs, utts)
    assert mine.max_dur == theirs.max_dur == 12 * 16000
    for i in range(6):
        (w1, n1), (w2, n2) = mine.get(i), theirs.get(i)
        assert n1 == n2 and w1.dtype == w2.dtype == np.float32
        np.testing.assert_array_equal(w1, w2)
    for idxs, rows in (([1, 2], 4), ([0], 2), ([3, 4, 5], 3)):
        b1, b2 = bdata.collate_wav(mine, idxs, rows), jdata.collate_wav(theirs, idxs, rows)
        for f in ("wav", "mask", "labels", "sample_mask"):
            np.testing.assert_array_equal(getattr(b1, f), getattr(b2, f))
        assert b1.utts == b2.utts and b1.wav.shape[1] % 16000 == 0
    lengths = np.asarray([len(w) for w in wavs * 7])
    for shuffle in (True, False):
        a = bdata.epoch_batches(42, 4, numpy_generator(100), shuffle, lengths)
        b = jdata.epoch_batches(42, 4, numpy_generator(100), shuffle, lengths)
        assert [list(map(int, x)) for x in a] == [list(map(int, x)) for x in b]
    np.testing.assert_array_equal(bdata.inverse_freq_sample_weights(labs), jdata.inverse_freq_sample_weights(labs))


# -- modules, losses, metrics ----------------------------------------------------


def test_pooling_and_head_match_flax():
    """Carried params, a batch with a short row and a row with mask 0 (uniform
    weights over its frames); state-dict keys are the JAX converters'."""
    B, T, D = 4, 30, 16
    xs = RNG.normal(size=(B, T, D)).astype(np.float32)
    mask = np.zeros((B, 9600), np.float32)
    for i, n in enumerate((9600, 7777, 321, 0)):
        mask[i, :n] = 1
    jp = jmodels.AttentiveStatisticsPooling(D)
    pp = jp.init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(mask))["params"]
    jh = jmodels.EmotionRegression(2 * D, 12, 1, 8, dropout=0.5)
    hp = jh.init(jax.random.PRNGKey(1), jnp.zeros((1, 2 * D)))["params"]
    pool_sd, head_sd = baseline_params_from_flax(jax.tree.map(np.asarray, pp), jax.tree.map(np.asarray, hp))
    assert list(pool_sd) == list(jmodels.pooling_flax_to_torch(pp))
    assert list(head_sd) == list(jmodels.ser_flax_to_torch(hp, 1))
    pool, head = AttentiveStatisticsPooling(D), EmotionRegression(2 * D, 12, 1, 8, dropout=0.5)
    assert sorted(pool.state_dict()) == sorted(pool_sd) and list(head.state_dict()) == list(head_sd)
    pool.load_state_dict(pool_sd)
    head.load_state_dict(head_sd)
    want = np.asarray(jp.apply({"params": pp}, jnp.asarray(xs), jnp.asarray(mask)))
    with torch.no_grad():
        got = pool(torch.from_numpy(xs), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[3, :D].numpy(), xs[3].mean(axis=0), atol=1e-6)  # uniform weights
        np.testing.assert_allclose(head(got).numpy(), np.asarray(jh.apply({"params": hp}, jnp.asarray(want))),
                                   atol=1e-6, rtol=0)
        # bf16 frames: the pool computes in f32 and returns bf16, as flax does
        xb = jnp.asarray(xs).astype(jnp.bfloat16)
        want_b = np.asarray(jp.apply({"params": pp}, xb, jnp.asarray(mask)).astype(jnp.float32))
        got_b = pool(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(), torch.from_numpy(mask))
        assert got_b.dtype == torch.bfloat16
        np.testing.assert_allclose(got_b.float().numpy(), want_b, atol=1e-2, rtol=1e-2)


def test_ccc_loss_and_metric_match_jax():
    pred = RNG.normal(size=(6, 3)).astype(np.float32)
    lab = RNG.uniform(size=(6, 3)).astype(np.float32)
    smask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for m in (None, smask):
        want = float(jlosses.ccc_loss(jnp.asarray(pred), jnp.asarray(lab), None if m is None else jnp.asarray(m)))
        got = float(ccc_loss(torch.from_numpy(pred), torch.from_numpy(lab), None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6, (got, want)
    masked = float(ccc_loss(torch.from_numpy(pred), torch.from_numpy(lab), torch.from_numpy(smask)))
    assert abs(masked - float(ccc_loss(torch.from_numpy(pred[:4]), torch.from_numpy(lab[:4])))) <= 1e-6
    for i in range(3):
        assert abs(concordance_ccc(pred[:, i], lab[:, i]) - jmetrics.concordance_ccc(pred[:, i], lab[:, i])) <= 1e-6
    lm, jm = LogManager(), jmetrics.LogManager()
    for book in (lm, jm):
        book.alloc_stat_type_list(["train_loss", "dev_loss"])
        for v in (0.5, 0.25):
            book.add_stat("train_loss", v)
    assert lm.print_stat() == jm.print_stat() == "train_loss:0.3750"


# -- the engine ------------------------------------------------------------------


def port_grads(pe):
    """{name: gradient} of the port's trained tensors (None where none reached)."""
    return {f"{m}.{k}": p.grad for m in ("ssl", "pool", "head") for k, p in getattr(pe, m).named_parameters()}


def jax_step(engine, **jit_kw):
    """The JAX engine's ``_apply`` + ``_loss`` under ``jax.value_and_grad``, as
    ``fn(params, batch, class_weights)``."""
    def loss_fn(p, wav, mask, labels, smask, cw):
        pred = engine._apply(p, wav, mask, False, jax.random.PRNGKey(0))
        return engine._loss(pred, labels, smask, cw)

    fn = jax.jit(jax.value_and_grad(loss_fn), **jit_kw)
    return lambda p, b, cw=None: fn(p, *(jnp.asarray(x) for x in (b.wav, b.mask, b.labels, b.sample_mask)),
                                    None if cw is None else jnp.asarray(cw))


def check_frozen_and_k_bias(got, want, bar):
    """No gradient reaches the frozen frontend on either side, and ``k_proj.bias``'s
    is zero but for rounding (a softmax ignores a shift shared by a row's
    scores); -> the names of the other tensors, whose JAX gradient is nonzero."""
    assert set(got) == set(want)
    largest = max(np.abs(g).max() for g in want.values())
    rest = []
    for k, g in want.items():
        if k.startswith("ssl.feature_extractor."):
            assert got[k] is None and not np.abs(g).any(), k
        elif k.endswith("k_proj.bias"):
            assert max(np.abs(g).max(), float(got[k].abs().max())) <= 1e-1 * bar * largest, k
        else:
            assert np.abs(g).max() > 0, k
            rest.append(k)
    return rest


@pytest.mark.parametrize("task,loss_mode", [("cat", "wce"), ("cat", "ce_focal3")])
def test_one_engine_step_matches_jax(corpus, task, loss_mode):
    """The loss and every gradient of one f32 micro-batch of 4 rows (the last
    one padding): the JAX engine's ``_apply`` + ``_loss`` under
    ``jax.value_and_grad`` against the port's ``loss(...).backward()``, within
    1e-5 relative."""
    je, pe = engines(corpus, task, "float32", loss_mode)
    utts, labs = podcast.load_cat_emo_label(str(corpus / "labels.csv"), "train")
    ds = bdata.WavDataset(bdata.load_audio(str(corpus / "wavs"), utts), labs, utts)
    b = bdata.collate_wav(ds, [0, 3, 1], 4)
    cw = np.array([0.5, 1.5, 1.0, 2.0, 0, 0, 0, 0], np.float32)
    want_loss, want = jax_step(je)(je.params, b, cw)
    loss = pe.loss(b, torch.from_numpy(cw))
    loss.backward()
    assert rel(np.float32(loss.item()), np.asarray(want_loss, np.float32)) <= 1e-5
    want, got = jax_params(want, je.ssl_cfg), port_grads(pe)
    for k in check_frozen_and_k_bias(got, want, 1e-5):
        assert rel(got[k].numpy(), want[k]) <= 1e-5, (k, rel(got[k].numpy(), want[k]))


def test_bf16_engine_step_matches_jax(corpus):
    """``dim`` trains in bf16. Ten micro-batches of 4 rows (every 3 of the 5
    train rows, then a padding row) through the port's bf16 engine, the JAX
    package's bf16 engine and its f32 one. XLA on the CPU keeps the
    intermediates of a fusion in f32 unless ``xla_allow_excess_precision`` is
    off, which puts its bf16 gradients nearer f32 than a computation that
    rounds every op (as the port and the card do): with it on, the JAX bf16
    gradients averaged cosine 0.975 to f32 on these draws and the port's
    0.937; with it off, 0.940. The JAX bf16 step is compiled with it off.
    Bars, from those readings: each loss within 5e-2 relative of the JAX
    bf16 one and the mean within 1.5e-2 (0.001-0.032, mean 0.0096: the loss
    is 3 - sum CCC over 3 rows); per tensor, cosine to the JAX bf16
    gradients >= 0.75 (least reading 0.84, on a bias whose gradient is 8e-5),
    a median >= 0.98 in every draw (0.989-0.999) and a mean >= 0.99 over all
    (0.995); and the port no further from the f32 gradients than the JAX
    bf16 engine, mean cosine within 0.01 (0.937 and 0.940)."""
    je, pe = engines(corpus, "dim", "bfloat16")
    j32 = JaxEngine(str(corpus / "hf"), task="dim", head_dim=16, seed=100, n_devices=1, dropout=0.0)
    step16 = jax_step(je, compiler_options={"xla_allow_excess_precision": False})
    step32 = jax_step(j32)
    utts, labs = podcast.load_adv_emo_label(str(corpus / "labels.csv"), "train")
    ds = bdata.WavDataset(bdata.load_audio(str(corpus / "wavs"), utts), labs, utts)
    to_jax16, to_f32, jax16_to_f32, loss_rel = [], [], [], []
    for rows in itertools.combinations(range(N_TRAIN), 3):
        b = bdata.collate_wav(ds, list(rows), 4)
        want_loss, want = step16(je.params, b)
        want, f32 = jax_params(want, je.ssl_cfg), jax_params(step32(j32.params, b)[1], j32.ssl_cfg)
        for p in pe.trainable():
            p.grad = None
        loss = pe.loss(b)
        loss.backward()
        loss_rel.append(rel(np.float32(loss.item()), np.asarray(want_loss, np.float32)))
        assert loss_rel[-1] <= 5e-2, (rows, loss_rel[-1])
        got = port_grads(pe)
        keys = check_frozen_and_k_bias(got, want, 1e-2)
        c = [cos(got[k].numpy(), want[k]) for k in keys]
        assert min(c) >= 0.75 and np.median(c) >= 0.98, (rows, min(c), np.median(c))
        to_jax16 += c
        to_f32 += [cos(got[k].numpy(), f32[k]) for k in keys]
        jax16_to_f32 += [cos(want[k], f32[k]) for k in keys]
    assert np.mean(loss_rel) <= 1.5e-2, loss_rel
    assert np.mean(to_jax16) >= 0.99, np.mean(to_jax16)
    assert np.mean(to_f32) >= np.mean(jax16_to_f32) - 0.01, (np.mean(to_f32), np.mean(jax16_to_f32))


@pytest.fixture(scope="module")
def fits(corpus, tmp_path_factory):
    """Both engines' ``fit`` for 2 epochs of 5 train rows at batch 6 with 3
    accumulation steps: micro-batches of 2, 2 and 1 rows (the last padded),
    one optimizer step an epoch. Records each engine's parameters and dev
    loss at every epoch's end."""
    out = tmp_path_factory.mktemp("baseline_fits")
    je, pe = engines(corpus)
    rec = {"jax": [], "port": []}

    def hook(name, engine, params_of):
        evaluate = engine.evaluate

        def wrapped(ds, cw=None):
            res = evaluate(ds, cw)
            rec[name].append((params_of(), res["loss"]))
            return res
        engine.evaluate = wrapped

    hook("jax", je, lambda: jax_params(je.params, je.ssl_cfg))
    hook("port", pe, lambda: {k: v.copy() for k, v in port_params(pe).items()})
    init = {k: v.copy() for k, v in port_params(pe).items()}
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "wavs"), batch_size=6,
              accumulation_steps=3, epochs=2, lr=1e-3)
    jbest = je.fit(model_path=str(out / "jax"), **kw)
    pbest = pe.fit(model_path=str(out / "port"), **kw)
    return dict(rec=rec, init=init, jbest=jbest, pbest=pbest, jax_path=out / "jax", port_path=out / "port")


def test_accumulation_step_matches_jax(fits):
    """Parameters after the first optimizer step (3 micro-batches, the last
    with a padding row) within 1e-5 of the JAX engine's; every trained
    tensor moved, the frontend's did not."""
    (got, _), (want, _) = fits["rec"]["port"][0], fits["rec"]["jax"][0]
    assert set(got) == set(want) == set(fits["init"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
        changed = not np.array_equal(got[k], fits["init"][k])
        assert changed != k.startswith("ssl.feature_extractor."), k


def test_two_epoch_fit_matches_jax(fits):
    """Per-epoch dev losses within 1e-4 of the JAX engine's, the same best
    epoch, and the checkpoint files of both."""
    jl = [loss for _, loss in fits["rec"]["jax"]]
    pl = [loss for _, loss in fits["rec"]["port"]]
    assert len(jl) == len(pl) == 2 and pl == fits["pbest"]["dev_losses"]
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    assert fits["pbest"]["epoch"] == fits["jbest"]["epoch"]
    assert fits["pbest"]["loss"] == min(pl)
    for name in ("final_ser.pt", "final_pool.pt", "final_ssl.pt", "train_norm_stat.pkl"):
        assert (fits["port_path"] / name).exists() and (fits["jax_path"] / name).exists(), name


def test_balanced_batches_match_jax(corpus, tmp_path, monkeypatch):
    """``use_balanced_batch``: rows drawn with replacement by inverse class
    frequency from the engine's numpy generator. One epoch at batch 4 with 2
    accumulation steps: both engines collate the same rows in the same order
    (the dev batches after them included), and their dev losses agree within
    1e-4."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jdata), ("port", bdata)):
        real = mod.collate_wav
        monkeypatch.setattr(mod, "collate_wav", lambda ds, idxs, rows, _r=real, _n=name: (
            seen[_n].append((len(ds), [int(i) for i in idxs], rows)) or _r(ds, idxs, rows)))
    je, pe = engines(corpus)
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "wavs"), batch_size=4,
              accumulation_steps=2, epochs=1, lr=1e-3, use_balanced_batch=True)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **kw)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **kw)
    train = [c for c in seen["port"] if c[0] == N_TRAIN]
    assert seen["port"] == seen["jax"] and [len(c[1]) for c in train] == [2, 2, 1]
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-4
