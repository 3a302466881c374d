"""One deterministic train step of the port's joint engine against the JAX
``JointEngine`` for ``base``, ``ftall``, ``large``, ``cka`` and ``ckainv``:
the loss, and the gradient of every trained tensor (the head's; for
``ftall`` also both encoders'); the frozen variants pass no gradient to an
encoder on either side.

A tiny corpus: a WavLM at the tiny config of ``tests/test_joint_engine.py``
(hidden 24, 2 layers, 4 heads) but with the 7-layer frontend's kernels and
strides at 12 channels, a frame every 320 samples (its 2-layer frontend
makes 1,599 frames a second and its attention dominates the CPU time), a
RoBERTa at hidden 16 over 2 layers, 20 wavs under 0.4 s with transcripts,
and ``tests/test_joint_engine.py``'s dummy tokenizer (12 tokens). Both
engines load the same directories; the JAX engine's encoder and head
parameters are carried to the port (``speech_params_from_flax``,
``roberta_params_from_flax``, ``joint_params_from_flax``); both heads run
without dropout (JAX ``deterministic=True``). Bars: the loss within 1e-5
relative; each gradient within 1e-5 of its tensor's largest magnitude, or
of 1e-4 of the step's largest gradient where the tensor's is smaller (the
sums that nearly cancel: ``k_proj`` / ``key`` biases, whose gradient a
softmax zeroes but for rounding, ~1e-11 of the largest, and in ``ftall``
layer 0's ``gru_rel_pos_linear.bias``, 2.9e-6 of it, where the two
packages' f32 sums differ by 1.8e-5 of the tensor's own largest).
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.baseline import data as jdata
from interspeech_ser_tpu.train.joint_engine import JointEngine as JaxJointEngine
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.models.convert import (
    joint_params_from_flax,
    roberta_params_from_flax,
    speech_params_from_flax,
)
from interspeech_ser_tpu_torch.train.joint_engine import VARIANTS, JointEngine
from interspeech_ser_tpu_torch.utils import labels as L

torch.set_num_threads(2)
N_TRAIN, N_DEV = 14, 6
HEAD_DIM = 8


def write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def dummy_tokenize(texts, max_length=12):
    """``tests/test_joint_engine.py``'s tokenizer, with a stable word hash."""
    ids = np.ones((len(texts), max_length), np.int64)  # pad id 1
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, t in enumerate(texts):
        toks = [2] + [3 + sum(map(ord, w)) % 40 for w in str(t).split()][: max_length - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def write_joint_corpus(root, n_train=N_TRAIN, n_dev=N_DEV):
    """HF dirs ``hf_wavlm`` / ``hf_roberta``, ``audio/`` wavs of 0.22-0.4 s
    (tones by class), ``labels.csv`` (the 8 emotions, ``Split_Set``) and
    ``transcripts.csv`` (one row missing, one ``NA``) -> ``root``."""
    from transformers import RobertaConfig, RobertaModel, WavLMConfig, WavLMModel

    (root / "audio").mkdir()
    lines = ["FileName," + ",".join(L.CLASSES) + ",Split_Set"]
    texts = ["FileName,transcription"]
    for i in range(n_train + n_dev):
        cls = i % 8
        name = f"MSP-PODCAST_{i:03d}.wav"
        write_wav(root / "audio" / name, 0.3 * np.sin(np.arange(3500 + 160 * i) * (0.04 + 0.02 * cls)))
        lines.append(",".join([name] + [str(float(c == cls)) for c in range(8)]
                              + ["Train" if i < n_train else "Development"]))
        if i != 3:
            texts.append(f"{name},{'NA' if i == 5 else ('sample text %d ' % cls) * (cls + 1)}")
    (root / "labels.csv").write_text("\n".join(lines) + "\n")
    (root / "transcripts.csv").write_text("\n".join(texts) + "\n")
    torch.manual_seed(4)
    WavLMModel(WavLMConfig(
        hidden_size=24, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        conv_dim=[12] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        num_feat_extract_layers=7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32,
        max_bucket_distance=64, do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
    )).save_pretrained(str(root / "hf_wavlm"))
    RobertaModel(RobertaConfig(
        vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
    )).save_pretrained(str(root / "hf_roberta"))
    return root


def write_config(root, model_dir, **extra):
    cfg = {"wav_dir": str(root / "audio"), "txt_dir": str(root / "transcripts.csv"),
           "label_path": str(root / "labels.csv"), "ssl_type": str(root / "hf_wavlm"),
           "text_type": str(root / "hf_roberta"), "batch_size": 4, "accum_step": 2, "epochs": 1, "lr": 1e-3,
           "model_path": str(root / model_dir), "head_dim": HEAD_DIM, "pooling_type": "none",
           "weight_decay": 1e-6, "dropout_head": 0.5, "use_timbre_perturb": False, "tp_prob": 0.0, **extra}
    path = root / f"config_{model_dir}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_joint_corpus(tmp_path_factory.mktemp("joint_port"))


def head_kw(variant):
    o = VARIANTS[variant]
    return dict(head=o.head, classifier_layernorm=o.classifier_layernorm, num_layers=2, gated=o.gated)


def engines(corpus, variant, seed=3):
    """The JAX engine (one device) and the port's on the CPU, the port
    carrying the JAX engine's encoders and head."""
    je = JaxJointEngine(str(corpus / "hf_wavlm"), str(corpus / "hf_roberta"), dummy_tokenize, VARIANTS[variant],
                        head_dim=HEAD_DIM, seed=seed, n_devices=1)
    pe = JointEngine(str(corpus / "hf_wavlm"), str(corpus / "hf_roberta"), dummy_tokenize, VARIANTS[variant],
                     head_dim=HEAD_DIM, seed=seed, device="cpu")
    carry(je, pe, variant)
    return je, pe


def carry(je, pe, variant):
    p = jax.tree.map(np.asarray, je.params)
    pe.ssl.load_state_dict(speech_params_from_flax(p["ssl"], je.ssl_cfg))
    pe.txt.load_state_dict(roberta_params_from_flax(p["txt"], je.txt_cfg))
    pe.head.load_state_dict(joint_params_from_flax(p["head"], **head_kw(variant)))


def named(tree, je, variant):
    """{ssl.* / txt.* / head.*: numpy} of a JAX param or gradient tree under the port's names."""
    t = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    out = {f"ssl.{k}": v.numpy() for k, v in speech_params_from_flax(t["ssl"], je.ssl_cfg).items()}
    out.update({f"txt.{k}": v.numpy() for k, v in roberta_params_from_flax(t["txt"], je.txt_cfg).items()})
    out.update({f"head.{k}": v.numpy() for k, v in joint_params_from_flax(t["head"], **head_kw(variant)).items()})
    return out


def port_grads(pe):
    return {f"{m}.{k}": p.grad for m in ("ssl", "txt", "head") for k, p in getattr(pe, m).named_parameters()}


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def train_batch(corpus, rows=(0, 5, 9), n_rows=4, normalize_wav=True):
    """Rows of the Train split through ``collate_txt_wav`` (the last row
    padding), as both packages' engines collate them."""
    from interspeech_ser_tpu_torch.baseline.podcast import load_cat_emo_label

    merged = L.split(L.load_merged(str(corpus / "labels.csv"), str(corpus / "transcripts.csv")), "Train")
    utts, labs = load_cat_emo_label(str(corpus / "labels.csv"), "train")
    ds = bdata.WavDataset(bdata.load_audio(str(corpus / "audio"), utts), labs, utts, normalize_wav=normalize_wav)
    txt = bdata.TxtDataset(L.transcripts(merged), dummy_tokenize)
    return bdata.collate_txt_wav(ds, txt, list(rows), n_rows), ds, txt


def test_collate_txt_wav_matches_jax(corpus):
    """``TxtDataset`` (a missing and an ``NA`` transcript are the empty text)
    and ``collate_txt_wav`` equal the JAX package's, wavs normalised or not."""
    import pandas as pd

    label_df = pd.read_csv(corpus / "labels.csv")
    df = label_df.merge(pd.read_csv(corpus / "transcripts.csv"), on="FileName", how="left")
    for normalize_wav in (True, False):
        (wb, ids, mask), ds, txt = train_batch(corpus, (1, 3, 5), 4, normalize_wav)
        jds = jdata.WavDataset(ds.wav_list, ds.labels, ds.utts, normalize_wav=normalize_wav)
        jtxt = jdata.TxtDataset(df[df["Split_Set"] == "Train"]["transcription"].tolist(), dummy_tokenize)
        assert txt.texts == jtxt.texts and txt.texts[3] == txt.texts[5] == ""
        jwb, jids, jmask = jdata.collate_txt_wav(jds, jtxt, [1, 3, 5], 4)
        for f in ("wav", "mask", "labels", "sample_mask"):
            np.testing.assert_array_equal(getattr(wb, f), getattr(jwb, f))
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        assert ids.dtype == mask.dtype == np.int64 and not mask[3].any()


@pytest.mark.parametrize("variant", ["base", "ftall", "large", "cka", "ckainv"])
def test_one_train_step_matches_jax(corpus, variant):
    """Loss and gradients of one micro-batch (3 rows and a padding row),
    head dropout off: the JAX engine's ``_apply`` + ``_loss`` under
    ``jax.value_and_grad`` against the port's ``loss(...).backward()``."""
    je, pe = engines(corpus, variant)
    (wb, ids, tmask), _, _ = train_batch(corpus)
    cw = np.array([0.5, 1.5, 1.0, 2.0, 0.7, 1.1, 0.9, 1.3], np.float32)

    def loss_fn(p, wav, wmask, tids, tm, y, smask, w):
        return je._loss(je._apply(p, wav, wmask, tids, tm, True), y, smask, w)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (want_total, (want_main, want_cka)), want = fn(
        je.params, *(jnp.asarray(a) for a in (wb.wav, wb.mask, ids, tmask, np.argmax(wb.labels, 1),
                                              wb.sample_mask, cw)))
    total, main, cka = pe.loss(wb, ids, tmask, torch.from_numpy(cw), deterministic=True)
    total.backward()
    for got, w in ((total, want_total), (main, want_main), (cka, want_cka)):
        assert abs(got.item() - float(w)) <= 1e-5 * max(abs(float(w)), 1.0), (got.item(), float(w))
    want, got = named(want, je, variant), port_grads(pe)
    assert set(got) == set(want)
    trained = [k for k in want if k.startswith("head.") or VARIANTS[variant].finetune_encoders]
    floor = 1e-4 * max(np.abs(want[k]).max() for k in trained)
    for k in want:
        if k not in trained:  # stop_gradient on the JAX side, no_grad + frozen on the port's
            assert got[k] is None and not np.abs(want[k]).any(), k
        else:
            err = np.abs(got[k].numpy() - want[k]).max() / max(np.abs(want[k]).max(), floor)
            assert err <= 1e-5, (k, err)
    if VARIANTS[variant].finetune_encoders:
        assert any(k.startswith("ssl.feature_extractor.") for k in trained)  # ftall trains the frontend too


def test_timbre_perturb_and_devices_raise(corpus, tmp_path):
    # n_devices counts the ranks of a process group: 2 in a one-process run raises
    with pytest.raises(ValueError, match="n_devices=2, but this run has 1 rank"):
        JointEngine(str(corpus / "hf_wavlm"), str(corpus / "hf_roberta"), dummy_tokenize, VARIANTS["base"],
                    n_devices=2, device="cpu")
    # the timbre perturbation no longer raises: fit trains with it (held to JAX in
    # tests/test_torch_legacy_baseline.py)
    pe = JointEngine(str(corpus / "hf_wavlm"), str(corpus / "hf_roberta"), dummy_tokenize, VARIANTS["base"],
                     head_dim=HEAD_DIM, device="cpu")
    best = pe.fit(str(corpus / "labels.csv"), str(corpus / "audio"), str(corpus / "transcripts.csv"),
                  str(tmp_path / "m"), batch_size=4, accumulation_steps=2, epochs=1, lr=1e-3,
                  use_timbre_perturb=True, tp_prob=0.8)
    assert best["epoch"] == 0 and np.isfinite(best["loss"]) and os.path.exists(tmp_path / "m" / "final_ser.pt")
