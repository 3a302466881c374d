"""The port's data-parallel trainers on the CPU: 2 gloo ranks against one rank
and against the JAX engines' ``n_devices=2`` runs on the virtual CPU devices.

One spawn of 2 ranks runs every trainer task of
``tests/torch_parallel_workers.py`` this file checks; the one-rank results
come from the same tasks in this process, the JAX ones from the JAX package
here, from the same initial weights. Tolerances, stated per test:

- LoRA (``LoRAFTEngine``, head dropout off on both sides): the factors and
  the head within 1e-5 relative of the JAX run's; with dropout on, 2 ranks
  within 1e-5 of one rank;
- baseline (``BaselineEngine``, cat, one epoch of 3 micro-batches of 2, 2
  and 1 rows, the last padded to 2 on 2 ranks): every parameter within 1e-5
  of the JAX run's and of one rank's;
- joint (``JointEngine`` ``large``: focal with dynamic alpha; ``cka``) and
  text only (``TextOnlyEngine`` with focal): dropout on, 2 ranks within 1e-5
  of one rank (parameters, dev losses);
- proto (``ProtoOnlyEngine`` over ``ProtoSERNet`` and over the reference
  encoder with synchronised BatchNorm, ``ProtoAngularEngine``): as
  ``test_torch_proto_engine`` holds one device to JAX (``assert_adam_close``,
  1e-4 for the reference encoder, running statistics included);
- x-vector (``XVectorEngine``, synchronised BatchNorm): parameters and
  running statistics as ``test_torch_xvector`` holds one device to JAX;
- the audit: each all-reduce of gradients carries the trainable elements
  (LoRA: the factors and the head only), the x-vector's also the BatchNorm
  moments, the proto engines all-gather the embeddings; one rank reads
  ``NONE``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_workers as W
from interspeech_ser_tpu_torch.models.convert import (
    bidir_reference_encoder_params_from_flax,
    emotion_regression_params_from_flax,
    proto_ser_params_from_flax,
    style_embedding_params_from_flax,
    xvector_params_from_flax,
)
from interspeech_ser_tpu_torch.parallel import audit

from test_torch_baseline import carry as baseline_carry
from test_torch_baseline import jax_params as baseline_jax_params
from test_torch_baseline import write_corpus as write_baseline_corpus
from test_torch_joint_engine import write_joint_corpus
from test_torch_proto_engine import assert_adam_close
from test_torch_xvector import write_xvector_corpus


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def write_wav(path, x):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


# -- the JAX references -------------------------------------------------------------


def jax_lora(root):
    """A 2-layer WavLM dir, 10 wavs, and the JAX ``LoRAFTEngine(n_devices=2)``
    with factors whose B is non-zero -> (the initial factors + head in the
    port's layout, its run of one epoch at batch 3 with head dropout off ->
    the trained ones, the wavs, the labels)."""
    from transformers import WavLMConfig, WavLMModel

    from interspeech_ser_tpu.models import lora as jlora
    from interspeech_ser_tpu.train.lora_engine import LoRAFTEngine as JaxEngine

    torch.manual_seed(9)
    WavLMModel(WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2], num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=64,
        do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
    )).save_pretrained(str(root / "lora_wavlm"))
    wavs = [(0.3 * np.sin(np.arange(3200 + 480 * i) * (0.05 + 0.1 * (i % 2)))).astype(np.float32) for i in range(10)]
    labels = [i % 4 for i in range(10)]
    je = JaxEngine(str(root / "lora_wavlm"), rank=2, num_emotions=4, n_devices=2)
    rng = np.random.default_rng(1)
    je.lora = jax.tree.map(lambda x: np.asarray(x) if x.shape[0] != 2 else
                           rng.normal(0, 0.05, x.shape).astype(np.float32), je.lora)

    def state(engine):
        head = {f"{fc}.{k}": torch.tensor(np.asarray(engine.head_params[fc][leaf]).T if leaf == "kernel"
                                          else np.asarray(engine.head_params[fc][leaf]))
                for fc in ("fc1", "fc2") for k, leaf in (("weight", "kernel"), ("bias", "bias"))}
        return {"lora": {k: torch.tensor(np.asarray(v)) for k, v in jlora.lora_state_dict(engine.lora).items()},
                "head": head}

    real = je._forward
    je._forward = lambda base, lora, head, wav, mask, det, dkey=None: real(base, lora, head, wav, mask, True)

    def fit():
        je.train_epochs(wavs[:8], np.asarray(labels[:8]), wavs[8:], np.asarray(labels[8:]), epochs=1, batch_size=3,
                        lr=5e-3, log=lambda *_: None)
        return state(je)
    return state(je), fit, wavs, labels


def jax_baseline(corpus, out):
    """The JAX ``BaselineEngine(n_devices=2)`` (cat, dropout 0) -> (the
    port's initial state, its fit of one epoch at batch 6 in 3 micro-batches
    -> the final params in the port's names)."""
    from interspeech_ser_tpu.baseline.engine import BaselineEngine as JaxEngine
    from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine

    je = JaxEngine(str(corpus / "hf"), task="cat", head_dim=16, seed=100, n_devices=2, dropout=0.0)
    pe = BaselineEngine(str(corpus / "hf"), task="cat", head_dim=16, seed=100, dropout=0.0, device="cpu")
    baseline_carry(je, pe)
    init = {n: {k: v.clone() for k, v in getattr(pe, n).state_dict().items()} for n in ("ssl", "pool", "head")}

    def fit():
        je.fit(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "wavs"), model_path=str(out),
               batch_size=6, accumulation_steps=3, epochs=1, lr=1e-3)
        return baseline_jax_params(je.params, je.ssl_cfg)
    return init, fit


def proto_corpus(root):
    """48 lazy [8-20, 12] feature files of 4 classes (32 train, 16 dev)."""
    (root / "lazy").mkdir()
    rng = np.random.default_rng(5)
    means = rng.normal(scale=2.0, size=(4, 12))
    names = []
    for i in range(48):
        names.append(f"p{i:03d}.wav")
        t = int(rng.integers(8, 20))
        torch.save(torch.from_numpy((rng.normal(size=(t, 12)) + means[i % 4]).astype(np.float32)),
                   str(root / "lazy" / f"p{i:03d}.pt"))
    return names, [i % 4 for i in range(48)]


def jax_proto(root, names, labels):
    """The JAX ``ProtoOnlyEngine(n_devices=2)`` of a ``ProtoSERNet`` (4
    classes x 3, val x 2) and of a ``BidirectionalReferenceEncoder`` (2 x 6,
    val x 4; BatchNorm), deterministic, and ``ProtoAngularEngine(n_devices=2)``
    (4 x 3) -> ({name: initial state}, their fits -> {name: final state}),
    in the port's names."""
    from interspeech_ser_tpu.train import data as jdata
    from interspeech_ser_tpu.train import proto_engine as jpe

    labels = np.asarray(labels)
    lazy = str(root / "lazy")
    ser_net, ref_net = jpe.ProtoSERNet(12, 16, 0, 1), jpe.BidirectionalReferenceEncoder(12, 8)
    ser = jpe.ProtoOnlyEngine(ser_net, 4, 3, 2, seed=3, val_batch_size=8, n_devices=2)
    ser.variables = ser_net.init(jax.random.PRNGKey(4), jnp.asarray(np.zeros((2, 16, 12), np.float32)))
    ref = jpe.ProtoOnlyEngine(ref_net, 2, 6, 4, seed=3, has_batch_stats=True, val_batch_size=8, n_devices=2)
    ref.variables = ref_net.init(jax.random.PRNGKey(5), jnp.asarray(np.zeros((2, 16, 12), np.float32)))
    jds = jdata.LazyFeatureDataset(names[:24], np.eye(8, dtype=np.float32)[labels[:24]], [lazy], [12])
    ang = jpe.ProtoAngularEngine(12, num_classes=4, utter_per_class=3, embedding_dim=6, seed=3, n_devices=2)
    b = jds.collate([0, 1], 2)
    ang.params = ang.model.init(jax.random.PRNGKey(2), jnp.asarray(b.feats[0]), jnp.asarray(b.masks[0]))["params"]

    def states():
        return {"ser": proto_ser_params_from_flax(np_tree(ser.variables["params"])),
                "reference": bidir_reference_encoder_params_from_flax(np_tree(ref.variables["params"]),
                                                                     np_tree(ref.variables["batch_stats"])),
                "angular": style_embedding_params_from_flax(np_tree(ang.params))}

    def fit():
        real = jpe.ProtoOnlyEngine._embed
        jpe.ProtoOnlyEngine._embed = lambda self, v, f, train, dkey=None: real(self, v, f, False) \
            if not self.has_batch_stats else real(self, v, f, train, dkey)
        try:
            for name, eng, y, lr in (("ser", ser, labels, 5e-3), ("reference", ref, labels % 2, 1e-3)):
                (root / f"jax_{name}").mkdir()
                eng.fit(jpe.LazyProtoDataset(names[:32], y[:32], lazy), jpe.LazyProtoDataset(names[32:], y[32:], lazy),
                        epochs=2, lr=lr, model_path=str(root / f"jax_{name}"), log=lambda *_: None)
        finally:
            jpe.ProtoOnlyEngine._embed = real
        ang.fit(jds, labels[:24], epochs=2, lr=1e-3, log=lambda *_: None)
        return states()
    return states(), fit


def jax_xvector(corpus, out):
    """The JAX ``XVectorEngine(n_devices=2)`` (head dropout off) -> (the
    initial port state, its fit of one epoch at batch 4 in micro-batches of
    2 -> the final state)."""
    from interspeech_ser_tpu.baseline import models as jbmodels
    from interspeech_ser_tpu.baseline.xvector_engine import XVectorEngine as JaxXVectorEngine

    je = JaxXVectorEngine(head_dim=16, seed=3, n_devices=2)
    je.head = jbmodels.EmotionRegression(512, 16, 1, 8, dropout=0.0)

    def state():
        return {"xvector": xvector_params_from_flax(np_tree(je.xv_params), np_tree(je.xv_stats)),
                "head": emotion_regression_params_from_flax(np_tree(je.head_params))}
    def fit():
        je.fit(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "audio"), model_path=str(out),
               batch_size=4, accumulation_steps=2, epochs=1, lr=1e-4)
        return state()
    return state(), fit


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_engines")
    (root / "b").mkdir()
    (root / "j").mkdir()
    (root / "x").mkdir()
    (root / "p").mkdir()
    bcorpus = write_baseline_corpus(root / "b", n_train=5, n_dev=4)
    jcorpus = write_joint_corpus(root / "j")
    xcorpus = write_xvector_corpus(root / "x")
    names, labels = proto_corpus(root / "p")
    lora_init, lora_fit, wavs, wlabels = jax_lora(root)
    torch.save(lora_init, root / "lora_init.pt")
    base_init, base_fit = jax_baseline(bcorpus, root / "b_jax")
    torch.save(base_init, root / "base_init.pt")
    proto_init, proto_fit = jax_proto(root / "p", names, labels)
    for k, init in proto_init.items():
        torch.save(init, root / f"{k}_init.pt")
    xv_init, xv_fit = jax_xvector(xcorpus, root / "x_jax")
    torch.save(xv_init, root / "xv_init.pt")
    lazy = str(root / "p" / "lazy")
    glabels = [y % 2 for y in labels]

    def tasks(tag):
        lora = dict(model_dir=str(root / "lora_wavlm"), init_path=str(root / "lora_init.pt"),
                    wavs=[w.tolist() for w in wavs], labels=wlabels, n_train=8)
        return {
            "lora_jax": ("lora_fit", dict(lora, head_dropout=False)),
            "lora": ("lora_fit", dict(lora, epochs=2)),
            "baseline": ("baseline_fit", dict(model_dir=str(bcorpus / "hf"), init_path=str(root / "base_init.pt"),
                                              label_path=str(bcorpus / "labels.csv"),
                                              audio_path=str(bcorpus / "wavs"), model_path=str(root / f"b_{tag}"))),
            "baseline_focal": ("baseline_fit", dict(model_dir=str(bcorpus / "hf"), init_path=None,
                                                    label_path=str(bcorpus / "labels.csv"), dropout=0.5,
                                                    audio_path=str(bcorpus / "wavs"), loss_mode="ce_focal3",
                                                    model_path=str(root / f"bf_{tag}"))),
            "joint_large": ("joint_fit", dict(corpus=str(jcorpus), variant="large", model_path=str(root / f"jl_{tag}"))),
            "joint_cka": ("joint_fit", dict(corpus=str(jcorpus), variant="cka", model_path=str(root / f"jc_{tag}"))),
            "text": ("text_fit", dict(corpus=str(jcorpus), model_path=str(root / f"t_{tag}"))),
            "proto_ser": ("proto_only_fit", dict(net="ser", init_path=str(root / "ser_init.pt"), lazy_dir=lazy,
                                                 names=names, labels=labels, n_train=32, C=4, U=3, U_val=2,
                                                 model_path=str(root / f"ps_{tag}"))),
            "proto_ref": ("proto_only_fit", dict(net="reference", init_path=str(root / "reference_init.pt"),
                                                 lazy_dir=lazy, names=names, labels=glabels, n_train=32, C=2, U=6,
                                                 U_val=4, lr=1e-3, model_path=str(root / f"pr_{tag}"))),
            "proto_drop": ("proto_only_fit", dict(net="ser", init_path=str(root / "ser_init.pt"), lazy_dir=lazy,
                                                  names=names, labels=labels, n_train=32, C=4, U=3, U_val=2,
                                                  dropout=True, model_path=str(root / f"pd_{tag}"))),
            "angular": ("proto_angular_fit", dict(init_path=str(root / "angular_init.pt"), lazy_dir=lazy,
                                                  names=names[:24], labels=labels[:24], C=4, U=3)),
            "xvector": ("xvector_fit", dict(init_path=str(root / "xv_init.pt"), label_path=str(xcorpus / "labels.csv"),
                                            audio_path=str(xcorpus / "audio"), model_path=str(root / f"x_{tag}"))),
        }

    def here():  # the JAX references and the one-rank runs, while the ranks work
        return dict(lora_jax=lora_fit(), base_jax=base_fit(), proto=proto_fit(), xv_jax=xv_fit(),
                    one=W.run_tasks(tasks("one")))

    two, rest = W.spawn(2, tasks("two"), str(root / "ranks2"), meanwhile=here)
    return dict(two=two, base_init=base_init, **rest)


def _assert_rel(got: dict, want: dict, bar: float, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert rel(got[k], want[k]) <= bar, (what, k, rel(got[k], want[k]))


def _assert_grads_all_reduced(res, steps: int, extra_elements: int = 0, extra_count: int = 0):
    rec = res["audit"]["all-reduce"]
    assert rec["count"] == steps + extra_count, rec
    assert rec["elements"] == steps * res["trainable"] + extra_elements, (rec, res["trainable"])


# -- LoRA, baseline ---------------------------------------------------------------------


def test_lora_two_ranks_match_jax_and_one_rank(runs):
    """One epoch of 8 rows at batch 3 (3 steps; rows padded to 4 on 2 ranks)
    against the JAX ``n_devices=2`` run, head dropout off: the factors and
    the head within 1e-5 relative. Two epochs with dropout on: 2 ranks within
    1e-5 of one rank, per-step losses too. Each step all-reduces the factors
    and the head, never the frozen encoder."""
    for res in runs["two"]:
        got = res["lora_jax"]
        _assert_rel(got["lora"], runs["lora_jax"]["lora"], 1e-5, "lora")
        _assert_rel(got["head"], runs["lora_jax"]["head"], 1e-5, "head")
        drop, one = res["lora"], runs["one"]["lora"]
        _assert_rel(drop["lora"], one["lora"], 1e-5, "lora")
        _assert_rel(drop["head"], one["head"], 1e-5, "head")
        np.testing.assert_allclose(drop["losses"], one["losses"], atol=1e-5, rtol=0)
        assert drop["history"] == one["history"]
        _assert_grads_all_reduced(got, 3)
        assert got["trainable"] < got["encoder"]
    assert audit.audit_line(runs["one"]["lora"]["audit"]) == "collectives: NONE"


def test_baseline_two_ranks_match_jax_and_one_rank(runs):
    """Cat, dropout 0: one epoch of 5 rows at batch 6 in 3 micro-batches (2,
    2, 1 rows; the last padded on 2 ranks), one optimizer step: every
    parameter within 1e-5 of the JAX ``n_devices=2`` run's and of one rank's,
    and the frozen frontend unmoved; with CE + focal (dynamic alpha) and
    dropout 0.5, 2 ranks within 1e-5 of one rank."""
    init = {f"{n}.{k}": v for n, sd in runs["base_init"].items() for k, v in sd.items()}
    one = runs["one"]["baseline"]["params"]
    for res in runs["two"]:
        got = res["baseline"]["params"]
        assert got.keys() == runs["base_jax"].keys() == one.keys()
        for k, want in runs["base_jax"].items():
            np.testing.assert_allclose(got[k].numpy(), want, atol=1e-5, rtol=0, err_msg=k)
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
            assert torch.equal(got[k], init[k]) == ("feature_extractor." in k), k
        _assert_grads_all_reduced(res["baseline"], 1)
        focal, one_focal = res["baseline_focal"], runs["one"]["baseline_focal"]
        for k, v in focal["params"].items():
            np.testing.assert_allclose(v.numpy(), one_focal["params"][k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(focal["dev_losses"], one_focal["dev_losses"], atol=1e-5, rtol=0)


# -- joint, text only -------------------------------------------------------------------


@pytest.mark.parametrize("run", ["joint_large", "joint_cka", "text"])
def test_joint_and_text_two_ranks_match_one_rank(runs, run):
    """Dropout on (each rank keeps its rows of the global mask), batch 4 in
    micro-batches of 2 (joint) or 4 (text): the head and every epoch's dev
    loss within 1e-5 of one rank's; the key third of each attention's
    ``in_proj_bias`` (a shift of every score of a query: a true gradient of
    0, whose float noise Adam turns into steps of up to lr) within 2 lr a
    step; one all-reduce of the trained parameters an update."""
    one = runs["one"][run]
    for res in runs["two"]:
        got = res[run]
        steps = got["audit"]["all-reduce"]["count"]
        for k in one["head"]:
            g, w = got["head"][k].numpy(), one["head"][k].numpy()
            if k.endswith("in_proj_bias"):
                E = len(w) // 3
                np.testing.assert_allclose(g[E: 2 * E], w[E: 2 * E], atol=2 * 1e-3 * steps, rtol=0, err_msg=k)
                g, w = np.delete(g, np.s_[E: 2 * E]), np.delete(w, np.s_[E: 2 * E])
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["dev_losses"], one["dev_losses"], atol=1e-5, rtol=0)
        rec = got["audit"]["all-reduce"]
        assert rec["count"] >= 1 and rec["elements"] == rec["count"] * got["trainable"]
    assert audit.audit_line(one["audit"]) == "collectives: NONE"


# -- proto, x-vector --------------------------------------------------------------------


def test_proto_only_two_ranks_match_jax(runs):
    """``ProtoSERNet`` (4 x 3, val 4 x 2; two epochs of 8 steps, RAdam)
    against the JAX ``n_devices=2`` run as ``assert_adam_close`` holds one
    device (``attn_pooling.bias``: the pooling's shift); the reference
    encoder (2 x 6, val 2 x 4; BatchNorm moments over both ranks' rows)
    within 1e-4, running statistics included; each step all-reduces the
    net's gradients (the reference encoder's BatchNorm moments too) and
    all-gathers the embeddings."""
    for res in runs["two"]:
        ser, ref = res["proto_ser"], res["proto_ref"]
        steps = 2 * (8 // 3)  # 2 epochs of the batches of 3 of each class's 8 train rows
        assert_adam_close(ser["state"], runs["proto"]["ser"], steps, 5e-3, ("attn_pooling.bias",))
        want = runs["proto"]["reference"]
        assert ref["state"].keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(ref["state"][k].numpy(), want[k].numpy(), atol=1e-4, rtol=0, err_msg=k)
        _assert_grads_all_reduced(ser, steps)
        ref_steps = 2 * (16 // 6)  # 2 epochs of the batches of 6 of each gender's 16 train rows
        n_bn = sum(k.endswith("running_mean") for k in ref["state"])
        assert ref["audit"]["all-reduce"]["count"] == ref_steps * (1 + 2 * n_bn)  # gradients, moments fwd + bwd
        assert ser["audit"]["all-gather"]["count"] > 0 and ser["audit"]["all-gather"]["elements"] > 0
    assert audit.audit_line(runs["one"]["proto_ser"]["audit"]) == "collectives: NONE"


def test_proto_two_ranks_match_one_rank_with_dropout(runs):
    """``ProtoSERNet`` with its input, attention and classifier dropout on:
    2 ranks within 1e-5 of one rank."""
    one = runs["one"]["proto_drop"]
    for res in runs["two"]:
        got = res["proto_drop"]
        for k in one["state"]:
            np.testing.assert_allclose(got["state"][k].numpy(), one["state"][k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
        assert got["best"]["epoch"] == one["best"]["epoch"]


def test_proto_angular_two_ranks_match_jax(runs):
    """``ProtoAngularEngine`` (4 x 3, two epochs): the net as
    ``assert_adam_close`` holds one device to JAX (``pool_attn.bias``: the
    pooling's shift), embeddings gathered."""
    for res in runs["two"]:
        got = res["angular"]
        assert_adam_close(got["state"], runs["proto"]["angular"], 4, 1e-3, shift_free=("pool_attn.bias",))
        assert got["audit"]["all-gather"]["count"] > 0
        np.testing.assert_allclose(got["emb"], runs["one"]["angular"]["emb"], atol=1e-4, rtol=1e-4)


def test_xvector_two_ranks_match_jax(runs):
    """One epoch at batch 4 in micro-batches of 2 (one row a rank; BatchNorm
    on both rows): the parameters and running statistics as
    ``test_torch_xvector`` holds one device to JAX (``assert_adam_close``,
    share 0.02); every micro-batch all-reduces each BatchNorm's moments
    forward and backward, every step the gradients."""
    want = {**{f"xv.{k}": v for k, v in runs["xv_jax"]["xvector"].items()},
            **{f"head.{k}": v for k, v in runs["xv_jax"]["head"].items()}}
    for res in runs["two"]:
        got = res["xvector"]
        state = {**{f"xv.{k}": v for k, v in got["xvector"].items()}, **{f"head.{k}": v for k, v in got["head"].items()}}
        assert_adam_close(state, want, 3, 1e-4, share=0.02)
        n_bn = sum(k.endswith("running_mean") for k in got["xvector"])
        channels = sum(v.numel() for k, v in got["xvector"].items() if k.endswith("running_mean"))
        micro, steps = 6, 3  # 12 train rows in micro-batches of 2, 2 a step
        _assert_grads_all_reduced(got, steps, extra_elements=micro * 2 * (2 * channels + n_bn),
                                  extra_count=micro * 2 * n_bn)
        one = runs["one"]["xvector"]
        np.testing.assert_allclose(got["dev_losses"], one["dev_losses"], atol=1e-5, rtol=0)
    assert json.dumps(runs["one"]["xvector"]["dev_losses"])
