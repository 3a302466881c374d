"""The port's proto-angular trainers against the JAX package's: the
speaker-embedding losses, the four samplers, the torchaudio-semantics
melspec, the three nets, ``ProtoAngularEngine`` and ``ProtoOnlyEngine`` over
two epochs, the checkpoints, and ``proto_main`` for all five variants.

Weights go from the JAX nets to the port (``models/convert.py``); dropout is
off on both sides (the JAX engine's ``_embed`` run deterministic, the port's
generator taken away). Bars: losses within 1e-6; sampler index lists equal;
melspec within rtol 1e-5; forwards within 1e-5; running statistics within
1e-6; parameters after two epochs, the checkpoints' values and the best val
loss within 1e-5 (with the exceptions each test names: Adam's steps on
rounding-noise gradients, and the BatchNorm reference encoder, whose f32
gradients at random init sit 1e-5 to 3e-2 from float64 with the batch, in
both packages), the checkpoints' keys and the best epoch equal.
"""

import json
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.ops import melspec_ta as jmel
from interspeech_ser_tpu.train import data as jdata
from interspeech_ser_tpu.train import losses as jlosses
from interspeech_ser_tpu.train import proto_engine as jpe
from interspeech_ser_tpu.train import samplers as jsamplers
from interspeech_ser_tpu_torch.models.convert import (
    bidir_reference_encoder_params_from_flax,
    proto_ser_params_from_flax,
    style_embedding_params_from_flax,
)
from interspeech_ser_tpu_torch.ops import melspec_ta as pmel
from interspeech_ser_tpu_torch.train import data as pdata
from interspeech_ser_tpu_torch.train import losses as plosses
from interspeech_ser_tpu_torch.train import proto_engine as ppe
from interspeech_ser_tpu_torch.train import samplers as psamplers

torch.set_num_threads(2)
CLASSES = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_adam_close(got, want, steps, lr, shift_free=(), share=1e-4):
    """Parameters after ``steps`` Adam-type updates within 1e-5 of JAX's.
    Adam divides each element's gradient by its own running RMS, so an element
    whose gradient sits at the rounding floor (both packages' noise, ~1e-9)
    moves by up to lr in either package's own direction: ``shift_free``
    tensors, whose true gradient is 0 (a softmax's shared shift), stay within
    2 lr a step; so may at most ``share`` (0.01%) of any other tensor's
    elements. The 1e-5 is relative to the tensor's largest magnitude where
    that is above 1 (BatchNorm running variances)."""
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        d = np.abs(np.asarray(got[k], np.float64) - w)
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert d.max() <= 2 * steps * lr + tol, (k, d.max())
        if k not in shift_free:
            assert (d > tol).sum() <= max(1, int(d.size * share)), (k, d.max(), int((d > tol).sum()))


# -- losses, samplers, melspec ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["angle", "ge2e_softmax", "ge2e_contrast", "cosine"])
def test_speaker_losses_match_jax(kind):
    """Value within 1e-6; for the learnable (w, b) their gradients too."""
    e = np.random.default_rng(1).normal(size=(4, 5, 12)).astype(np.float32)
    if kind == "cosine":
        got = plosses._cosine_sim(torch.from_numpy(e[:, 0]), torch.from_numpy(e[:, 1])).numpy()
        np.testing.assert_allclose(got, np.asarray(jlosses._cosine_sim(jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]))),
                                   atol=1e-6)
        return
    w, b = torch.tensor(7.5, requires_grad=True), torch.tensor(-3.0, requires_grad=True)
    if kind == "angle":
        got = plosses.angle_proto_loss(torch.from_numpy(e), w, b)
        fn = lambda w_, b_: jlosses.angle_proto_loss(jnp.asarray(e), w_, b_)  # noqa: E731
    else:
        method = kind.split("_")[1]
        got = plosses.ge2e_loss(torch.from_numpy(e), w, b, method=method)
        fn = lambda w_, b_: jlosses.ge2e_loss(jnp.asarray(e), w_, b_, method=method)  # noqa: E731
    want, grads = jax.value_and_grad(fn, argnums=(0, 1))(7.5, -3.0)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6
    assert abs(float(w.grad) - float(grads[0])) <= 1e-6 and abs(float(b.grad) - float(grads[1])) <= 1e-6
    # the defaults (w, b) = (10, -5) and w clipped at 1e-6
    assert abs(float(plosses.angle_proto_loss(torch.from_numpy(e))) - float(jlosses.angle_proto_loss(jnp.asarray(e)))) \
        <= 1e-6
    assert abs(float(plosses.angle_proto_loss(torch.from_numpy(e), -1.0, 0.0))
               - float(jlosses.angle_proto_loss(jnp.asarray(e), -1.0, 0.0))) <= 1e-6


LABELS = np.random.default_rng(2).integers(0, 4, 61)
LENGTHS = np.random.default_rng(3).integers(100, 4000, 57)


@pytest.mark.parametrize("case", ["perfect_shuffle", "perfect_keep_last", "perfect_fixed", "perfect_subset_classes",
                                  "bucket", "bucket_drop_last", "sorted", "sorted_ascending", "subset"])
def test_samplers_yield_jax_index_lists(case):
    """Three passes of each sampler (the generator runs on across passes)."""
    def make(mod):
        if case.startswith("perfect"):
            kw = dict(perfect_shuffle=dict(shuffle=True, drop_last=True, seed=5),
                      perfect_keep_last=dict(shuffle=True, drop_last=False, seed=9),
                      perfect_fixed=dict(shuffle=False, drop_last=True),
                      perfect_subset_classes=dict(num_classes_in_batch=2, shuffle=True, drop_last=True, seed=4))[case]
            return mod.PerfectBatchSampler(LABELS, range(4), 8 if case != "perfect_subset_classes" else 6, **kw)
        if case.startswith("bucket"):
            return mod.BucketBatchSampler(LENGTHS, 5, drop_last=case.endswith("drop_last"),
                                          bucket_size_multiplier=3, seed=8)
        if case.startswith("sorted"):
            return mod.SortedSampler(LENGTHS, descending=case == "sorted")
        return mod.SubsetSampler([5, 3, 9, 1])

    got, want = make(psamplers), make(jsamplers)
    assert len(got) == len(want)
    for _ in range(3):
        a = [list(map(int, b)) if isinstance(b, (list, np.ndarray)) else int(b) for b in got]
        b = [list(map(int, x)) if isinstance(x, (list, np.ndarray)) else int(x) for x in want]
        assert a == b and len(a) > 0


def test_perfect_batches_are_class_major():
    sampler = psamplers.PerfectBatchSampler(LABELS, range(4), 12, shuffle=True, drop_last=True, seed=0)
    for batch in sampler:
        groups = LABELS[batch].reshape(4, 3)
        assert (groups == groups[:, :1]).all()
    np.testing.assert_array_equal(ppe._regroup_class_major(3, 2), jpe._regroup_class_major(3, 2))


@pytest.mark.parametrize("sample_rate", [16000, 1600])
def test_melspec_matches_jax(sample_rate):
    """The log-mel of a wav (and the filter bank, the reference's 1600 bug
    included) within rtol 1e-5."""
    wav = np.random.default_rng(4).normal(size=7000).astype(np.float32) * 0.2
    got = pmel.TorchaudioMelSpectrogram(sample_rate=sample_rate)
    want = jmel.TorchaudioMelSpectrogram(sample_rate=sample_rate)
    np.testing.assert_array_equal(got.fb, want.fb)
    np.testing.assert_allclose(got(wav), want(wav), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got(wav, log=False), want(wav, log=False), rtol=1e-5, atol=0)
    assert got(wav).shape == (1 + 7000 // 160, 80)


# -- nets ------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n_cls", [0, 5])
def test_style_embedding_net_matches_jax(n_cls):
    """Masked (ragged lengths, one full row) forward within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 13, 10)).astype(np.float32)
    mask = (np.arange(13)[None] < np.asarray([13, 7, 4])[:, None]).astype(np.float32)
    jnet = jpe.StyleEmbeddingNet(10, hidden_dim=6, embedding_dim=5, num_classes=n_cls)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    pnet = ppe.StyleEmbeddingNet(10, hidden_dim=6, embedding_dim=5, num_classes=n_cls)
    pnet.load_state_dict(style_embedding_params_from_flax(np_tree(params)))
    want = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), torch.from_numpy(mask))
    for g, w in zip(got if n_cls else (got,), want if n_cls else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_cls,heads", [(8, 1), (0, 4)])
def test_proto_ser_net_matches_jax(n_cls, heads, tmp_path):
    """Forward within 1e-5; the port's state dict is JAX's ``angle_ser.pt``:
    the same keys, the values within 1e-6."""
    x = np.random.default_rng(6).normal(size=(3, 11, 24)).astype(np.float32)
    jnet = jpe.ProtoSERNet(24, 16, n_cls, heads)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pnet = ppe.ProtoSERNet(24, 16, n_cls, heads)
    pnet.load_state_dict(proto_ser_params_from_flax(np_tree(variables["params"])))
    want = jnet.apply(variables, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x))
    for g, w in zip(got if n_cls else (got,), want if n_cls else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    engine = jpe.ProtoOnlyEngine(jnet, 2, 2, 2, n_devices=1)
    engine.variables = variables
    engine.save_torch_checkpoint(str(tmp_path / "angle_ser.pt"))
    saved = torch.load(tmp_path / "angle_ser.pt", weights_only=True)
    mine = pnet.state_dict()
    assert set(saved) == set(mine)
    for k in saved:
        np.testing.assert_allclose(mine[k].numpy(), saved[k].numpy(), atol=1e-6, rtol=0, err_msg=k)


def bidir_pair(mel, num_mel=16, emb=8):
    jnet = jpe.BidirectionalReferenceEncoder(num_mel=num_mel, embedding_dim=emb)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(mel))
    pnet = ppe.BidirectionalReferenceEncoder(num_mel=num_mel, embedding_dim=emb)
    pnet.load_state_dict(bidir_reference_encoder_params_from_flax(np_tree(variables["params"]),
                                                                 np_tree(variables["batch_stats"])))
    return jnet, variables, pnet


def test_bidirectional_reference_encoder_matches_jax(tmp_path):
    """Eval forward within 1e-5; a training forward within 1e-5 and its running
    statistics within 1e-6; the state dict is JAX's checkpoint (keys equal,
    values within 1e-6)."""
    mel = np.random.default_rng(7).normal(size=(4, 150, 16)).astype(np.float32)
    jnet, variables, pnet = bidir_pair(mel)
    pnet.eval()
    with torch.no_grad():
        got = pnet(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(variables, jnp.asarray(mel))), atol=1e-5, rtol=0)
    assert got.shape == (4, 8)
    want_t, upd = jnet.apply(variables, jnp.asarray(mel), deterministic=False, mutable=["batch_stats"])
    pnet.train()
    with torch.no_grad():
        got_t = pnet(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), atol=1e-5, rtol=0)
    for i, bn in enumerate(pnet.bns):
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"][f"bn{i}"]["mean"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"][f"bn{i}"]["var"]),
                                   atol=1e-6, rtol=0)
    engine = jpe.ProtoOnlyEngine(jnet, 2, 2, 2, has_batch_stats=True, n_devices=1)
    engine.variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
    engine.save_torch_checkpoint(str(tmp_path / "angle_ser.pt"))
    saved = torch.load(tmp_path / "angle_ser.pt", weights_only=True)
    mine = pnet.state_dict()
    assert set(saved) == set(mine)
    for k in saved:
        np.testing.assert_allclose(mine[k].numpy(), saved[k].numpy(), atol=1e-6, rtol=0, err_msg=k)


# -- engines ---------------------------------------------------------------------------------------------------


def write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """64 utterances of 4 classes: lazy [T, 12] features around a class mean,
    0.3-0.6-s voiced wavs with a class F0, a label CSV (8 emotions, Gender,
    Split_Set: 48 Train, 16 Development) and a FileName,Gender CSV."""
    root = tmp_path_factory.mktemp("proto_port")
    (root / "lazy").mkdir()
    (root / "wavs").mkdir()
    rng = np.random.default_rng(5)
    means = rng.normal(scale=2.0, size=(4, 12))
    lines = [",".join(["FileName"] + CLASSES + ["Gender", "Split_Set"])]
    genders = ["FileName,Gender"]
    for i in range(64):
        cls = i % 4
        name = f"p{i:03d}.wav"
        t = int(rng.integers(8, 20))
        torch.save(torch.from_numpy((rng.normal(size=(t, 12)) + means[cls]).astype(np.float32)),
                   str(root / "lazy" / f"p{i:03d}.pt"))
        n = int(16000 * rng.uniform(0.3, 0.6))
        f0 = 110 + 40 * cls
        x = sum(np.sin(2 * np.pi * k * f0 * np.arange(n) / 16000) / k for k in range(1, 12))
        write_wav(root / "wavs" / name, 0.2 * x / np.abs(x).max() + 0.01 * rng.standard_normal(n))
        gender = "Male" if (i // 4) % 2 else "Female"
        lines.append(",".join([name] + [str(float(c == cls)) for c in range(8)]
                              + [gender, "Train" if i < 48 else "Development"]))
        genders.append(f"{name},{gender}")
    (root / "labels.csv").write_text("\n".join(lines) + "\n")
    (root / "labels_nogender.csv").write_text(
        "\n".join(",".join(c for j, c in enumerate(line.split(",")) if j != 9) for line in lines) + "\n")
    (root / "gender.csv").write_text("\n".join(genders) + "\n")
    return root


def angular_data(corpus):
    names = [f"p{i:03d}.wav" for i in range(48)]
    y = np.eye(8, dtype=np.float32)[[i % 4 for i in range(48)]]
    return (jdata.LazyFeatureDataset(names, y, [str(corpus / "lazy")], [12]),
            pdata.LazyFeatureDataset(names, y, [str(corpus / "lazy")], [12]), np.argmax(y, axis=1))


_ANGULAR = {}


def jax_angular(corpus, softmax):
    """The JAX engine's two epochs of 4 classes x 3 (one run a setting, kept
    for the tests below): its initial and trained params, log and embeddings."""
    if softmax not in _ANGULAR:
        jds, _, ids = angular_data(corpus)
        je = jpe.ProtoAngularEngine(12, num_classes=4, utter_per_class=3, embedding_dim=6,
                                    use_softmax_proto=softmax, seed=3, n_devices=1)
        b = jds.collate([0, 1], 2)
        je.params = je.model.init(jax.random.PRNGKey(2), jnp.asarray(b.feats[0]), jnp.asarray(b.masks[0]))["params"]
        init = np_tree(je.params)
        log = []
        je.fit(jds, ids, epochs=2, lr=1e-3, log=log.append)
        _ANGULAR[softmax] = dict(init=init, trained=np_tree(je.params), log=log, emb=je.embed(jds, batch_size=16))
    return _ANGULAR[softmax]


def port_angular(corpus, softmax, run):
    _, pds, ids = angular_data(corpus)
    pe = ppe.ProtoAngularEngine(12, num_classes=4, utter_per_class=3, embedding_dim=6, use_softmax_proto=softmax,
                                seed=3, device="cpu")
    pe.model.load_state_dict(style_embedding_params_from_flax(run["init"]))
    log = []
    res = pe.fit(pds, ids, epochs=2, lr=1e-3, log=log.append)
    return pe, pds, res, log


@pytest.mark.parametrize("softmax", [False, True])
def test_proto_angular_engine_two_epochs_match_jax(corpus, softmax):
    """Two epochs of 4 classes x 3 utterances (4 steps an epoch) from the same
    weights: every parameter within 1e-5 of the JAX engine's, the last loss
    within 1e-5; ``embed`` of the trained nets (values up to ~8) within 1e-4
    relative. Adam's noise-floor elements as ``assert_adam_close`` says
    (``pool_attn.bias`` has a true gradient of 0: the pooling's softmax
    ignores a shift shared by a row's scores)."""
    run = jax_angular(corpus, softmax)
    pe, pds, res, log = port_angular(corpus, softmax, run)
    want = style_embedding_params_from_flax(run["trained"])
    assert_adam_close(pe.model.state_dict(), want, 8, 1e-3, shift_free=("pool_attn.bias",))
    jlast = float(run["log"][-1].split("loss=")[1].split()[0])
    assert len(log) == 2 and abs(round(res["loss"], 4) - jlast) <= 1e-4 + 1e-5
    np.testing.assert_allclose(pe.embed(pds, batch_size=16), run["emb"], atol=1e-5, rtol=1e-4)


def test_angular_wb_optimizer_decays_as_optax(corpus, monkeypatch):
    """The (w, b) AdamW decays by optax's default 1e-4: with torch's default
    1e-2 the parameters leave the bar after two epochs."""
    real = torch.optim.AdamW

    def torch_default(params, **kw):
        params = list(params)
        if len(params) == 2 and params[0].ndim == 0:
            kw["weight_decay"] = 1e-2
        return real(params, **kw)

    run = jax_angular(corpus, False)
    monkeypatch.setattr(ppe.torch.optim, "AdamW", torch_default)
    pe = port_angular(corpus, False, run)[0]
    want = style_embedding_params_from_flax(run["trained"])
    gap = max(float((pe.model.state_dict()[k] - want[k]).abs().max()) for k in want if k != "pool_attn.bias")
    assert gap > 1e-5


def lazy_sets(corpus, jmod, pmod):
    rows = [line.split(",") for line in (corpus / "labels.csv").read_text().split()[1:]]
    names = [r[0] for r in rows]
    y = np.asarray([int(np.argmax([float(v) for v in r[1:9]])) for r in rows])
    tr = np.asarray([r[-1] == "Train" for r in rows])
    split = lambda mod, m: mod.LazyProtoDataset([n for n, t in zip(names, m) if t], y[m], str(corpus / "lazy"))  # noqa
    return split(jmod, tr), split(jmod, ~tr), split(pmod, tr), split(pmod, ~tr)


def no_dropout(monkeypatch):
    """The JAX engine's nets run deterministic (no BatchNorm net is passed
    through here); the port engine's generator is taken away in ``port_engine``."""
    real = jpe.ProtoOnlyEngine._embed
    monkeypatch.setattr(jpe.ProtoOnlyEngine, "_embed",
                        lambda self, v, f, train, dkey=None: real(self, v, f, False) if not self.has_batch_stats
                        else real(self, v, f, train, dkey))


@pytest.mark.parametrize("ce_mode", [False, True])
def test_proto_only_engine_two_epochs_match_jax(corpus, tmp_path, monkeypatch, ce_mode):
    """``ProtoSERNet`` under ``ProtoOnlyEngine``, 4 classes x 3 (val x 2), two
    epochs of 4 steps (RAdam's rectified, Adam-like update from step 6): the
    parameters and the checkpoint (``angle_ser.pt`` / ``ser.pt``) of both
    within 1e-5 as ``assert_adam_close`` says (``attn_pooling.bias``: the
    pooling's softmax), the same keys; the best epoch equal and its val loss
    (angle, or dev CE + macro-F1 in ``ce_mode``) within 1e-4 (the noise-floor
    elements' steps reach it; ``proto_main``'s test holds the val loss to
    1e-5 in RAdam's momentum phase)."""
    no_dropout(monkeypatch)
    jtr, jva, ptr, pva = lazy_sets(corpus, jpe, ppe)
    jnet = jpe.ProtoSERNet(12, 16, 4, 1)
    je = jpe.ProtoOnlyEngine(jnet, 4, 3, 2, seed=3, ce_mode=ce_mode, val_batch_size=8, n_devices=1)
    je.variables = jnet.init(jax.random.PRNGKey(4), jnp.asarray(np.zeros((2, 16, 12), np.float32)))
    pnet = ppe.ProtoSERNet(12, 16, 4, 1)
    pnet.load_state_dict(proto_ser_params_from_flax(np_tree(je.variables["params"])))
    pe = ppe.ProtoOnlyEngine(pnet, 4, 3, 2, seed=3, ce_mode=ce_mode, val_batch_size=8, device="cpu")
    pe.generator = None
    logs = {"jax": [], "port": []}
    (tmp_path / "jax").mkdir()
    jbest = je.fit(jtr, jva, epochs=2, lr=5e-3, model_path=str(tmp_path / "jax"), log=logs["jax"].append)
    pbest = pe.fit(ptr, pva, epochs=2, lr=5e-3, model_path=str(tmp_path / "port"), log=logs["port"].append)
    assert pbest["epoch"] == jbest["epoch"] and abs(pbest["val_angle"] - jbest["val_angle"]) <= 1e-4
    shift_free = ("attn_pooling.bias",)
    assert_adam_close(pnet.state_dict(), proto_ser_params_from_flax(np_tree(je.variables["params"])), 8, 5e-3,
                      shift_free)
    name = "ser.pt" if ce_mode else "angle_ser.pt"
    j = torch.load(tmp_path / "jax" / name, weights_only=True)
    p = torch.load(tmp_path / "port" / name, weights_only=True)
    assert_adam_close(p, j, 8, 5e-3, shift_free)
    if ce_mode:
        jf1 = [float(m.split("dev f1=")[1]) for m in logs["jax"]]
        pf1 = [float(m.split("dev f1=")[1]) for m in logs["port"]]
        assert pf1 == jf1


class ArrayDataset:
    """In-memory features with the proto datasets' interface."""

    def __init__(self, feats, labels):
        self.feats, self.labels = feats, np.asarray(labels)

    def __len__(self):
        return len(self.feats)

    def features(self, idx):
        return self.feats[idx]


def test_bidirectional_encoder_gradients_against_float64():
    """The conditioning the engine tests below allow for: one training step's
    gradients of ``BidirectionalReferenceEncoder`` at its random init (the
    angle-proto loss over [B, 256, 80] Gaussian mels), f32 against the JAX
    net's float64 gradients, relative to each tensor's largest magnitude (the
    conv biases aside: a training-mode BatchNorm makes their true gradient
    0). In both packages that f32 error runs from 1e-5 to 3e-2 with the batch
    (measured over four batches); on this one (16 rows) it is ~2e-3 in both,
    and the port's is no more than twice JAX's own. So the engine tests hold
    this net to JAX at 1e-4, not 1e-5."""
    worst = {"jax": 0.0, "port": 0.0}
    jnet = jpe.BidirectionalReferenceEncoder(80, 16)
    for B, seed in ((16, 0),):
        mel = np.random.default_rng(seed).normal(size=(B, 256, 80)).astype(np.float32)
        v = np_tree(jnet.init(jax.random.PRNGKey(5), jnp.asarray(mel[:2])))
        pnet = ppe.BidirectionalReferenceEncoder(80, 16)
        pnet.load_state_dict(bidir_reference_encoder_params_from_flax(v["params"], v["batch_stats"]))
        pnet.train()
        plosses.angle_proto_loss(pnet(torch.from_numpy(mel)).reshape(2, B // 2, -1), 10.0, -5.0).backward()

        def grads(dtype):
            cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731

            def loss(p):
                out, _ = jnet.apply({"params": p, "batch_stats": cast(v["batch_stats"])}, jnp.asarray(mel, dtype),
                                    deterministic=False, mutable=["batch_stats"])
                return jlosses.angle_proto_loss(out.reshape(2, B // 2, -1), 10.0, -5.0)

            return bidir_reference_encoder_params_from_flax(np_tree(jax.jit(jax.grad(loss))(cast(v["params"]))),
                                                            v["batch_stats"])

        g32 = grads(jnp.float32)
        jax.config.update("jax_enable_x64", True)
        try:
            g64 = grads(jnp.float64)
        finally:
            jax.config.update("jax_enable_x64", False)
        for n, p in pnet.named_parameters():
            if n.startswith("convs.") and n.endswith(".bias"):
                continue
            ref, scale = g64[n].double(), float(g64[n].abs().max())
            worst["jax"] = max(worst["jax"], float((g32[n].double() - ref).abs().max()) / scale)
            worst["port"] = max(worst["port"], float((p.grad.double() - ref).abs().max()) / scale)
    assert 1e-5 < worst["port"] <= 2 * worst["jax"] <= 1e-2, worst


def test_proto_only_engine_bidirectional_encoder_matches_jax(tmp_path):
    """``BidirectionalReferenceEncoder`` (BatchNorm, BiGRU) under
    ``ProtoOnlyEngine`` over seeded [120-200, 80] mel-shaped features, 2
    classes x 12 (val x 4), two epochs of 2 steps (RAdam still in its
    momentum phase): the parameters and running statistics within 1e-4 (this
    net's f32 gradients, see the float64 test above), the best epoch
    equal and its val loss within 1e-4, the checkpoint (keys equal, values
    within 1e-4)."""
    rng = np.random.default_rng(8)
    feats = [rng.normal(size=(int(rng.integers(120, 200)), 80)).astype(np.float32) + 0.3 * (i % 2)
             for i in range(64)]
    g = np.asarray([i % 2 for i in range(64)])
    tr, va = ArrayDataset(feats[:48], g[:48]), ArrayDataset(feats[48:], g[48:])
    jnet = jpe.BidirectionalReferenceEncoder(80, 16)
    je = jpe.ProtoOnlyEngine(jnet, 2, 12, 4, seed=3, has_batch_stats=True, n_devices=1)
    je.variables = jnet.init(jax.random.PRNGKey(5), jnp.asarray(np.zeros((2, 64, 80), np.float32)))
    pnet = ppe.BidirectionalReferenceEncoder(80, 16)
    pnet.load_state_dict(bidir_reference_encoder_params_from_flax(np_tree(je.variables["params"]),
                                                                 np_tree(je.variables["batch_stats"])))
    pe = ppe.ProtoOnlyEngine(pnet, 2, 12, 4, seed=3, device="cpu")
    (tmp_path / "jax").mkdir()
    jbest = je.fit(tr, va, epochs=2, lr=1e-3, model_path=str(tmp_path / "jax"), log=lambda *_: None)
    pbest = pe.fit(tr, va, epochs=2, lr=1e-3, model_path=str(tmp_path / "port"), log=lambda *_: None)
    assert pbest["epoch"] == jbest["epoch"] and abs(pbest["val_angle"] - jbest["val_angle"]) <= 1e-4
    want = bidir_reference_encoder_params_from_flax(np_tree(je.variables["params"]),
                                                    np_tree(je.variables["batch_stats"]))
    got = pnet.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4, rtol=0, err_msg=k)
    j = torch.load(tmp_path / "jax" / "angle_ser.pt", weights_only=True)
    p = torch.load(tmp_path / "port" / "angle_ser.pt", weights_only=True)
    assert set(j) == set(p)
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), j[k].numpy(), atol=1e-4, rtol=0, err_msg=k)


def test_melspec_dataset_matches_jax(corpus):
    """The same log-mel features of the corpus's wavs (both mel bank rates)."""
    names = [f"p{i:03d}.wav" for i in range(6)]
    for sr in (16000, 1600):
        j = jpe.MelspecProtoDataset(names, np.zeros(6), str(corpus / "wavs"), mel_sample_rate=sr)
        p = ppe.MelspecProtoDataset(names, np.zeros(6), str(corpus / "wavs"), mel_sample_rate=sr)
        for i in range(6):
            np.testing.assert_array_equal(p.features(i), j.features(i))


def test_melspec_dataset_perturbs_from_its_seed(corpus):
    """With the perturbation on, the dataset's seed draws both the choice and
    the formant shift (the JAX dataset draws the shift unseeded): each read
    is the JAX package's ``fixed_timbre_perturb`` with those draws, then the
    JAX melspec; a second dataset of the same seed reads the same features."""
    from interspeech_ser_tpu.train.information_encoder import fixed_timbre_perturb
    from interspeech_ser_tpu.utils.audio import load_wav

    names = [f"p{i:03d}.wav" for i in range(8)]
    p = ppe.MelspecProtoDataset(names, np.zeros(8), str(corpus / "wavs"), perturb_prob=0.5, seed=2)
    again = ppe.MelspecProtoDataset(names, np.zeros(8), str(corpus / "wavs"), perturb_prob=0.5, seed=2)
    mel = jmel.TorchaudioMelSpectrogram(sample_rate=1600)
    rng = np.random.default_rng(2)
    changed = 0
    for i, name in enumerate(names):
        wav, _ = load_wav(str(corpus / "wavs" / name))
        if rng.random() < 0.5:
            wav, changed = fixed_timbre_perturb(wav, rng=rng), changed + 1
        got = p.features(i)
        np.testing.assert_allclose(got, mel(wav), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got, again.features(i))
    assert 0 < changed < 8


# -- proto_main ------------------------------------------------------------------------------------------------

# the five variants cut to the corpus (4 emotion or 2 gender classes), 2 steps an epoch, narrow nets
SMALL = {
    "wavlm_only": dict(C=4, U=6, U_val=2, jnet=lambda: jpe.ProtoSERNet(12, 16, 8, 1),
                       pnet=lambda: ppe.ProtoSERNet(12, 16, 8, 1)),
    "wavlm_ce": dict(C=4, U=6, U_val=2, jnet=lambda: jpe.ProtoSERNet(12, 16, 8, 1),
                     pnet=lambda: ppe.ProtoSERNet(12, 16, 8, 1)),
    "melspec_only": dict(C=4, U=6, U_val=2, perturb=0.0, jnet=lambda: jpe.ProtoSERNet(80, 16, 8, 1),
                         pnet=lambda: ppe.ProtoSERNet(80, 16, 8, 1)),
    "melspec_only_gender": dict(C=2, U=12, U_val=4, jnet=lambda: jpe.BidirectionalReferenceEncoder(80, 16),
                                pnet=lambda: ppe.BidirectionalReferenceEncoder(80, 16)),
    "wavlm_only_gender": dict(C=2, U=12, U_val=4, jnet=lambda: jpe.ProtoSERNet(12, 16, 0, 4),
                              pnet=lambda: ppe.ProtoSERNet(12, 16, 0, 4)),
}


@pytest.mark.parametrize("variant", list(SMALL))
def test_proto_main_matches_jax(corpus, tmp_path, monkeypatch, variant):
    """Each variant through both packages' ``proto_main`` (two epochs of 2
    steps, the same initial weights, dropout off, the melspec perturbation
    off): the best
    epoch equal and its val loss within 1e-5, the checkpoint of both with the
    same keys and values within 1e-5 (1e-4 for the BatchNorm net of
    ``melspec_only_gender``: the float64 test above). The gender variants read
    ``--gender_labels_csv`` when the label CSV has no Gender column; the
    wavlm gender net's width is the config's ``hidden_dim``."""
    small = SMALL[variant]
    spec_j, spec_p = dict(jpe._PROTO_VARIANTS[variant]), dict(ppe._PROTO_VARIANTS[variant])
    hidden = []
    for spec, key in ((spec_j, "jnet"), (spec_p, "pnet")):
        spec.update({k: v for k, v in small.items() if k in ("C", "U", "U_val", "perturb")})
        real_net = spec["net"]
        spec["net"] = lambda cfg, _k=key, _r=real_net: hidden.append(_r(cfg)) or small[_k]()
    monkeypatch.setitem(jpe._PROTO_VARIANTS, variant, spec_j)
    monkeypatch.setitem(ppe._PROTO_VARIANTS, variant, spec_p)
    monkeypatch.setattr(jpe, "_divisible_mesh", lambda n, *b, _r=jpe._divisible_mesh: _r(1, *b))
    no_dropout(monkeypatch)
    init = {}
    real_jfit, real_pfit = jpe.ProtoOnlyEngine.fit, ppe.ProtoOnlyEngine.fit

    def jfit(self, train_ds, val_ds, *a, **kw):
        probe, _ = self._collate(train_ds, [0, 1], 1)
        self.variables = self.net.init(jax.random.PRNGKey(6), jnp.asarray(probe))
        init["v"] = jax.tree.map(np.asarray, self.variables)
        return real_jfit(self, train_ds, val_ds, *a, **kw)

    def pfit(self, *a, **kw):
        v = init["v"]
        sd = (bidir_reference_encoder_params_from_flax(v["params"], v["batch_stats"]) if "batch_stats" in v
              else proto_ser_params_from_flax(v["params"]))
        self.net.load_state_dict(sd)
        self.generator = None
        return real_pfit(self, *a, **kw)

    monkeypatch.setattr(jpe.ProtoOnlyEngine, "fit", jfit)
    monkeypatch.setattr(ppe.ProtoOnlyEngine, "fit", pfit)
    gender = variant.endswith("gender")
    label = "labels_nogender.csv" if gender else "labels.csv"
    cfgs = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        cfg = {"label_path": str(corpus / label), "audio_lazy_dir": str(corpus / "lazy"), "epochs": 2, "lr": 5e-3,
               "model_path": str(tmp_path / side), "feat1_dim": 12, "hidden_dim": 12, "batch_size": 8}
        if variant == "wavlm_only_gender":
            cfg["hidden_dim"] = 12  # the feature width that variant reads
        if variant.startswith("melspec"):
            cfg.update(audio_lazy_dir=str(corpus / "wavs"), wav_dir=str(corpus / "wavs"))
        cfgs[side] = tmp_path / f"{side}.json"
        cfgs[side].write_text(json.dumps(cfg))
    extra = ["--gender_labels_csv", str(corpus / "gender.csv")] if gender else []
    jbest = jpe.proto_main(variant, ["--config_path", str(cfgs["jax"]), "--seed", "3"] + extra)
    pbest = ppe.proto_main(variant, ["--config_path", str(cfgs["port"]), "--seed", "3", "--device", "cpu"] + extra)
    bar = 1e-4 if variant == "melspec_only_gender" else 1e-5  # the BatchNorm net's f32 gradients
    assert pbest["epoch"] == jbest["epoch"] and abs(pbest["val_angle"] - jbest["val_angle"]) <= bar
    name = "ser.pt" if variant == "wavlm_ce" else "angle_ser.pt"
    j = torch.load(tmp_path / "jax" / name, weights_only=True)
    p = torch.load(tmp_path / "port" / name, weights_only=True)
    assert set(j) == set(p)
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), j[k].numpy(), atol=bar, rtol=0, err_msg=k)
    if variant == "wavlm_only_gender":
        assert hidden[0].feat_dim == hidden[1].wav_proj.in_features == 12  # ProtoSERNet(cfg["hidden_dim"], ...)
    if gender:  # without the CSV (and no GENDER_LABELS_CSV), the port says which file it needs
        monkeypatch.delenv("GENDER_LABELS_CSV", raising=False)
        with pytest.raises(ValueError, match="gender_labels_csv"):
            ppe.proto_main(variant, ["--config_path", str(cfgs["port"]), "--device", "cpu"])


def test_entry_points_default_to_the_card_and_refuse_devices(corpus, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ppe.ProtoAngularEngine(12)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ppe.main(["train_cat_wavlm_lazy_protoangularloss_only", "--config_path", str(tmp_path / "none.json")])
    # n_devices counts the ranks of a process group: more than 1 in a one-process run raises
    with pytest.raises(ValueError, match="n_devices=2, but this run has 1 rank"):
        ppe.ProtoAngularEngine(12, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="n_devices=4, but this run has 1 rank"):
        ppe.ProtoOnlyEngine(ppe.ProtoSERNet(12, 16), 2, 2, 2, n_devices=4, device="cpu")
    with pytest.raises(SystemExit):
        ppe.main(["train_cat_nothing"])
    assert set(ppe.STEMS.values()) == set(ppe._PROTO_VARIANTS) == set(jpe._PROTO_VARIANTS)
