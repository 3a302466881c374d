"""The port's x-vector path against the JAX package's: ``speechbrain_fbank``,
``XVector`` (forward, BatchNorm running statistics, the speechbrain
converters) and ``XVectorEngine`` over two epochs.

Weights go from the JAX modules to the port (``models/convert.py``); the
head's dropout is off on both sides. Bars: fbank within rtol 1e-5; forwards
within 1e-5; running statistics within 1e-6; after two epochs the parameters
within 1e-5 but for 2% of a tensor's elements (below), the dev losses within
1e-5, ``final_xvector.pt`` / ``final_ser.pt`` with JAX's keys.

The TDNN's f32 weight gradients at this size sit 1e-3 to 1e-2 (relative to
each tensor's largest) from a float64 run of the same step (measured on the
port's CPU path; the JAX f32 gradients differ from float64 by as much on
other inputs), and Adam turns that into steps that differ by up to lr where
an element's gradient is small: ``test_torch_proto_engine.assert_adam_close``
with ``share=0.02``, at the engine's default lr 1e-4.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.baseline import models as jbmodels
from interspeech_ser_tpu.baseline.xvector_engine import XVectorEngine as JaxXVectorEngine
from interspeech_ser_tpu.models import xvector as jxv
from interspeech_ser_tpu.ops import mel as jmel
from interspeech_ser_tpu_torch.baseline.xvector_engine import XVectorEngine
from interspeech_ser_tpu_torch.models import xvector as pxv
from interspeech_ser_tpu_torch.models.convert import emotion_regression_params_from_flax, xvector_params_from_flax
from interspeech_ser_tpu_torch.ops import mel as pmel
from test_torch_proto_engine import assert_adam_close

torch.set_num_threads(2)
CLASSES = ["Angry", "Sad", "Happy", "Surprise", "Fear", "Disgust", "Contempt", "Neutral"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("masked", [False, True])
def test_speechbrain_fbank_matches_jax(masked):
    """[B, 1 + L // 160, 24] within rtol 1e-5 (atol 1e-4 on values of tens of
    dB), the sentence mean over the live frames when ``lengths`` is given."""
    wav = np.random.default_rng(1).normal(size=(3, 9000)).astype(np.float32) * 0.1
    lengths = np.asarray([9000.0, 6400.0, 3000.0], np.float32) if masked else None
    if masked:
        wav[1, 6400:] = 0
        wav[2, 3000:] = 0
    got = pmel.speechbrain_fbank(torch.from_numpy(wav), lengths=None if lengths is None else torch.from_numpy(lengths))
    want = jmel.speechbrain_fbank(jnp.asarray(wav), lengths=None if lengths is None else jnp.asarray(lengths))
    assert got.shape == (3, 1 + 9000 // 160, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pmel._htk_mel_bank(201, 24, 0.0, 8000.0, 16000),
                                  jmel._htk_mel_bank(201, 24, 0.0, 8000.0, 16000))


def xvector_pair(x):
    jnet = jxv.XVector()
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pnet = pxv.XVector()
    pnet.load_state_dict(xvector_params_from_flax(np_tree(v["params"]), np_tree(v["batch_stats"])))
    return jnet, v, pnet


def test_xvector_forward_and_running_stats_match_jax():
    """Eval forward with ragged lengths within 1e-5; a training forward within
    1e-5 and the running statistics it leaves within 1e-6; the padded tail
    re-zeroed after every block, so a row equals its batch-1 run (1e-5)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, 24)).astype(np.float32)
    lengths = np.asarray([40, 27, 15])
    x[1, 27:] = x[2, 15:] = 0  # zero padding, as a batch-1 conv sees past the end
    jnet, v, pnet = xvector_pair(x)
    pnet.eval()
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
        alone = pnet(torch.from_numpy(x[2:, :15])).numpy()
        free = pnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(v, jnp.asarray(x), lengths=jnp.asarray(lengths))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(free, np.asarray(jnet.apply(v, jnp.asarray(x))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2:], alone, atol=1e-5, rtol=0)
    want_t, upd = jnet.apply(v, jnp.asarray(x), lengths=jnp.asarray(lengths), train=True, mutable=["batch_stats"])
    pnet.train()
    with torch.no_grad():
        got_t = pnet(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), atol=1e-5, rtol=0)
    for i, bn in enumerate(pnet.bn):
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"][f"bn{i}"]["mean"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"][f"bn{i}"]["var"]),
                                   atol=1e-6, rtol=0)


def test_speechbrain_converters_match_jax():
    """A state dict under speechbrain's names (Conv1d, ReLU and BatchNorm
    blocks, the final ``w`` linear): the port reads it into ``XVector`` with
    JAX's values, writes JAX's ``final_xvector.pt`` names back, and the two
    nets then agree."""
    rng = np.random.default_rng(3)
    sb = {}
    chans = (24, 512, 512, 512, 512, 1500)
    for i, (ch, k, _) in enumerate(pxv.TDNN_BLOCKS):
        sb[f"blocks.{3 * i}.conv.weight"] = rng.normal(size=(ch, chans[i], k)).astype(np.float32) * 0.05
        sb[f"blocks.{3 * i}.conv.bias"] = rng.normal(size=ch).astype(np.float32) * 0.1
        sb[f"blocks.{3 * i + 2}.norm.weight"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
        sb[f"blocks.{3 * i + 2}.norm.bias"] = rng.normal(size=ch).astype(np.float32) * 0.1
        sb[f"blocks.{3 * i + 2}.norm.running_mean"] = rng.normal(size=ch).astype(np.float32)
        sb[f"blocks.{3 * i + 2}.norm.running_var"] = rng.uniform(0.5, 2.0, ch).astype(np.float32)
    sb["blocks.16.w.weight"] = rng.normal(size=(512, 3000)).astype(np.float32) * 0.02
    sb["blocks.16.w.bias"] = rng.normal(size=512).astype(np.float32) * 0.1
    sd = pxv.xvector_from_speechbrain({k: torch.from_numpy(v) for k, v in sb.items()})
    jv = jxv.xvector_from_speechbrain(sb)
    want = xvector_params_from_flax(jv["params"], jv["batch_stats"])
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)
    back = pxv.xvector_to_speechbrain(sd)
    jback = jxv.xvector_to_speechbrain(jv)
    assert set(back) == set(jback) == set(sb)
    for k in jback:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]), err_msg=k)
    pnet = pxv.XVector()
    pnet.load_state_dict(sd)
    pnet.eval()
    x = rng.normal(size=(2, 30, 24)).astype(np.float32)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x)).numpy()
    jp = jax.tree.map(jnp.asarray, jv)
    np.testing.assert_allclose(got, np.asarray(jxv.XVector().apply(jp, jnp.asarray(x))), atol=1e-4, rtol=1e-5)


def write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_xvector_corpus(tmp_path_factory.mktemp("xvector_port"))


def write_xvector_corpus(root):
    """16 one-second tones in noise (12 Train, 4 Development, 8 classes) and
    their label CSV. Whole seconds leave no padding frames in a batch: padded
    frames reach the fbank at -80 dB under the row's peak and take over the
    first BatchNorm's moments (a variance near 1e3); and a pure tone repeats
    one frame, so a ReLU whose input sits near 0 on that frame flips on
    every frame at once with the fbank's last bit. Either way one package's
    f32 rounding moves a gradient by percents, beyond what a two-epoch
    comparison can hold (the ragged case is held forward, above)."""
    (root / "audio").mkdir()
    lines = [",".join(["FileName"] + CLASSES + ["Split_Set"])]
    for i in range(16):
        cls = i % 8
        name = f"MSP-PODCAST_{i:03d}.wav"
        noise = 0.1 * np.random.default_rng(i).standard_normal(16000)
        write_wav(root / "audio" / name, 0.2 * np.sin(np.arange(16000) * (0.05 + 0.02 * cls)) + noise)
        lines.append(",".join([name] + [str(float(c == cls)) for c in range(8)]
                              + ["Train" if i < 12 else "Development"]))
    (root / "labels.csv").write_text("\n".join(lines) + "\n")
    return root


def engines(seed=3, last_batch=False):
    je = JaxXVectorEngine(head_dim=16, seed=seed, last_batch_dev_loss=last_batch, n_devices=1)
    je.head = jbmodels.EmotionRegression(512, 16, 1, 8, dropout=0.0)  # the same params, no dropout
    pe = XVectorEngine(head_dim=16, seed=seed, last_batch_dev_loss=last_batch, device="cpu")
    pe.xvector.load_state_dict(xvector_params_from_flax(np_tree(je.xv_params), np_tree(je.xv_stats)))
    pe.head.load_state_dict(emotion_regression_params_from_flax(np_tree(je.head_params)))
    pe.generator = None
    return je, pe


def port_state(pe):
    return {**{f"xv.{k}": v for k, v in pe.xvector.state_dict().items()},
            **{f"head.{k}": v for k, v in pe.head.state_dict().items()}}


def jax_state(je):
    return {**{f"xv.{k}": v for k, v in xvector_params_from_flax(np_tree(je.xv_params), np_tree(je.xv_stats)).items()},
            **{f"head.{k}": v for k, v in emotion_regression_params_from_flax(np_tree(je.head_params)).items()}}


@pytest.mark.parametrize("last_batch", [False, True])
def test_xvector_engine_two_epochs_match_jax(corpus, tmp_path, last_batch):
    """Two epochs at batch 4 in micro-batches of 2 (BatchNorm moments over each
    micro-batch, the padded row of none here), the joint AdamW: the
    parameters and running statistics within 1e-5 (Adam's noise-floor steps
    aside), every epoch's dev loss (the full dev set's, or the last 8 rows'
    with ``last_batch_dev_loss``) within 1e-5, the best epoch equal and
    ``final_xvector.pt`` / ``final_ser.pt`` with the same keys and values."""
    je, pe = engines(last_batch=last_batch)
    losses = {"jax": [], "port": []}
    for name, eng in (("jax", je), ("port", pe)):
        real = eng.evaluate
        eng.evaluate = lambda ds, cw=None, _r=real, _n=name: (lambda res: losses[_n].append(res["loss"]) or res)(
            _r(ds, cw))
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "audio"), batch_size=4,
              accumulation_steps=2, epochs=2, lr=1e-4)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **kw)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **kw)
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-5, rtol=0)
    assert pbest["epoch"] == jbest["epoch"] and pbest["dev_losses"] == losses["port"]
    steps = 2 * 3
    assert_adam_close(port_state(pe), jax_state(je), steps, 1e-4, share=0.02)
    for name in ("final_xvector.pt", "final_ser.pt", "train_norm_stat.pkl"):
        assert (tmp_path / "jax" / name).exists() and (tmp_path / "port" / name).exists(), name
    for name in ("final_xvector.pt", "final_ser.pt"):
        j = torch.load(tmp_path / "jax" / name, weights_only=True)
        p = torch.load(tmp_path / "port" / name, weights_only=True)
        assert_adam_close(p, j, steps, 1e-4, share=0.02)
    reloaded = XVectorEngine(head_dim=16, device="cpu")
    reloaded.load_checkpoints(str(tmp_path / "port"))
    from interspeech_ser_tpu_torch.baseline.engine import labelled_split

    dev = labelled_split("cat", str(corpus / "labels.csv"), str(corpus / "audio"), "dev",
                         *pe_norm(tmp_path / "port"))
    np.testing.assert_allclose(reloaded.predict(dev), pbest["dev_preds"], atol=1e-6, rtol=0)


def pe_norm(model_path):
    from interspeech_ser_tpu_torch.baseline.data import load_norm_stat

    return load_norm_stat(os.path.join(model_path, "train_norm_stat.pkl"))


def test_xvector_engine_balanced_batches_and_devices(corpus, tmp_path):
    """``use_balanced_batch``: the same rows drawn as JAX (one epoch, dev loss
    within 1e-5); ``n_devices`` above 1 raises in a one-process run; without a
    card the default device raises."""
    je, pe = engines(seed=4)
    kw = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "audio"), batch_size=4,
              accumulation_steps=1, epochs=1, lr=1e-4, use_balanced_batch=True)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **kw)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **kw)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5
    with pytest.raises(ValueError, match="n_devices=2, but this run has 1 rank"):
        XVectorEngine(n_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            XVectorEngine()
    assert json.dumps(pbest["dev_losses"])
