"""The port's LoRA fine-tune against the JAX package: the merge, peft
parsing, the checkpoint in both directions, one train step (loss and every
gradient) for Whisper and WavLM, the batch order and the plateau scheduler,
and the CLI chain ft_lora -> *_pretrained extraction. Also the JAX
package's ``xla`` route values (``SER_TPU_ATTN_IMPL``, ``SER_TPU_FRONTEND``)
on the speech path.

Tiny HF directories written by transformers (used by this test only):
Whisper 2 layers, D=128, 2 heads, 16 mels; WavLM 2 layers, D=128, 2 heads,
2 conv layers; a HuBERT-XL-shaped HubertModel (D=160 over 2 heads: head
dim 80) and an XLS-R-2B-shaped Wav2Vec2Model (D=240 over 2 heads: head dim
120), both with stable layer norm, 2 layers and 2 conv layers. Both engines load the same directory; the LoRA factors (B
drawn non-zero, so that A gets a gradient) and the head are carried from
the JAX engine to the port. Bars: merged weights within 1e-6 (one rank-r
product in f32); the train step's loss and gradients within 1e-5 relative
to the largest magnitude of each tensor (same math, other summation
orders, through an encoder and a log-mel); extracted files within 1e-4 as
in tests/test_torch_whisper.py.
"""

import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models import lora as jlora
from interspeech_ser_tpu.train import losses as jlosses
from interspeech_ser_tpu.train.lora_engine import LoRAFTEngine as JaxEngine
from interspeech_ser_tpu.train.lora_engine import ReduceLROnPlateau as JaxPlateau
from interspeech_ser_tpu.utils.seeding import numpy_generator as jax_numpy_generator
from interspeech_ser_tpu_torch.models import lora
from interspeech_ser_tpu_torch.models.convert import whisper_params_from_flax
from interspeech_ser_tpu_torch.train.lora_engine import LoRAFTEngine, ReduceLROnPlateau, pad_batch, uar

torch.set_num_threads(2)

RNG = np.random.default_rng(21)


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """HF Whisper and WavLM directories, 8 wavs, a label CSV (6 Train, 2 Development)."""
    from transformers import (HubertConfig, HubertModel, Wav2Vec2Config, Wav2Vec2Model, WavLMConfig, WavLMModel,
                              WhisperConfig, WhisperModel)

    root = tmp_path_factory.mktemp("lora_port")
    torch.manual_seed(9)
    WhisperModel(WhisperConfig(
        num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=256,
        decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=64, max_source_positions=1500,
    )).encoder.save_pretrained(str(root / "whisper"))
    WavLMModel(WavLMConfig(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
        conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2], num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32,
        max_bucket_distance=64, do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True,
        layerdrop=0.0,
    )).save_pretrained(str(root / "wavlm"))
    zoo = dict(num_hidden_layers=2, num_attention_heads=2, conv_dim=[16, 16], conv_kernel=[10, 3],
               conv_stride=[5, 2], num_feat_extract_layers=2, num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4, do_stable_layer_norm=True, feat_extract_norm="layer",
               conv_bias=True, layerdrop=0.0)
    HubertModel(HubertConfig(hidden_size=160, intermediate_size=320, **zoo)).save_pretrained(str(root / "hubert_xl"))
    Wav2Vec2Model(Wav2Vec2Config(hidden_size=240, intermediate_size=480, **zoo)).save_pretrained(str(root / "xlsr_2b"))
    (root / "wavs").mkdir()
    wavs, labels, rows = [], [], []
    for i in range(8):
        cls = i % 2
        w = (0.3 * np.sin(np.arange(3200 + 320 * i) * (0.05 + 0.1 * cls))).astype(np.float32)
        _write_wav(root / "wavs" / f"u{i:02d}.wav", w)
        wavs.append(w)
        labels.append(cls)
        onehot = [float(c == cls) for c in range(8)]
        rows.append(",".join([f"u{i:02d}.wav", *map(str, onehot), "Train" if i < 6 else "Development"]))
    header = "FileName,Angry,Sad,Happy,Surprise,Fear,Disgust,Contempt,Neutral,Split_Set"
    (root / "labels.csv").write_text("\n".join([header, *rows]) + "\n")
    return root, wavs, np.asarray(labels)


def _perturbed_jax_engine(path, seed=0, **kw):
    """A JAX engine whose LoRA B factors are non-zero (A then gets a gradient)."""
    je = JaxEngine(path, rank=2, num_emotions=4, **kw)
    rng = np.random.default_rng(seed)
    je.lora = jax.tree.map(
        lambda x: np.asarray(x) if x.shape[0] != 2 else rng.normal(0, 0.05, x.shape).astype(np.float32), je.lora
    )
    return je


def _carry(je, pe):
    """The JAX engine's factors and head into the port's engine."""
    pe._set_lora(lora.lora_from_state_dict(jlora.lora_state_dict(je.lora)))
    with torch.no_grad():
        for fc in ("fc1", "fc2"):
            getattr(pe.head, fc).weight.copy_(torch.tensor(np.asarray(je.head_params[fc]["kernel"]).T))
            getattr(pe.head, fc).bias.copy_(torch.tensor(np.asarray(je.head_params[fc]["bias"])))


def test_merge_matches_jax():
    W = RNG.normal(size=(24, 32)).astype(np.float32)  # flax [in, out]
    A = RNG.normal(size=(24, 4)).astype(np.float32)
    B = RNG.normal(size=(4, 32)).astype(np.float32)
    want = jlora.merge_lora({"layer0": {"self_attn": {"q_proj": {"kernel": jnp.asarray(W)}}}},
                            {"layer0": {"self_attn": {"q_proj": {"kernel": {"lora_A": A, "lora_B": B}}}}},
                            alpha=16, rank=4)["layer0"]["self_attn"]["q_proj"]["kernel"]
    sd = {"layers.0.self_attn.q_proj.weight": torch.from_numpy(W.T.copy()), "layers.0.fc1.weight": torch.ones(2, 2)}
    got = lora.merge_lora(sd, {"layer0.self_attn.q_proj.kernel": {"lora_A": torch.from_numpy(A),
                                                                   "lora_B": torch.from_numpy(B)}}, 16, 4)
    np.testing.assert_allclose(got["layers.0.self_attn.q_proj.weight"].numpy(), np.asarray(want).T, atol=1e-6, rtol=0)
    assert got["layers.0.fc1.weight"] is sd["layers.0.fc1.weight"]


def test_peft_parsing_matches_jax():
    sd = {}
    for proj in ("q_proj", "v_proj"):
        for prefix in ("wavlm.base_model.model.encoder.layers.3.attention", "base_model.model.encoder.layers.1.self_attn"):
            sd[f"{prefix}.{proj}.lora_A.default.weight"] = RNG.normal(size=(4, 16)).astype(np.float32)
            sd[f"{prefix}.{proj}.lora_B.default.weight"] = RNG.normal(size=(16, 4)).astype(np.float32)
    sd["classifier.weight"] = np.zeros((2, 2), np.float32)
    want = jlora.lora_from_peft_state_dict(sd)
    got = lora.lora_from_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()})
    flat = {"/".join(str(p.key) for p in path): np.asarray(x) for path, x in jax.tree_util.tree_leaves_with_path(want)}
    assert len(flat) == 8
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        np.testing.assert_array_equal(got[".".join(path)][leaf].numpy(), arr)


@pytest.mark.parametrize("kind,target", [("whisper", "qv"), ("wavlm", "qv"), ("wavlm", "ffn")])
def test_init_targets_the_jax_paths(dirs, kind, target):
    root, _, _ = dirs
    je = JaxEngine(str(root / kind), rank=2, num_emotions=4, target=target)
    pe = LoRAFTEngine(str(root / kind), rank=2, num_emotions=4, target=target, device="cpu")
    want = {k: np.asarray(v).shape for k, v in jlora.lora_state_dict(je.lora).items()}
    got = {k: tuple(v.shape) for k, v in lora.lora_state_dict(pe.lora).items()}
    assert got == want and len(got) == 8
    assert all(float(v.abs().max()) == 0 for k, v in lora.lora_state_dict(pe.lora).items() if k.endswith("lora_B"))


def test_checkpoint_loads_both_ways(dirs, tmp_path):
    """A checkpoint saved by the JAX engine loads into the port and one saved
    by the port loads into JAX, giving the same merged weights and head."""
    root, _, _ = dirs
    path = str(root / "whisper")
    je = _perturbed_jax_engine(path)
    je.save(str(tmp_path / "jax.pt"))
    pe = LoRAFTEngine(path, rank=2, num_emotions=4, seed=3, device="cpu")
    pe.load(str(tmp_path / "jax.pt"))
    want = whisper_params_from_flax(jax.tree.map(np.asarray, je.merged_backbone_params()), je.cfg)
    got = pe.merged_backbone_params()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)
    np.testing.assert_array_equal(pe.head.fc1.weight.detach().numpy().T, np.asarray(je.head_params["fc1"]["kernel"]))

    for pair in pe.lora.values():
        with torch.no_grad():
            pair["lora_B"].mul_(-2.0)
    pe.save(str(tmp_path / "port.pt"))
    je2 = JaxEngine(path, rank=2, num_emotions=4)
    je2.load(str(tmp_path / "port.pt"))
    want = whisper_params_from_flax(jax.tree.map(np.asarray, je2.merged_backbone_params()), je2.cfg)
    got = pe.merged_backbone_params()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)
    np.testing.assert_array_equal(np.asarray(je2.head_params["fc2"]["bias"]), pe.head.fc2.bias.detach().numpy())


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["whisper", "wavlm", "hubert_xl", "xlsr_2b"])
def test_one_train_step_matches_jax(dirs, kind, monkeypatch):
    """Loss and the gradient of every LoRA factor and head parameter of one
    step, head dropout off on both sides: the JAX engine's loss function under
    ``jax.value_and_grad`` against the port's ``loss(...).backward()``. The
    HuBERT-XL and XLS-R-2B shapes run attention at head dims 80 and 120,
    where the card's gradient comes from K4 at those widths."""
    root, wavs, _ = dirs
    path = str(root / kind)
    je = _perturbed_jax_engine(path, seed=1)
    pe = LoRAFTEngine(path, rank=2, num_emotions=4, device="cpu")
    _carry(je, pe)
    monkeypatch.setattr(pe.head, "dropout_p", 0.0)
    wav, mask = pad_batch([wavs[1], wavs[6], wavs[3]], 4)  # 4 rows: the last one padding
    y = np.array([1, 0, 3, 0])
    smask = np.array([1, 1, 1, 0], np.float32)
    cw = np.array([0.5, 1.5, 1.0, 2.0], np.float32)

    def loss_fn(t):
        logits = je._forward(jlora.freeze_base(je.base_params), t["lora"], t["head"], jnp.asarray(wav),
                             jnp.asarray(mask), True)
        return jlosses.weighted_cross_entropy(logits, jnp.asarray(y), jnp.asarray(cw), jnp.asarray(smask))

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))({"lora": je.lora, "head": je.head_params})
    loss = pe.loss(wav, mask, y, smask, cw)
    loss.backward()
    assert _rel(np.float32(loss.item()), np.asarray(want_loss)) <= 1e-5
    flat = jlora.lora_state_dict(want["lora"])
    assert len(flat) == 8
    for key, g in flat.items():
        path, _, leaf = key.rpartition(".")
        got = pe.lora[path][leaf].grad.numpy()
        assert float(np.abs(g).max()) > 0, key
        assert _rel(got, g) <= 1e-5, (key, _rel(got, g))
    for fc in ("fc1", "fc2"):
        lin = getattr(pe.head, fc)
        assert _rel(lin.weight.grad.numpy().T, np.asarray(want["head"][fc]["kernel"])) <= 1e-5, fc
        assert _rel(lin.bias.grad.numpy(), np.asarray(want["head"][fc]["bias"])) <= 1e-5, fc


def test_batch_order_and_plateau_match_jax(dirs):
    """The JAX engine's epoch order (numpy_generator(0).permutation per epoch),
    batches padded to whole 3200-sample multiples, the last batch padded with
    rows of weight 0, and the same learning rates from the plateau scheduler."""
    from interspeech_ser_tpu_torch.utils.seeding import numpy_generator

    _, wavs, labels = dirs
    ref, mine = jax_numpy_generator(0), numpy_generator(0)
    for _ in range(2):
        order = ref.permutation(len(wavs))
        batches = list(LoRAFTEngine.epoch_batches(wavs, labels, 3, mine))
        assert [list(b[0]) for b in batches] == [list(order[s: s + 3]) for s in range(0, 8, 3)]
        for idxs, wav, mask, y, smask in batches:
            L = -(-max(len(wavs[i]) for i in idxs) // 3200) * 3200
            assert wav.shape == mask.shape == (3, L) and y.tolist()[: len(idxs)] == labels[idxs].tolist()
            assert smask.tolist() == [1.0] * len(idxs) + [0.0] * (3 - len(idxs))
            assert mask.sum() == sum(len(wavs[i]) for i in idxs)
    metrics = [0.5, 0.4, 0.45, 0.41, 0.42, 0.39, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    a, b = ReduceLROnPlateau(5e-4), JaxPlateau(5e-4)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert uar([0, 0, 1, 2], [0, 1, 1, 1], 4) == pytest.approx((0.5 + 1.0 + 0.0) / 3)


def test_ffn_is_rejected_for_whisper_and_the_card_is_the_default(dirs):
    root, _, _ = dirs
    with pytest.raises(ValueError, match="ffn"):
        LoRAFTEngine(str(root / "whisper"), target="ffn", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            LoRAFTEngine(str(root / "whisper"))


def test_ft_lora_cli_feeds_both_pretrained_extractions(dirs, tmp_path):
    """The port's ft_lora on the CPU writes whisper_lora_ser.pt; the JAX
    package's and the port's whisper_pretrained_main extract the same
    features with it. Then the JAX engine's WavLM checkpoint through both
    speech_pretrained_main."""
    from interspeech_ser_tpu.preprocess_cli import speech_pretrained_main as jax_speech_pretrained
    from interspeech_ser_tpu.preprocess_cli import whisper_pretrained_main as jax_whisper_pretrained
    from interspeech_ser_tpu_torch import lora_cli
    from interspeech_ser_tpu_torch.preprocess_cli import speech_pretrained_main, whisper_pretrained_main

    root, _, _ = dirs
    res = lora_cli.main(["--ssl_type", str(root / "whisper"), "--label_path", str(root / "labels.csv"),
                         "--wav_dir", str(root / "wavs"), "--model_path", str(tmp_path / "exp"),
                         "--epochs", "1", "--batch_size", "4", "--lr", "5e-3", "--device", "cpu"])
    ckpt = res["checkpoint"]
    assert ckpt == str(tmp_path / "exp" / "whisper_lora_ser.pt")
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all() and len(res["history"]) == 1
    sd = torch.load(ckpt, weights_only=True)
    assert sd["classifier.fc1.kernel"].shape == (128, 512)
    assert any(float(v.abs().max()) > 0 for k, v in sd.items() if k.endswith("lora_B"))

    jax_ckpt = str(tmp_path / "wavlm_lora.pt")
    _perturbed_jax_engine(str(root / "wavlm"), seed=2).save(jax_ckpt)
    for kind, ck, jax_main, port_main in (("whisper", ckpt, jax_whisper_pretrained, whisper_pretrained_main),
                                          ("wavlm", jax_ckpt, jax_speech_pretrained, speech_pretrained_main)):
        flags = ["--ssl_type", str(root / kind), "--wav_dir", str(root / "wavs"), "--lora_ckpt", ck,
                 "--lora_rank", "2"]
        assert jax_main(flags + ["--save_path", str(tmp_path / f"jax_{kind}")]).n_utts == 8
        assert port_main(flags + ["--save_path", str(tmp_path / f"port_{kind}"), "--device", "cpu"]).n_utts == 8
        for name in sorted(os.listdir(tmp_path / f"jax_{kind}")):
            want = torch.load(tmp_path / f"jax_{kind}" / name, weights_only=True)
            got = torch.load(tmp_path / f"port_{kind}" / name, weights_only=True)
            assert got.shape == want.shape, (kind, name)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0, err_msg=f"{kind} {name}")


def _speech_attention_inputs(seed, D=160, Hh=2, T=23):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, T, D)).astype(np.float32) for _ in range(3))
    mask = (np.arange(T)[None] < np.array([T, 9])[:, None]).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (2, Hh, T)).astype(np.float32)
    bias = rng.standard_normal((Hh, T, T)).astype(np.float32)
    return q, k, v, mask, gate, bias


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on the card, to see where the dispatcher
    sends it (the kernels themselves are mocked)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("with_bias", [True, False])
def test_attn_impl_xla_routes_as_jax(with_bias, monkeypatch):
    """SER_TPU_ATTN_IMPL=xla: the [B, T, D] dispatcher runs the plain attention
    on heads, as the JAX package's XLA route does (hd 80, scale left to its
    default), on the CPU and for a card tensor that needs a gradient alike:
    neither K1 nor the K1 + K4 pair is reached."""
    from interspeech_ser_tpu.ops import attention_core as jcore
    from interspeech_ser_tpu_torch.ops import attention_core as core

    monkeypatch.setenv("SER_TPU_ATTN_IMPL", "xla")
    q, k, v, mask, gate, bias = _speech_attention_inputs(4)
    gate, bias = (gate, bias) if with_bias else (None, None)
    want = jcore.dot_product_attention_btd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                                           key_mask=jnp.asarray(mask),
                                           gate=None if gate is None else jnp.asarray(gate),
                                           shared_bias=None if bias is None else jnp.asarray(bias))
    t = {n: None if x is None else torch.from_numpy(x) for n, x in dict(q=q, k=k, v=v, gate=gate, bias=bias).items()}
    routes = []
    monkeypatch.setattr(core, "attention_btd", lambda *a, **kw: routes.append("k1"))
    monkeypatch.setattr(core.AttentionBtdTrain, "apply", lambda *a: routes.append("pair"))
    got = core.dot_product_attention_btd(t["q"], t["k"], t["v"], 2, key_mask=torch.from_numpy(mask),
                                         gate=t["gate"], shared_bias=t["bias"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    card = t["q"].as_subclass(_CudaLike).requires_grad_()
    out = core.dot_product_attention_btd(card, t["k"], t["v"], 2, key_mask=torch.from_numpy(mask),
                                         gate=t["gate"], shared_bias=t["bias"])
    out.sum().backward()
    assert routes == [] and card.grad is not None
    monkeypatch.delenv("SER_TPU_ATTN_IMPL")
    core.dot_product_attention_btd(card.detach(), t["k"], t["v"], 2)
    assert routes == ["k1"]  # the default route is unchanged


@pytest.mark.parametrize("bad", ["XLA", "oneshot2", "plain"])
def test_attn_impl_other_values_raise(bad, monkeypatch):
    from interspeech_ser_tpu_torch.ops import attention_core as core

    monkeypatch.setenv("SER_TPU_ATTN_IMPL", bad)
    x = torch.zeros(1, 4, 160)
    with pytest.raises(ValueError, match="SER_TPU_ATTN_IMPL"):
        core.dot_product_attention_btd(x, x, x, 2)
    with pytest.raises(ValueError, match="SER_TPU_ATTN_IMPL"):
        core.pick_impl(4)


@pytest.mark.parametrize("value", ["xla", "0"])
def test_frontend_xla_routes_as_jax(dirs, value, monkeypatch):
    """SER_TPU_FRONTEND=xla or 0: no K2, as the JAX package reads both; every
    conv layer runs the cuDNN route (here its CPU version), and the encoder
    still matches the JAX one under the same setting."""
    from interspeech_ser_tpu.models import speech as jspeech
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder

    root, wavs, _ = dirs
    monkeypatch.setenv("SER_TPU_FRONTEND", value)
    model, cfg, _ = build_speech_encoder(str(root / "hubert_xl"))
    assert speech.default_fused_frontend(cfg) == jspeech.default_fused_frontend(cfg) == 0
    assert model.fused_frontend == 0
    monkeypatch.setattr(speech, "conv_frontend", lambda *a, **kw: pytest.fail("K2 ran under SER_TPU_FRONTEND=" + value))
    monkeypatch.setattr(speech, "conv_frontend_plain", lambda *a, **kw: pytest.fail("K2 ran"))
    wav = torch.from_numpy(wavs[3][None])
    with torch.no_grad():
        out = model(wav)["last_hidden_state"]
    assert out.shape[-1] == 160 and torch.isfinite(out).all()
