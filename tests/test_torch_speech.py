"""The port's WavLM-style encoder against the JAX ``SpeechEncoderModel`` and
against HF ``WavLMModel`` (transformers is used by this test only).

Small WavLM config: stable LN, layer-norm frontend, 2 layers, D=48, 4 heads,
3 conv layers, 32 buckets. One flax init feeds both packages through
``speech_params_from_flax``. f32 tolerance 1e-4 max-abs over every hidden
state: the two stacks run the same math with other summation orders (and
flax's LayerNorm uses E[x²]-E[x]², torch's a two-pass variance).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.speech import SpeechConfig as JaxSpeechConfig
from interspeech_ser_tpu.models.speech import SpeechEncoderModel as JaxSpeechEncoderModel
from interspeech_ser_tpu_torch.models.convert import speech_params_from_flax
from interspeech_ser_tpu_torch.models.loader import build_speech_encoder, load_safetensors
from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel, feat_extract_output_length

torch.set_num_threads(2)

SMALL = dict(
    hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96, conv_dim=(16, 16, 16),
    conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), conv_bias=True, feat_extract_norm="layer",
    do_stable_layer_norm=True, attention_type="wavlm", num_buckets=32, max_distance=64,
    num_conv_pos_embeddings=16, conv_pos_groups=4,
)
LENGTHS = (4000, 2500)


@pytest.fixture(scope="module")
def carried():
    """(jax model, flax params, port model) from one flax init."""
    jcfg = JaxSpeechConfig(**SMALL)
    jmodel = JaxSpeechEncoderModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)), jnp.ones((1, 4000)))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = SpeechConfig(**SMALL)
    model = SpeechEncoderModel(cfg).eval()
    model.load_state_dict(speech_params_from_flax(params, cfg), strict=True)
    return jmodel, params, model


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    L = max(LENGTHS)
    wav = np.zeros((len(LENGTHS), L), np.float32)
    mask = np.zeros_like(wav)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = rng.standard_normal(n)
        mask[i, :n] = 1.0
    return wav, mask


def test_every_hidden_state_matches_jax_f32(carried):
    jmodel, params, model = carried
    wav, mask = _batch()
    ref = jmodel.apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(wav), torch.from_numpy(mask))
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == SMALL["num_layers"] + 1
    np.testing.assert_array_equal(out["frame_mask"].numpy(), np.asarray(ref["frame_mask"]))
    for ours, theirs in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)


def test_batched_padded_equals_batch1(carried):
    _, _, model = carried
    wav, mask = _batch(6)
    with torch.no_grad():
        batched = model(torch.from_numpy(wav), torch.from_numpy(mask))["last_hidden_state"]
        for i, n in enumerate(LENGTHS):
            single = model(torch.from_numpy(wav[i : i + 1, :n]))["last_hidden_state"][0]
            t = feat_extract_output_length(n, model.config)
            assert single.shape[0] == t
            torch.testing.assert_close(batched[i, :t], single, atol=1e-5, rtol=0)


def test_keep_selects_hidden_states(carried):
    _, _, model = carried
    wav, mask = _batch(7)
    with torch.no_grad():
        full = model(torch.from_numpy(wav), torch.from_numpy(mask))["hidden_states"]
        part = model(torch.from_numpy(wav), torch.from_numpy(mask), keep=(1, -1))["hidden_states"]
    assert part[0] is None and part[1] is not None and part[-1] is not None
    torch.testing.assert_close(part[1], full[1], rtol=0, atol=0)
    torch.testing.assert_close(part[-1], full[-1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One random HF WavLM saved as safetensors and as pytorch_model.bin."""
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(2)
    hf_cfg = WavLMConfig(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
        conv_dim=[16, 16, 16], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
        num_feat_extract_layers=3, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=32, max_bucket_distance=64, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
    )
    hf = WavLMModel(hf_cfg).eval()
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"hf_wavlm_{fmt}")
        hf.save_pretrained(str(d), safe_serialization=safe)
        dirs[fmt] = str(d)
    return dirs, hf


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_loader_matches_hf_wavlm(hf_dirs, fmt):
    dirs, hf = hf_dirs
    expected = "model.safetensors" if fmt == "safetensors" else "pytorch_model.bin"
    assert os.path.exists(os.path.join(dirs[fmt], expected))
    model, cfg, do_normalize = build_speech_encoder(dirs[fmt])
    assert do_normalize and cfg.attention_type == "wavlm" and cfg.num_buckets == 32
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 5000)).astype(np.float32))
    with torch.no_grad():
        ref = hf(x, output_hidden_states=True)
        out = model(x)
    torch.testing.assert_close(out["last_hidden_state"], ref.last_hidden_state, atol=1e-4, rtol=0)
    for ours, theirs in zip(out["hidden_states"], ref.hidden_states):
        torch.testing.assert_close(ours, theirs, atol=1e-4, rtol=0)


def test_loader_folds_legacy_weight_norm_names(hf_dirs, tmp_path):
    """Older HF checkpoints name the pos conv's weight norm ``weight_g`` /
    ``weight_v``; the loader folds either naming to the same kernel."""
    import shutil

    dirs, hf = hf_dirs
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    shutil.copy(os.path.join(dirs["bin"], "config.json"), legacy / "config.json")
    sd = torch.load(os.path.join(dirs["bin"], "pytorch_model.bin"), weights_only=True)
    prefix = "encoder.pos_conv_embed.conv."
    sd = {k.replace("parametrizations.weight.original0", "weight_g")
           .replace("parametrizations.weight.original1", "weight_v") if k.startswith(prefix) else k: v
          for k, v in sd.items()}
    assert prefix + "weight_g" in sd
    torch.save({f"wavlm.{k}": v for k, v in sd.items()}, legacy / "pytorch_model.bin")
    new, _, _ = build_speech_encoder(dirs["bin"])
    old, _, _ = build_speech_encoder(str(legacy))
    for (k, a), (k2, b) in zip(new.state_dict().items(), old.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_safetensors_reader_matches_package(hf_dirs, tmp_path):
    from safetensors.torch import load_file, save_file

    dirs, _ = hf_dirs
    path = os.path.join(dirs["safetensors"], "model.safetensors")
    ours, theirs = load_safetensors(path), load_file(path)
    assert ours.keys() == theirs.keys()
    for k in ours:
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    mixed = {"a": torch.arange(6, dtype=torch.int64).reshape(2, 3),
             "b": torch.randn(4).to(torch.bfloat16), "empty": torch.zeros(0)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"), metadata={"format": "pt"})
    got = load_safetensors(str(tmp_path / "mixed.safetensors"))
    for k, v in mixed.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_config_round_trips_hf_json(hf_dirs):
    dirs, _ = hf_dirs
    with open(os.path.join(dirs["bin"], "config.json")) as f:
        cfg = SpeechConfig.from_hf(json.load(f))
    assert SpeechConfig.from_hf(cfg.to_hf()) == cfg
