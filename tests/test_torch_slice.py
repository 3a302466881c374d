"""The serving slice end to end, JAX CLIs against the port's CLIs.

1. ``preprocess_cli.speech_main`` of both packages over one synthetic wav
   dir and one HF WavLM dir: every ``.pt`` has the same shape, cosine >=
   0.9999 and max-abs <= 5e-4 (the bar of tests/test_extraction.py).
2. ``eval_main`` / ``test_main`` of both packages over those features plus
   synthetic text features, with a small-dim copy of
   ``configs/config_cat_bimodal_lazy_lr1e4_head1.json`` and one checkpoint
   written by the JAX ``FusionEngine``: identical headers, filenames and
   ``Prediction`` columns, logits within 2e-4 (two 4-decimal roundings).
"""

import csv
import json
import os
import wave

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_CPU = ["--device", "cpu"]  # the port's entry points run on the card unless asked
torch.set_num_threads(2)


def _write_wav(path, samples, sr=16000):
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """wav dir + HF WavLM dir -> .pt dirs from the JAX and the port CLIs."""
    from transformers import WavLMConfig, WavLMModel

    from interspeech_ser_tpu import preprocess_cli as jax_cli
    from interspeech_ser_tpu_torch import preprocess_cli as port_cli

    root = tmp_path_factory.mktemp("slice")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(9)
    for i, n in enumerate([4000, 7000, 9500, 12000, 3000]):
        _write_wav(str(wav_dir / f"utt{i}.wav"), rng.normal(size=n) * 0.1)
    torch.manual_seed(2)
    hf_cfg = WavLMConfig(
        hidden_size=48, num_hidden_layers=3, num_attention_heads=4, intermediate_size=96,
        conv_dim=[16, 16, 16], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
        num_feat_extract_layers=3, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=32, max_bucket_distance=64, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
    )
    model_dir = root / "hf_wavlm"
    WavLMModel(hf_cfg).eval().save_pretrained(str(model_dir))
    dirs = {}
    for name, main, extra in (("jax", jax_cli.speech_main, []), ("port", port_cli.speech_main, PORT_CPU)):
        dirs[name] = str(root / f"feats_{name}")
        stats = main(["--ssl_type", str(model_dir), "--wav_dir", str(wav_dir), "--save_path", dirs[name], *extra])
        assert stats.n_utts == 5 and stats.n_failed == 0
    return root, dirs


def test_extraction_pt_files_match(extracted):
    _, dirs = extracted
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 5
    for f in names:
        ref = torch.load(os.path.join(dirs["jax"], f), weights_only=True).numpy()
        ours = torch.load(os.path.join(dirs["port"], f), weights_only=True)
        assert ours.dtype == torch.float32 and ours.is_contiguous()
        ours = ours.numpy()
        assert ours.shape == ref.shape
        cos = np.sum(ours * ref) / (np.linalg.norm(ours) * np.linalg.norm(ref))
        assert cos >= 0.9999, f"{f}: cosine {cos}"
        np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=0)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_scoring_csvs_match(extracted, tmp_path):
    from interspeech_ser_tpu import cli as jax_cli
    from interspeech_ser_tpu.train.engine import FusionEngine as JaxEngine
    from interspeech_ser_tpu.utils.config import load_fusion_config as jax_load_config
    from interspeech_ser_tpu.utils.labels import CLASSES
    from interspeech_ser_tpu_torch import cli as port_cli

    _, dirs = extracted
    names = [f.replace(".pt", ".wav") for f in sorted(os.listdir(dirs["jax"]))]
    rng = np.random.default_rng(21)
    txt_dir = tmp_path / "text"
    txt_dir.mkdir()
    for n in names:
        feats = rng.standard_normal((int(rng.integers(5, 13)), 24)).astype(np.float32)
        torch.save(torch.from_numpy(feats), str(txt_dir / n.replace(".wav", ".pt")))
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["FileName"] + CLASSES + ["Split_Set"])
        for i, n in enumerate(names):
            w.writerow([n] + [float(c == (3 * i) % 8) for c in range(8)] + ["Development" if i != 2 else "Train"])
    transcripts = tmp_path / "transcripts.csv"
    with open(transcripts, "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[n, f"text {n}"] for n in names])
    test_csv = tmp_path / "test.csv"
    with open(test_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName"]] + [[n] for n in reversed(names)])
    with open(os.path.join(ROOT, "configs", "config_cat_bimodal_lazy_lr1e4_head1.json")) as f:
        cfg = json.load(f)
    cfg.update(
        txt_dir=str(transcripts), lazy_dir1=dirs["jax"], lazy_dir2=str(txt_dir),
        label_path=str(labels), feat1_dim=48, feat2_dim=24, fusion_hidden_dim=16,
        batch_size=2, model_path=str(tmp_path / "exp"),
    )
    config_path = str(tmp_path / "config.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    engine = JaxEngine(jax_load_config(config_path), seed=3)
    engine.init_params()
    os.makedirs(cfg["model_path"])
    engine.save_torch_checkpoint(os.path.join(cfg["model_path"], "multimodal_ser.pt"))

    outs = {}
    for name, mod, extra in (("jax", jax_cli, []), ("port", port_cli, PORT_CPU)):
        dev = _read(mod.eval_main(argv=["--config_path", config_path, *extra]))
        test = _read(mod.test_main(argv=["--config_path", config_path, "--test_df", str(test_csv), *extra]))
        outs[name] = (dev, test)
    for (ref, ours), header in zip(zip(outs["jax"], outs["port"]), ("Filename", "FileName")):
        assert ours[0] == ref[0] and ours[0][0] == header
        assert [r[:2] for r in ours] == [r[:2] for r in ref]  # filenames and Prediction
        assert all(len(v.split(".")[1]) == 4 for r in ours[1:] for v in r[2:])
        np.testing.assert_allclose(
            np.asarray([r[2:] for r in ours[1:]], float), np.asarray([r[2:] for r in ref[1:]], float),
            atol=2e-4, rtol=0,
        )
    assert len(outs["port"][0]) == 1 + 4 and len(outs["port"][1]) == 1 + 5


@pytest.mark.parametrize(
    "flags",
    [["--use_average", "y"], ["--n_layer", "1"], ["--replicate_dir_count_bug"]],
    ids=["mean_last4", "n_layer1", "dir_count_bug"],
)
def test_layer_selection_flags_match_jax(extracted, tmp_path, flags):
    """Layer selection through both CLIs; the dir-count quirk reads
    hidden_states[number of files already in save_path] (2 junk files)."""
    from interspeech_ser_tpu import preprocess_cli as jax_cli
    from interspeech_ser_tpu_torch import preprocess_cli as port_cli

    root, _ = extracted
    saves = {}
    for name, main, extra in (("jax", jax_cli.speech_main, []), ("port", port_cli.speech_main, PORT_CPU)):
        saves[name] = str(tmp_path / name)
        os.makedirs(saves[name])
        if "--replicate_dir_count_bug" in flags:
            for junk in ("junk1", "junk2"):
                open(os.path.join(saves[name], junk), "w").close()
        main(["--ssl_type", str(root / "hf_wavlm"), "--wav_dir", str(root / "wavs"),
              "--save_path", saves[name], *flags, *extra])
    for f in sorted(p for p in os.listdir(saves["jax"]) if p.endswith(".pt")):
        ref = torch.load(os.path.join(saves["jax"], f), weights_only=True).numpy()
        ours = torch.load(os.path.join(saves["port"], f), weights_only=True).numpy()
        np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=0)


def test_multi_batch_and_skip_existing(extracted, tmp_path, monkeypatch):
    """A token budget of 1 s per batch (one utterance per batch) gives the
    same files as one batch; SER_TPU_SKIP_EXISTING=1 recomputes only what
    is missing."""
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder

    root, dirs = extracted
    model, cfg, do_norm = build_speech_encoder(str(root / "hf_wavlm"))
    pipe = SpeechExtractionPipeline(model, cfg, do_normalize=do_norm, token_budget=16000,
                                    num_workers=2, device="cpu")
    save = str(tmp_path / "small_batches")
    stats = pipe.run(str(root / "wavs"), save)
    assert stats.n_batches == 5 and stats.n_utts == 5
    for f in sorted(os.listdir(dirs["port"])):
        torch.testing.assert_close(torch.load(os.path.join(save, f), weights_only=True),
                                   torch.load(os.path.join(dirs["port"], f), weights_only=True),
                                   atol=1e-5, rtol=0)
    os.remove(os.path.join(save, "utt3.pt"))
    monkeypatch.setenv("SER_TPU_SKIP_EXISTING", "1")
    stats = pipe.run(str(root / "wavs"), save)
    assert stats.n_skipped == 4 and stats.n_utts == 1 and os.path.exists(os.path.join(save, "utt3.pt"))
