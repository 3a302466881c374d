"""``transcribe_cli`` against the JAX package's ``test/whisper_transcriptions.py``.

A tiny HF ``WhisperForConditionalGeneration`` directory written by
transformers (encoder D=64 over 2 layers, 16 mels, its convs and linears
re-drawn N(0, 1/fan_in) from a numpy seed so that its output depends on the
audio; decoder D=64 over 2 layers with tests/test_torch_whisper_decoder.py's
seeded weights, so that its greedy tokens vary), the synthetic
Whisper-large-v3-layout tokenizer of ``chip_smoke.write_whisper_tokenizer``
(2,000 BPE tokens, then the 1,609 added ones) and
``chip_smoke.whisper_generation_config`` (a forced 4-token prompt,
suppressed ids, here the timestamps too, which would otherwise take most
greedy picks of a random decoder); 5 seeded 16-kHz wavs, one of 31 s;
``--batch_size 2 --max_new_tokens 12``. Bar: the two CSVs byte-equal in f32.
"""

import json
import os
import sys
import wave

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "test"))
torch.set_num_threads(2)

N_REGULAR = 2000


def _write_wav(path, x, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    import chip_smoke
    from test_torch_whisper_decoder import seeded_state_dict
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    from interspeech_ser_tpu_torch.models.whisper_decoder import WhisperDecoderConfig
    from interspeech_ser_tpu_torch.utils.whisper_tokenizer import TIMESTAMP_PAT

    root = tmp_path_factory.mktemp("transcribe")
    model_dir = root / "whisper"
    ids = chip_smoke.write_whisper_tokenizer(str(model_dir), n_regular=N_REGULAR)
    gen = chip_smoke.whisper_generation_config(ids, N_REGULAR, n_suppress=20)
    gen["suppress_tokens"] += [i for t, i in ids.items() if TIMESTAMP_PAT.fullmatch(t)]
    vocab = N_REGULAR + len(ids)
    eot = ids["<|endoftext|>"]
    hf = WhisperConfig(vocab_size=vocab, num_mel_bins=16, d_model=64, encoder_layers=2, encoder_attention_heads=2,
                       encoder_ffn_dim=128, decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=128,
                       max_source_positions=1500, max_target_positions=448, pad_token_id=eot, bos_token_id=eot,
                       eos_token_id=eot, decoder_start_token_id=gen["decoder_start_token_id"],
                       suppress_tokens=None, begin_suppress_tokens=None)
    torch.manual_seed(3)
    model = WhisperForConditionalGeneration(hf).eval()
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name, p in model.model.encoder.named_parameters():
            if name.endswith("weight") and p.dim() > 1 and "embed" not in name:
                fan_in = p[0].numel()
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) / np.sqrt(fan_in)))
    dec_cfg = WhisperDecoderConfig(vocab_size=vocab, d_model=64, decoder_layers=2, decoder_attention_heads=2,
                                   decoder_ffn_dim=128)
    model.model.decoder.load_state_dict(seeded_state_dict(dec_cfg, seed=8), strict=True)
    model.save_pretrained(str(model_dir))
    with open(model_dir / "generation_config.json", "w") as f:
        json.dump(gen, f)
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(6)
    for i, sec in enumerate((1.2, 0.7, 31.0, 2.1, 0.4)):
        t = np.arange(int(sec * 16000)) / 16000
        _write_wav(wav_dir / f"utt{i}.wav", 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                   + 0.05 * rng.standard_normal(len(t)))
    return model_dir, wav_dir, ids, gen


def test_csv_byte_equal_to_the_jax_script(whisper_dir, tmp_path):
    import whisper_transcriptions

    from interspeech_ser_tpu_torch import transcribe_cli

    model_dir, wav_dir, ids, gen = whisper_dir
    flags = ["--model", str(model_dir), "--wav_dir", str(wav_dir), "--batch_size", "2", "--max_new_tokens", "12"]
    whisper_transcriptions.main(flags + ["--out_csv", str(tmp_path / "jax.csv")])
    stats = transcribe_cli.main(flags + ["--out_csv", str(tmp_path / "port.csv"), "--device", "cpu"])
    want = (tmp_path / "jax.csv").read_bytes()
    got = (tmp_path / "port.csv").read_bytes()
    assert got == want, (got, want)
    assert stats.n_utts == 5 and stats.n_batches == 3 and [r[0] for r in stats.rows] == sorted(os.listdir(wav_dir))
    P = len(stats.prompt_ids)
    assert stats.prompt_ids == [gen["decoder_start_token_id"]] + [t for _, t in gen["forced_decoder_ids"]] and P == 4
    new = np.concatenate(stats.tokens)[:5, P:]
    assert len(np.unique(new)) > 3 and not np.isin(new, gen["suppress_tokens"]).any()
    texts = [r[1] for r in stats.rows]
    assert all(texts) and len(set(texts)) > 1  # text came out, and it depends on the audio


def test_null_forced_id_raises(whisper_dir, tmp_path):
    """A ``null`` forced id (the language left to detection): the JAX script
    fails at ``int(None)``; the port refuses it up front, naming the file."""
    import shutil

    from interspeech_ser_tpu_torch import transcribe_cli

    model_dir, wav_dir, ids, gen = whisper_dir
    d = tmp_path / "null"
    shutil.copytree(model_dir, d)
    with open(d / "generation_config.json", "w") as f:
        json.dump({**gen, "forced_decoder_ids": [[1, None], [2, ids["<|transcribe|>"]]]}, f)
    with pytest.raises(ValueError, match="forced_decoder_ids"):
        transcribe_cli.main(["--model", str(d), "--wav_dir", str(wav_dir), "--out_csv", str(tmp_path / "x.csv"),
                             "--device", "cpu"])
    prompt, suppress, eot = transcribe_cli.generation_setup(str(model_dir), {"decoder_start_token_id": 1})
    assert prompt[0] == 1 and eot == ids["<|endoftext|>"] and suppress == gen["suppress_tokens"]
