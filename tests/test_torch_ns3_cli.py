"""``preprocess_cli ns3_prosody`` / ``ns3_prosody_speaker`` (and ``--codes``)
of the port (``--device cpu``) against the JAX package's CLI, on the same 4
seeded wavs and the same two full-width FACodec ``.bin`` files in the
reference's naming (``chip_smoke.write_facodec_checkpoints``: the encoder's
convs weight-normed in the ``weight_g`` / ``weight_v`` key style, the
decoder's VQ projections in the ``parametrizations`` one).

The JAX CLI jits ``extract_batched`` / ``codes`` over its converters' numpy
params, and its ``fvq_forward`` indexes the numpy codebook with traced
indices, which raises under jit; here the JAX converters' outputs reach the
CLI as jnp arrays (the names the CLI imports are wrapped), which changes no
value. ``--batch_size 3`` makes two batches, the second with two zero rows.
The wavs are voiced waves with an F0 contour (``chip_smoke.prosody_wave``)
and the codebook is spread over such waves' latents, so the frames take
many codes. Bars: the same file names and shapes, values within 3e-4 (the
JAX package's batched bar), codes identical and int32, the codes and the
prosody half on the frames whose VQ top-2 gap, from the JAX package's
pre-VQ latents, exceeds 1e-5 (``chip_smoke.VQ_MARGIN``). Then a trimodal
``cli.train_main --trimodal`` step over the port's files.
"""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interspeech_ser_tpu.models.ns3 as jns3_pkg
from interspeech_ser_tpu import preprocess_cli as jax_cli
from interspeech_ser_tpu.models.ns3 import facodec as jns3
from interspeech_ser_tpu_torch import cli, preprocess_cli
from interspeech_ser_tpu_torch.models.loader import build_prosody_extractor
from interspeech_ser_tpu_torch.utils.labels import CLASSES

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)

# samples: 9600 is already a multiple of 200 (the reference pads it by 200 more);
# 20000 -> 101 frames, over the 96-frame tail window, so its tail is re-run
LENGTHS = {"utt_a": 9600, "utt_b": 12345, "utt_c": 20000, "utt_d": 7001}
VARIANTS = {"prosody": (False, []), "speaker": (True, []), "codes": (False, ["--codes"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import chip_smoke

    root = tmp_path_factory.mktemp("ns3_cli")
    enc, dec = chip_smoke.write_facodec_checkpoints(str(root / "ckpt"), seed=11)
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(11)
    for stem, n in LENGTHS.items():
        chip_smoke.write_wav(str(wav_dir / f"{stem}.wav"), chip_smoke.prosody_wave(n, rng, rng.uniform(90, 250)))
    out = {"root": root, "enc": enc, "dec": dec, "wav_dir": str(wav_dir)}

    as_jnp = lambda f: lambda *a, **k: jax.tree_util.tree_map(jnp.asarray, f(*a, **k))  # noqa: E731
    patch = pytest.MonkeyPatch()
    patch.setattr(jns3_pkg, "ns3_decoder_prosody_params_from_torch", as_jnp(jns3.ns3_decoder_prosody_params_from_torch))
    patch.setattr(jns3_pkg, "ns3_encoder_params_from_torch", as_jnp(jns3.ns3_encoder_params_from_torch))
    try:
        for name, (speaker, extra) in VARIANTS.items():
            flags = ["--wav_dir", str(wav_dir), "--encoder_ckpt", enc, "--decoder_ckpt", dec, "--batch_size", "3",
                     "--num_workers", "2", *extra]
            jax_dir, port_dir = str(root / f"jax_{name}"), str(root / f"port_{name}")
            assert jax_cli.ns3_prosody_main(speaker, flags + ["--save_path", jax_dir]) == 4
            main = preprocess_cli.ns3_prosody_speaker_main if speaker else preprocess_cli.ns3_prosody_main
            stats = main(flags + ["--save_path", port_dir, "--device", "cpu"])
            assert stats.n_utts == 4 and stats.n_batches == 2 and stats.n_failed == 0
            out[name] = (jax_dir, port_dir)
    finally:
        patch.undo()
    return out


def _waves(runs, stems):
    from interspeech_ser_tpu_torch.utils.audio import load_wav

    return [np.pad(y, (0, 200 - len(y) % 200)) for y in
            (load_wav(os.path.join(runs["wav_dir"], f"{s}.wav"))[0] for s in stems)]


def _bucket(waves):
    """Waves in one zero-padded batch of 3 rows at a multiple of 3200 samples, as the CLI builds it."""
    Lb = -(-max(len(w) for w in waves) // 3200) * 3200
    bucket = np.zeros((3, Lb), np.float32)
    for i, w in enumerate(waves):
        bucket[i, : len(w)] = w
    return bucket


@pytest.fixture(scope="module")
def latents(runs):
    """The port's extractor, and the JAX package's literal pre-VQ prosody
    latents (wav [B, L] -> [B, T, 256]) on the same weights."""
    port = build_prosody_extractor(runs["dec"])
    params = jax.tree_util.tree_map(jnp.asarray, jns3.ns3_decoder_prosody_params_from_torch(
        {k: v.numpy() for k, v in torch.load(runs["dec"], weights_only=True).items()}))

    @jax.jit
    def jax_latents(wav):
        f0 = jnp.transpose(jns3.get_prosody_feature(wav), (0, 2, 1))
        f0 = f0 @ params["melspec_linear"]["kernel"] + params["melspec_linear"]["bias"]
        return jns3.NS3TransformerEncoder().apply({"params": params["melspec_encoder"]}, f0)

    return port, lambda wav: np.asarray(jax_latents(jnp.asarray(wav)))


def _clear_frames(runs, latents, variant):
    """{stem: frames whose VQ top-2 gap exceeds the margin}, from the JAX
    latents the variant's file went through: each utterance's batch-1
    latents (what extract_batched reproduces), or for ``--codes`` its row of
    the CLI's bucket (utt_d, utt_a, utt_b; then utt_c and two zero rows)."""
    import chip_smoke

    port, jax_latents = latents
    out = {}
    for stems in (("utt_d", "utt_a", "utt_b"), ("utt_c",)):
        waves = _waves(runs, stems)
        rows = (jax_latents(_bucket(waves)) if variant == "codes" else
                [jax_latents(w[None])[0] for w in waves])
        for i, (stem, w) in enumerate(zip(stems, waves)):
            gap = chip_smoke.vq_top2_gap(torch.from_numpy(np.array(rows[i][: len(w) // 200])), port.fvq)
            out[stem] = gap > chip_smoke.VQ_MARGIN
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ns3_cli_matches_jax(runs, latents, variant):
    jax_dir, port_dir = runs[variant]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(f"{s}.pt" for s in LENGTHS)
    clear = _clear_frames(runs, latents, variant)
    seen = set()
    for stem, n in LENGTHS.items():
        got = torch.load(os.path.join(port_dir, f"{stem}.pt"), weights_only=True)
        want = torch.load(os.path.join(jax_dir, f"{stem}.pt"), weights_only=True)
        frames = (n + 200 - n % 200) // 200  # 200 more zeros when n is already a multiple
        if variant == "codes":
            assert got.dtype == want.dtype == torch.int32 and tuple(got.shape) == (frames,)
            np.testing.assert_array_equal(got.numpy()[clear[stem]], want.numpy()[clear[stem]])
            seen.update(got.tolist())
        else:
            dim = 512 if variant == "speaker" else 256
            assert got.dtype == want.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape) == (frames, dim)
            np.testing.assert_allclose(got.numpy()[clear[stem]], want.numpy()[clear[stem]], atol=3e-4, rtol=0)
            np.testing.assert_allclose(got.numpy()[:, 256:], want.numpy()[:, 256:], atol=3e-4, rtol=0)
            seen.update(map(tuple, got[:, :256].tolist()))
    assert LENGTHS["utt_a"] % 200 == 0  # the pad-by-200 case is in the set
    near = sum(int((~c).sum()) for c in clear.values())
    # not vacuous: the frames take many codes (58 distinct rows, 66 codes at this seed), and few are near a tie
    assert len(seen) >= 32 and near <= 2, (len(seen), near)


def test_codes_depend_on_the_batch_row(runs, latents):
    """The reference behaviour ``--codes`` keeps: codes() runs the literal
    positional encoding (row b gets pe[b]) on the zero-padded bucket with no
    mask, so an utterance's codes depend on its row and bucket, where the
    reference ran batch-1. In both packages the row-1 utterance's pre-VQ
    latents differ from its batch-1 ones by more than 1e-3, and the port's
    equal the JAX package's there."""
    port, jax_latents = latents
    # the first bucket as the CLI builds it: utt_d, utt_a, utt_b by length; utt_a in row 1
    waves = _waves(runs, ("utt_d", "utt_a", "utt_b"))
    bucket = _bucket(waves)
    n = len(waves[1]) // 200
    with torch.no_grad():
        got_bucket = port.prosody_latents(torch.from_numpy(bucket)).numpy()[1, :n]
        got_single = port.prosody_latents(torch.from_numpy(waves[1][None])).numpy()[0, :n]
    want_bucket, want_single = jax_latents(bucket)[1, :n], jax_latents(waves[1][None])[0, :n]
    assert np.abs(want_bucket - want_single).max() > 1e-3
    assert np.abs(got_bucket - got_single).max() > 1e-3
    np.testing.assert_allclose(got_bucket, want_bucket, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_single, want_single, atol=1e-4, rtol=0)


def test_trimodal_train_over_port_files(runs, tmp_path):
    """One ``cli.train_main --trimodal`` step (focal loss) over the port's
    256-d NS3 files as lazy_dir3, beside small synthetic speech and text
    features, then ``cli.eval_main --trimodal`` on its checkpoint."""
    rng = np.random.default_rng(12)
    dims = (24, 16)
    dirs = [tmp_path / "speech", tmp_path / "text"]
    rows = []
    for i, stem in enumerate(LENGTHS):
        for d, dim in zip(dirs, dims):
            d.mkdir(exist_ok=True)
            torch.save(torch.from_numpy(rng.standard_normal((int(rng.integers(5, 30)), dim)).astype(np.float32)),
                       str(d / f"{stem}.pt"))
        rows.append([f"{stem}.wav"] + [float(c == i) for c in range(8)] + ["Train" if i < 3 else "Development"])
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName"] + CLASSES + ["Split_Set"]] + rows)
    with open(tmp_path / "transcripts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[r[0], "hi"] for r in rows])
    config4 = "config_cat_trimodal_lazy_lr1e4_whisperlarge_roberta_ns3_focaloss.json"  # BASELINE config #4
    with open(os.path.join(ROOT, "configs", config4)) as f:
        cfg = json.load(f)
    cfg.update(wav_dir=str(tmp_path), txt_dir=str(tmp_path / "transcripts.csv"), lazy_dir1=str(dirs[0]),
               lazy_dir2=str(dirs[1]), lazy_dir3=runs["prosody"][1], label_path=str(tmp_path / "labels.csv"),
               feat1_dim=dims[0], feat2_dim=dims[1], epochs=1, batch_size=4, fusion_hidden_dim=16,
               model_path=str(tmp_path / "exp"))
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    flags = ["--config_path", path, "--trimodal", "--device", "cpu"]
    best = cli.train_main(flags)
    assert np.isfinite(best["macro_f1"])
    sd = torch.load(str(tmp_path / "exp" / "multimodal_ser.pt"), weights_only=True)
    assert tuple(sd["prosody_projection.weight"].shape) == (16, 256)
    with open(cli.eval_main(flags), newline="") as f:
        table = list(csv.reader(f))
    assert table[0][:2] == ["Filename", "Prediction"] and [r[0] for r in table[1:]] == ["utt_d.wav"]


@pytest.mark.parametrize("main", [preprocess_cli.ns3_prosody_main, preprocess_cli.ns3_prosody_speaker_main])
def test_default_device_needs_a_card(runs, tmp_path, monkeypatch, main):
    """No ``--device``: the card, and without one the CLI raises before it reads a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--wav_dir", runs["wav_dir"], "--save_path", str(tmp_path / "x"), "--encoder_ckpt", runs["enc"],
              "--decoder_ckpt", runs["dec"]])
    assert not (tmp_path / "x").exists()
    assert set(preprocess_cli.COMMANDS) >= {"ns3_prosody", "ns3_prosody_speaker"}
