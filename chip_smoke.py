#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one CUDA card (built for
an H100, ``sm_90a``) and needs nothing else: it builds the hand-written
kernels from ``interspeech_ser_tpu_torch/csrc/`` into ``build/``, holds each
kernel against its plain PyTorch version at the main path's shapes, then
drives the serving path through its entry points at full width:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: nvcc, seconds and the compiler's register report;
3. kernel parity and timing, kernel vs plain version (median of 5 runs,
   CUDA events, after a warm-up; TF32 off for the plain version):
   K1 attention at WavLM-large shapes (gated bias + ragged key mask, f32 and
   bf16) and its no-bias / no-mask variants at Whisper-large shapes; K2 the
   fused conv0 + LayerNorm + GELU on 10-s waveforms; K3 the BiGRU recurrence;
4. extraction: a seeded random-init WavLM-large (24 layers, D=1024) written
   as an HF directory, 8 seeded wavs of 3-12 s, ``preprocess_cli.speech_main``
   in bf16 and in f32 (each run twice, cold then warm); shapes,
   finiteness, launch counts, and one f32 utterance against the plain path
   on the card;
5. scoring: the bimodal WavLM-large + RoBERTa-large config at full fusion
   width (H=512, feat dims 1024/1024), ``cli.eval_main`` and ``cli.test_main``
   over the extracted features; CSV format, and every logit against a
   batch-1 plain forward on the CPU.

The launch counters are zeroed just before phase 4 and read after phase 5.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import csv
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
import wave

import numpy as np
import torch

from interspeech_ser_tpu_torch.ops.kernels import _build
from interspeech_ser_tpu_torch.ops.kernels import attention as k_attn
from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as k_conv
from interspeech_ser_tpu_torch.ops.kernels import gru as k_gru

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
DEVICE = "cuda"
KERNELS = {
    "attention_btd": dict(
        module=k_attn, source="interspeech_ser_tpu_torch/csrc/attention_btd.cu",
        replaces="interspeech_ser_tpu/ops/pallas/flash_attention_short.py:293",
    ),
    "conv_frontend": dict(
        module=k_conv, source="interspeech_ser_tpu_torch/csrc/conv_frontend.cu",
        replaces="interspeech_ser_tpu/ops/pallas/conv_frontend.py:134",
    ),
    "gru_bidir": dict(
        module=k_gru, source="interspeech_ser_tpu_torch/csrc/gru_bidir.cu",
        replaces="interspeech_ser_tpu/ops/pallas/gru_kernel.py:357",
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phases 1-2 ---------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {os.path.relpath(lib_path, ROOT)} ready in {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


# -- phase 3 --------------------------------------------------------------------


def _attention_inputs(g, B, T, D, H, lengths, bias: bool, dt):
    dev = "cuda"
    q, k, v = (torch.randn(B, T, D, generator=g, device=dev).to(dt) for _ in range(3))
    mask = None
    if lengths is not None:
        mask = (torch.arange(T, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).float()
    gate = pb = None
    if bias:
        gate = 1.0 + torch.rand(B, H, T, generator=g, device=dev)
        pb = torch.randn(H, T, T, generator=g, device=dev)
    return (q, k, v, H), dict(key_mask=mask, gate=gate, pos_bias=pb)


def check_attention(g, results) -> None:
    # WavLM-large layer: ragged lengths; length 400 leaves the last key tile
    # (448..498) fully masked for that row
    lengths = [499, 480, 451, 400, 333, 250, 130, 64]
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = _attention_inputs(g, 8, 499, 1024, 16, lengths, True, dt)
        out = k_attn.attention_btd(*args, **kw)
        ref = k_attn.attention_btd_plain(*args, **kw)
        err, cos = max_abs(out, ref), cosine(out, ref)
        ms = median_ms(lambda: k_attn.attention_btd(*args, **kw))
        plain_ms = median_ms(lambda: k_attn.attention_btd_plain(*args, **kw))
        name = "f32" if dt == torch.float32 else "bf16"
        log(f"[parity] K1 attention_btd B8 T499 D1024 H16 bias+mask {name}: "
            f"max_abs {err:.3e} cos {cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if dt == torch.float32:
            require(err <= 1e-4, f"K1 f32 max_abs {err} > 1e-4")
        else:
            require(cos >= 0.999, f"K1 bf16 cosine {cos} < 0.999")
        main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms)
    # Whisper-large shape: the no-bias and no-mask variants
    for bias, masked in ((True, False), (False, True), (False, False)):
        for dt in (torch.float32, torch.bfloat16):
            lens = [1500, 1111, 777, 1000] if masked else None
            args, kw = _attention_inputs(g, 4, 1500, 1280, 20, lens, bias, dt)
            out = k_attn.attention_btd(*args, **kw)
            ref = k_attn.attention_btd_plain(*args, **kw)
            err, cos = max_abs(out, ref), cosine(out, ref)
            log(f"[parity] K1 attention_btd B4 T1500 D1280 H20 bias={bias} mask={masked} "
                f"{dt}: max_abs {err:.3e} cos {cos:.7f}")
            if dt == torch.float32:
                require(err <= 1e-4, f"K1 variant f32 max_abs {err} > 1e-4")
            else:
                require(cos >= 0.999, f"K1 variant bf16 cosine {cos} < 0.999")
    results["attention_btd"] = main


def check_conv_frontend(g, results) -> None:
    dev = "cuda"
    wav = torch.randn(8, 160000, generator=g, device=dev)
    w = torch.randn(512, 1, 10, generator=g, device=dev) / 10 ** 0.5
    b = 0.1 * torch.randn(512, generator=g, device=dev)
    lw = 1.0 + 0.1 * torch.randn(512, generator=g, device=dev)
    lb = 0.1 * torch.randn(512, generator=g, device=dev)
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        for approx in (False, True):
            args = (wav, w, b, lw, lb, 5, dt, approx, 1e-5)
            out = k_conv.conv_frontend(*args)
            ref = k_conv.conv_frontend_plain(*args)
            require(tuple(out.shape) == (8, 31999, 512), f"K2 output shape {tuple(out.shape)}")
            err, cos = max_abs(out, ref), cosine(out, ref)
            ms = median_ms(lambda: k_conv.conv_frontend(*args))
            plain_ms = median_ms(lambda: k_conv.conv_frontend_plain(*args))
            name = ("f32" if dt == torch.float32 else "bf16") + ("_tanh" if approx else "_erf")
            log(f"[parity] K2 conv_frontend wav[8,160000] -> [8,31999,512] {name}: "
                f"max_abs {err:.3e} cos {cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if dt == torch.float32:
                require(err <= 1e-4, f"K2 {name} max_abs {err} > 1e-4")
            else:
                require(cos >= 0.999, f"K2 {name} cosine {cos} < 0.999")
            main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms)
    results["conv_frontend"] = main


def check_gru(g, results) -> None:
    dev = "cuda"
    B, T, H = 8, 500, 512
    bound = H ** -0.5
    x_proj = 0.5 * torch.randn(2 * B, T, 3 * H, generator=g, device=dev)
    w_hh2 = (torch.rand(2, H, 3 * H, generator=g, device=dev) * 2 - 1) * bound
    b_hh2 = (torch.rand(2, 3 * H, generator=g, device=dev) * 2 - 1) * bound
    lengths = torch.randint(100, T + 1, (B,), generator=g, device=dev)
    m = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    mask = torch.cat([m, m.flip(1)], dim=0).contiguous()  # backward rows time-reversed
    args = (x_proj, w_hh2, b_hh2, mask, B)
    out = k_gru.gru_sequence_bidir(*args)
    ref = k_gru.gru_sequence_bidir(x_proj.cpu(), w_hh2.cpu(), b_hh2.cpu(), mask.cpu(), B)
    ref_card = k_gru.gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None]
    err, cos = max_abs(out, ref_card), cosine(out, ref_card)
    err_cpu = max_abs(out.cpu(), ref)
    ms = median_ms(lambda: k_gru.gru_sequence_bidir(*args))
    plain_ms = median_ms(lambda: k_gru.gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None])
    log(f"[parity] K3 gru_bidir x_proj[16,500,1536] H512 ragged f32: max_abs {err:.3e} "
        f"(vs CPU plain {err_cpu:.3e}) cos {cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    require(err <= 1e-4, f"K3 f32 max_abs {err} > 1e-4")
    results["gru_bidir"] = {"f32": dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms)}


# -- phases 4-5 -------------------------------------------------------------------


def write_wav(path: str, samples: np.ndarray, sr: int = 16000) -> None:
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_wavlm_large(model_dir: str) -> None:
    """Seeded random-init WavLM-large as an HF directory (the port's own
    HF key names; no transformers on the card's machine)."""
    from interspeech_ser_tpu_torch.models.speech import SpeechEncoderModel, wavlm_large

    cfg = wavlm_large()
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = SpeechEncoderModel(cfg)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.to_hf(), "architectures": ["WavLMModel"]}, f, indent=1)
    with open(os.path.join(model_dir, "preprocessor_config.json"), "w") as f:
        json.dump({"do_normalize": True, "sampling_rate": 16000}, f)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(model_dir, "pytorch_model.bin"))
    del model


def counts() -> dict:
    return {name: spec["module"].LAUNCHES for name, spec in KERNELS.items()}


def phase_extraction(tmp: str) -> dict:
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder
    from interspeech_ser_tpu_torch.models.speech import feat_extract_output_length, wavlm_large
    from interspeech_ser_tpu_torch.preprocess_cli import speech_main
    from interspeech_ser_tpu_torch.utils.audio import load_wav, normalize_waveform

    rng = np.random.default_rng(SEED)
    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    n_samples = {}
    for i in range(8):
        n = int(rng.uniform(3.0, 12.0) * 16000)
        t = np.arange(n) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(n)
        write_wav(os.path.join(wav_dir, f"utt{i}.wav"), x)
        n_samples[f"utt{i}"] = n
    model_dir = os.path.join(tmp, "wavlm-large")
    t0 = time.perf_counter()
    write_wavlm_large(model_dir)
    log(f"[extract] wrote seeded random-init WavLM-large to {model_dir} in {time.perf_counter() - t0:.1f} s")

    cfg = wavlm_large()
    rates = {}
    # each dtype runs twice: the first (cold) run pays cuBLAS/cuDNN start-up
    # and algorithm search; the second (warm) run's utt/s is the one reported
    for dtype, rep in [(d, r) for d in ("bfloat16", "float32") for r in ("cold", "warm")]:
        save = os.path.join(tmp, f"feats_{dtype}" + ("_cold" if rep == "cold" else ""))
        before = counts()
        stats = speech_main(["--ssl_type", model_dir, "--wav_dir", wav_dir, "--save_path", save,
                             "--dtype", dtype])
        sync()
        delta = {k: v - before[k] for k, v in counts().items()}
        require(stats.n_utts == 8 and stats.n_failed == 0, f"{dtype}: {stats}")
        require(delta["attention_btd"] == cfg.num_layers * stats.n_batches,
                f"{dtype}: K1 launches {delta['attention_btd']} != {cfg.num_layers} x {stats.n_batches} batches")
        require(delta["conv_frontend"] >= stats.n_batches,
                f"{dtype}: K2 launches {delta['conv_frontend']} < {stats.n_batches} batches")
        for stem, n in n_samples.items():
            feats = torch.load(os.path.join(save, f"{stem}.pt"), weights_only=True)
            want = (feat_extract_output_length(n, cfg), cfg.hidden_size)
            require(tuple(feats.shape) == want and feats.dtype == torch.float32,
                    f"{dtype} {stem}: {tuple(feats.shape)} {feats.dtype}, want {want} float32")
            require(bool(torch.isfinite(feats).all()), f"{dtype} {stem}: non-finite values")
        rates[f"{dtype}_{rep}"] = stats.utts_per_sec
        log(f"[extract] {dtype} {rep}: {stats.n_utts} utts, {stats.n_batches} batches, "
            f"{stats.audio_seconds:.1f} audio-s in {stats.wall_seconds:.2f} s = "
            f"{stats.utts_per_sec:.2f} utt/s; launches {delta}")

    # one utterance against the plain path on the card, f32, TF32 off
    set_tf32(False)
    model, _, do_norm = build_speech_encoder(model_dir, dtype="float32")
    model = model.to(DEVICE).eval()
    y, _ = load_wav(os.path.join(wav_dir, "utt0.wav"))
    x = torch.from_numpy(normalize_waveform(y, do_norm))[None].to(DEVICE)
    with torch.inference_mode():
        ref = model(x, plain=True)["last_hidden_state"][0].cpu()
    for dtype, bar in (("float32", 0.999), ("bfloat16", None)):
        got = torch.load(os.path.join(tmp, f"feats_{dtype}", "utt0.pt"), weights_only=True)
        cos = cosine(got, ref)
        log(f"[extract] utt0 {dtype} .pt vs plain f32 path on the card: cos {cos:.6f} "
            f"max_abs {max_abs(got, ref):.3e}")
        if bar is not None:
            require(cos >= bar, f"{dtype} utt0 cosine {cos} < {bar}")
    del model
    return {"utt_per_sec": rates, "feats_dir": os.path.join(tmp, "feats_float32"),
            "names": sorted(n_samples)}


def phase_scoring(tmp: str, extracted: dict) -> None:
    from interspeech_ser_tpu_torch import cli
    from interspeech_ser_tpu_torch.models.fusion import MultiModalEmotionClassifier
    from interspeech_ser_tpu_torch.utils.labels import CLASSES, INDEX_TO_LETTER

    set_tf32(False)
    rng = np.random.default_rng(SEED + 1)
    names = [f"{s}.wav" for s in extracted["names"]]
    txt_dir = os.path.join(tmp, "roberta_large")
    os.makedirs(txt_dir)
    for n in names:
        torch.save(torch.from_numpy(rng.standard_normal((80, 1024)).astype(np.float32)),
                   os.path.join(txt_dir, n.replace(".wav", ".pt")))
    label_csv = os.path.join(tmp, "labels.csv")
    with open(label_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["FileName"] + CLASSES + ["Split_Set"])
        for i, n in enumerate(names):
            w.writerow([n] + [float(c == i % 8) for c in range(8)] + ["Development" if i < 6 else "Train"])
    transcripts = os.path.join(tmp, "transcripts.csv")
    with open(transcripts, "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[n, f"words {n}"] for n in names])
    test_csv = os.path.join(tmp, "Categorical_test.csv")
    with open(test_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName"]] + [[n] for n in names])
    with open(os.path.join(ROOT, "configs", "config_cat_bimodal_lazy_lr1e4_head1.json")) as f:
        cfg = json.load(f)
    model_path = os.path.join(tmp, "experiment")
    cfg.update(wav_dir=os.path.join(tmp, "wavs"), txt_dir=transcripts, lazy_dir1=extracted["feats_dir"],
               lazy_dir2=txt_dir, label_path=label_csv, model_path=model_path)
    config_path = os.path.join(tmp, "config.json")
    with open(config_path, "w") as f:
        json.dump(cfg, f)
    torch.manual_seed(SEED)
    model = MultiModalEmotionClassifier((cfg["feat1_dim"], cfg["feat2_dim"]), 512).eval()
    os.makedirs(model_path)
    torch.save(model.state_dict(), os.path.join(model_path, "multimodal_ser.pt"))

    before = counts()["gru_bidir"]
    dev_csv = cli.eval_main(["--config_path", config_path])
    test_out = cli.test_main(["--config_path", config_path, "--test_df", test_csv])
    sync()
    require(counts()["gru_bidir"] > before, "K3 was not launched by scoring")

    # every logit against a batch-1 plain forward on the CPU (gru_scan path)
    ref = {}
    with torch.inference_mode():
        for n in names:
            stem = n.replace(".wav", ".pt")
            feats = [torch.load(os.path.join(d, stem), weights_only=True)[None]
                     for d in (extracted["feats_dir"], txt_dir)]
            ref[n] = model(feats).numpy()[0]
    four = re.compile(r"^-?\d+\.\d{4}$")
    for path, header, rows in ((dev_csv, "Filename", names[:6]), (test_out, "FileName", names)):
        with open(path, newline="") as f:
            table = list(csv.reader(f))
        require(table[0] == [header, "Prediction"] + [f"class_{i}_prob" for i in range(8)],
                f"{path}: header {table[0]}")
        require([r[0] for r in table[1:]] == rows, f"{path}: rows {[r[0] for r in table[1:]]}")
        worst = 0.0
        for r in table[1:]:
            require(all(four.match(v) for v in r[2:]), f"{path}: logits not 4-decimal: {r}")
            logits = np.asarray([float(v) for v in r[2:]])
            require(r[1] == INDEX_TO_LETTER[int(np.argmax(logits))], f"{path}: prediction {r}")
            worst = max(worst, float(np.abs(logits - ref[r[0]]).max()))
        require(worst <= 1e-3, f"{path}: logits differ from the batch-1 CPU forward by {worst}")
        log(f"[score] {os.path.relpath(path, tmp)}: {len(table) - 1} rows, header {header}; "
            f"max |logit - batch-1 CPU plain| = {worst:.2e}")


def main() -> None:
    smi = phase_device()
    set_tf32(False)
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    parity: dict = {}
    check_attention(g, parity)
    check_conv_frontend(g, parity)
    check_gru(g, parity)

    for spec in KERNELS.values():
        spec["module"].LAUNCHES = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        extracted = phase_extraction(tmp)
        phase_scoring(tmp, extracted)
    launches = counts()
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    log(f"[main path] launches {launches}; extraction utt/s {extracted['utt_per_sec']}")

    record = []
    for name, spec in KERNELS.items():
        cases = parity[name]
        f32 = cases.get("f32") or cases["f32_erf"]
        record.append({
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "launches": launches[name], "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "cases": cases,
        })
    log(json.dumps({"kernels": record, "card": smi, "extraction_utt_per_sec": extracted["utt_per_sec"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
