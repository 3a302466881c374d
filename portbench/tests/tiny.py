"""A tiny copy of the benchmark's files for the tests: the same drivers,
references and metric readers over small depths and widths that the
kernels still take (head dim 64, 64 channels a positional-conv group, the
512-channel frontend), in a root of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench import ROOT

WAVLM = dict(json.loads((ROOT / "portbench/configs/wavlm_large.json").read_text()),
             hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
WHISPER = dict(json.loads((ROOT / "portbench/configs/whisper_large_v3.json").read_text()),
               num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=256)
WHISPER["fusion"] = dict(WHISPER["fusion"], feat1_dim=24, feat2_dim=16, fusion_hidden_dim=16, batch_size=4)
TRAFFIC = {
    "tiny_wavs": {"driver": "extract", "dtype": "float32", "num_workers": 2, "token_budget_s": 3,
                  "corpus": {"utterances": 6, "seconds": [0.5, 1.5]}, "check_utterances": 6, "trace_seconds": 1},
    "tiny_whisper_wavs": {"driver": "extract", "dtype": "float32", "num_workers": 2, "batch_size": 2,
                          "corpus": {"utterances": 4, "seconds": [0.5, 1.5]}, "check_utterances": 4,
                          "trace_seconds": 1},
    "tiny_rows": {"driver": "fusion_train", "dtype": "float32", "bucket_window": 2, "bucket_quantum": 16,
                  "corpus": {"utterances": 16, "seconds": [0.3, 1.0],
                             "class_shares": [0.09, 0.08, 0.2, 0.04, 0.02, 0.03, 0.06, 0.48],
                             "modalities": [{"name": "speech", "dim": 24, "hop": 320},
                                            {"name": "text", "dim": 16, "rows": 8}]},
                  "trace_seconds": 1},
}
# the training cell's metrics, which BENCHMARK.json does not hold yet (PERF.md, Open questions)
_TRAIN = ["whisper_large_v3.fusion_train"]
TRAIN_END_TO_END = [{"name": "train_samples_per_s", "unit": "samples/s", "better": "higher", "bound": 0.25,
                     "source": "host_clock", "workloads": _TRAIN}]
TRAIN_PER_LAYER = [
    {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
     "moves": "train_samples_per_s", "workloads": _TRAIN}
    for name, unit, better, source, layer in [
        ("batch_wait_ms.train", "ms", "lower", "host_clock", "fusion batches"),
        ("h2d_ms.train", "ms", "lower", "device_trace", "fusion batches"),
        ("mfu.train", "%", "higher", "host_clock", "fusion step"),
        ("k3_roofline.train", "%", "higher", "device_trace", "kernels"),
        ("k3b_roofline.train", "%", "higher", "device_trace", "kernels"),
        ("device_idle_pct.train", "%", "lower", "device_trace", "device")]]
CELLS = {"tiny_wavlm.extract": ("tiny_wavlm", "tiny_wavs", "wavlm_large.extract_f32"),
         "tiny_whisper.extract": ("tiny_whisper", "tiny_whisper_wavs", "whisper_large_v3.extract_f32"),
         "tiny_whisper.train": ("tiny_whisper", "tiny_rows", "whisper_large_v3.fusion_train")}


def make_root(root: Path) -> Path:
    """``root`` with a BENCHMARK.json of the three tiny cells (the held-back
    training cell's among them), their files, the real metric readers and
    the real cells' limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["end_to_end"] += TRAIN_END_TO_END
    bench["per_layer"] += TRAIN_PER_LAYER
    pb = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench/metrics", pb / "metrics", dirs_exist_ok=True)
    for name, cfg in (("tiny_wavlm", WAVLM), ("tiny_whisper", WHISPER)):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, (_, _, real) in CELLS.items():
        shutil.copy(ROOT / "portbench/limits" / f"{real}.json", pb / "limits" / f"{cell}.json")
    bench["configs"] = [{"name": n, "source": "test", "file": f"portbench/configs/{n}.json", "reduced": [], "why": "t"}
                        for n in ("tiny_wavlm", "tiny_whisper")]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": t, "chips": 1, "why": "test"}
                          for c, (cfg, t, _) in CELLS.items()]
    rename = {real: cell for cell, (_, _, real) in CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, cell: str, device: str = "cpu", trace: bool = False, control: bool = False, seed: int = 2 ** 31 + 7):
    from portbench import bench

    return bench.run_cell(bench.load_cell(cell, root), seed, 0.5, trace, device=device, control=control, root=root)
