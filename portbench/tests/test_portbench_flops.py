"""The FLOP and byte counts against the bounds of PERF.md's kernel table."""

import json

import pytest

from portbench import flops
from portbench.bench import ROOT

WAVLM = json.loads((ROOT / "portbench/configs/wavlm_large.json").read_text())
WHISPER = json.loads((ROOT / "portbench/configs/whisper_large_v3.json").read_text())


def test_k1_whisper_bound():
    """Whisper B=8, T=1500, no mask: 1.4185 ms (ops) f32, 0.0961 (ops) bf16."""
    lengths = [1500] * 8
    assert flops.k1_seconds(lengths, 1500, 1280, 20, False) * 1e3 == pytest.approx(1.4185, abs=5e-5)
    assert flops.k1_seconds(lengths, 1500, 1280, 20, False, "bfloat16") * 1e3 == pytest.approx(0.0961, abs=5e-5)


def test_k1_counts_live_pairs_only():
    """A ragged batch counts each row's live query-key pairs: below the
    table's count, which takes every query row of the padded batch."""
    lengths, T, D, H = [499, 450, 400, 350, 300, 250, 200, 150], 499, 1024, 16
    table = (4 * T * D * sum(lengths) + 8 * H * T * sum(lengths)) / 67e12
    live = flops.k1_seconds(lengths, T, D, H, True)
    assert live < table
    assert flops.k1_seconds([T] * 8, T, D, H, True) == pytest.approx(4 * T * D * 8 * T / 67e12 + 8 * H * T * 8 * T / 67e12)


def test_k3_k3b_bounds():
    """[128, 512, 1536] (2B = 128 rows, T = 512, H = 512): K3 1.037 ms and
    K3b 2.945 ms, both bound by operations, at the ragged lengths of the
    table's two runs (44,002 and 41,681 live steps)."""
    assert flops.k3_seconds(44002, 128, 512, 512) * 1e3 == pytest.approx(1.037, abs=5e-4)
    assert flops.k3b_seconds(41681, 128, 512, 512) * 1e3 == pytest.approx(2.945, abs=5e-4)
    assert flops.k3_seconds(44002, 128, 512, 512) > flops.least_seconds(0, 4 * 128 * 512 * 5 * 512)


def test_model_flops():
    """Whisper-large-v3 at 30 s: about 2.27 TFLOP; WavLM-large about 38
    GFLOP an audio-second at 10 s."""
    assert flops.whisper_flops(WHISPER) == pytest.approx(2.27e12, rel=0.01)
    assert flops.wavlm_flops(160000, WAVLM) / 10 == pytest.approx(3.8e10, rel=0.02)


def test_fusion_step_flops():
    """Batch 64 at 344 speech frames and 80 text frames, H = 512: the GRU
    products alone (input and recurrence, both directions, both
    modalities) are 3 x 4 x 2 x 3H^2 x frames."""
    speech, text = [344] * 64, [80] * 64
    total = flops.fusion_step_flops(speech, text, (1280, 1024), 512, 8)
    gru = 3 * 2 * 2 * 2 * 3 * 512 * 512 * (sum(speech) + sum(text))
    assert gru < total < 3 * gru
