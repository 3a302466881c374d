"""A run with the timed path broken underneath comes out not correct; so does the control.

Each tiny cell runs the harness as a run does, less its look for a card,
on the CPU with the real cells' limits: once sound, once with each fault
the cell can have planted in the program (``portbench/faults.py``), and
once reading the control (the reference in TF32 in the program's place).
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench import faults
from portbench.bench import ROOT

from .tiny import run

SPEECH, WHISPER, TRAIN = "tiny_wavlm.extract", "tiny_whisper.extract", "tiny_whisper.train"


@pytest.mark.parametrize("cell", [SPEECH, WHISPER, TRAIN])
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, cell):
    result = run(tiny_root, cell, control=True)
    assert result["correct"] is True, result["checks"]
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    control = {k[len("control."):]: v for k, v in result["readings"].items() if k.startswith("control.")}
    assert any(control[k] > limits[k] for k in limits), (control, limits)


@pytest.mark.parametrize("fault", faults.EXTRACT)
@pytest.mark.parametrize("cell", [SPEECH, WHISPER])
def test_extraction_fault_is_not_correct(tiny_root, cell, fault):
    with faults.extraction(fault):
        assert run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_training_fault_is_not_correct(tiny_root, fault):
    with faults.training(fault):
        assert run(tiny_root, TRAIN)["correct"] is False


def test_no_jax_after_a_drive(tiny_root):
    """After a tiny drive of every cell, no module of JAX or of the JAX package is loaded."""
    code = ("import sys; from pathlib import Path; from portbench.tests.tiny import run; from portbench import bench; "
            f"root = Path({str(tiny_root)!r}); "
            f"[run(root, c) for c in {[SPEECH, WHISPER, TRAIN]!r}]; print(bench.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [SPEECH, WHISPER, TRAIN])
def test_tiny_cell_on_the_card(tiny_root, card, cell):
    """The tiny cells through the kernels, traced: correct, and every
    per-layer metric of the cell read from the trace."""
    result = run(tiny_root, cell, device="cuda", trace=True)
    assert result["correct"] is True, result["checks"]
    names = {m["name"] for m in json.loads((tiny_root / "BENCHMARK.json").read_text())["per_layer"]
             if cell in m.get("workloads", ())}
    assert set(result["metrics"]) == names
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
