"""Every module of ``interspeech_ser_tpu_torch`` (and ``chip_smoke.py``)
imports without jax, flax, pandas, transformers, safetensors, tokenizers,
regex, scikit-learn or the JAX package, and without building or launching a kernel or
building the native wav loader. Run
in a fresh interpreter, because this test session has imported jax already
(tests/conftest.py)."""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import importlib, json, pkgutil, sys
import interspeech_ser_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from interspeech_ser_tpu_torch.ops.kernels import _build, attention, attention_bhtd, conv_frontend, ffn_fused, gru, pos_conv
from interspeech_ser_tpu_torch.utils import audio, native_audio
print(json.dumps({
    "modules": mods,
    "heavy": [m for m in ("jax", "flax", "pandas", "transformers", "safetensors", "tokenizers", "regex",
                          "sklearn", "interspeech_ser_tpu") if m in sys.modules],
    "library_loaded": _build.library.cache_info().currsize,
    "native_probed": native_audio._TRIED or native_audio._LIB is not None or any(audio.LOADS.values()),
    "launches": [attention.LAUNCHES, attention.BWD_LAUNCHES, attention_bhtd.LAUNCHES, attention_bhtd.FLASH_LAUNCHES,
                 conv_frontend.LAUNCHES, conv_frontend.LAYER_LAUNCHES, gru.LAUNCHES, gru.BWD_LAUNCHES, gru.SEQ_LAUNCHES,
                 ffn_fused.LAUNCHES, pos_conv.LAUNCHES],
}))
"""


def test_port_imports_light():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out["modules"]) >= 25, out["modules"]
    for m in ("train.losses", "train.checkpointing", "train.engine", "utils.seeding", "utils.device",
              "ops.mel", "models.whisper", "models.lora", "train.lora_engine", "lora_cli",
              "baseline.podcast", "baseline.data", "ops.kernels.attention_bhtd", "models.text", "utils.spm",
              "utils.bpe", "ops.kernels.ffn_fused", "ops.kernels.pos_conv", "models.ns3", "models.ns3.facodec",
              "baseline.models", "baseline.engine", "baseline.cli", "utils.metrics", "models.whisper_decoder",
              "utils.whisper_tokenizer", "utils.native_audio", "utils.audio", "transcribe_cli",
              "models.joint", "train.joint_engine", "joint_cli", "stacking", "train.losses", "train.samplers",
              "ops.melspec_ta", "ops.batch_norm", "train.information_encoder", "train.proto_engine",
              "models.xvector", "baseline.xvector_engine", "models.ns3.facodec_decoder", "lora_model",
              "lora_evaluation", "parallel", "parallel.mesh", "parallel.audit", "parallel.tp", "utils.profiling",
              "profile_trace"):
        assert f"interspeech_ser_tpu_torch.{m}" in out["modules"], m
    assert out["heavy"] == []
    assert out["library_loaded"] == 0
    assert out["native_probed"] is False
    assert out["launches"] == [0] * 11
