"""``chip_smoke.py``'s extraction and scoring phases, rehearsed on the CPU.

The kernels have no CPU mode, so the wrappers are swapped for counting
stand-ins that run the plain versions, the encoder is cut to 2 layers (with
a short conv frontend) and the device is the CPU. What this checks is the
script's own host logic: wav and checkpoint writing, both CLIs, the shape,
launch-count and CSV checks. The card run is ``python3 chip_smoke.py``.
"""

import os
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)


def test_main_path_phases_on_cpu(tmp_path, monkeypatch):
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.ops import attention_core, gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc, gru as kg

    def tiny(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=1024, num_layers=2, num_heads=16, intermediate_size=256,
            conv_dim=(512,) + (32,) * 4, conv_kernel=(10, 4, 4, 4, 4), conv_stride=(5, 4, 4, 4, 4),
            conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
            attention_type="wavlm", dtype=dtype,
        )

    def counting(mod, plain):
        def launch(*args, **kw):
            mod.LAUNCHES += 1
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(speech, "wavlm_large", tiny)
    monkeypatch.setattr(attention_core, "attention_btd", counting(ka, ka.attention_btd_plain))
    monkeypatch.setattr(speech, "conv_frontend", counting(kc, kc.conv_frontend_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries", counting(kg, kg.gru_bidir_carries_plain))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    for mod in (ka, kc, kg):
        monkeypatch.setattr(mod, "LAUNCHES", 0)

    extracted = cs.phase_extraction(str(tmp_path))
    assert set(extracted["utt_per_sec"]) == {"bfloat16_cold", "bfloat16_warm", "float32_cold", "float32_warm"}
    cs.phase_scoring(str(tmp_path), extracted)
    launches = cs.counts()
    assert launches["attention_btd"] == 4 * 2  # 4 runs x 2 layers x 1 batch
    assert launches["conv_frontend"] == 4 and launches["gru_bidir"] > 0
