"""``chip_smoke.py``'s extraction, scoring and training phases, rehearsed on
the CPU.

The kernels have no CPU mode, so the wrappers are swapped for counting
stand-ins that run the plain versions, the encoder is cut to 2 layers (with
a short conv frontend), the training corpus and the fusion model are cut to
a few small utterances and H=16, and the device is the CPU. What this
checks is the script's own host logic: wav, feature and checkpoint writing,
the CLIs, the shape, launch-count, gradient and CSV checks. The card run is
``python3 chip_smoke.py``.
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
    assert launches["gru_bidir_bwd"] == 0  # scoring runs no backward


def test_train_phase_on_cpu(tmp_path, monkeypatch):
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.ops import gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import gru as kg

    def counting(counter, plain):
        def launch(*args, **kw):
            setattr(kg, counter, getattr(kg, counter) + 1)
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(
        n_train=10, n_dev=6, feat_dim=24, speech_len=(30, 70), text_len=(5, 20), epochs=2,
        config=dict(fusion_hidden_dim=16, batch_size=4),
    ))
    monkeypatch.setattr(kg, "gru_bidir_carries", counting("LAUNCHES", kg.gru_bidir_carries_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries_bwd", counting("BWD_LAUNCHES", kg.gru_bidir_carries_bwd_plain))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    monkeypatch.setattr(kg, "LAUNCHES", 0)
    monkeypatch.setattr(kg, "BWD_LAUNCHES", 0)

    config_path = cs.write_train_corpus(str(tmp_path))
    trained = cs.phase_train(config_path)
    assert trained["steps"] == 2 * 3 and trained["n_modalities"] == 2
    assert cs.counts()["gru_bidir_bwd"] == 2 * 6 and cs.counts()["gru_bidir"] > 0
    step = cs.check_train_step(config_path)
    assert step["grad_rel_err"] <= 1e-4 and len(step["train_step_ms_runs"]) == 5
    assert ops_gru.BiGRU.forward is ops_gru.BiGRU.forward_stacked  # the plain route is undone
