"""``chip_smoke.py``'s extraction, scoring, training, LoRA and text phases,
rehearsed on the CPU.

The kernels have no CPU mode, so the wrappers are swapped for counting
stand-ins that run the plain versions, the encoder is cut to 2 layers (with
a short conv frontend), the training corpus and the fusion model are cut to
a few small utterances and H=16, and the device is the CPU. What this
checks is the script's own host logic: wav, feature and checkpoint writing,
the CLIs, the shape, launch-count, gradient and CSV checks. The card run is
``python3 chip_smoke.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
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

    monkeypatch.setattr(cs, "WAVLM_B32_SHAPE", dict(n_wavs=3, seconds=1.0))
    extracted = cs.phase_extraction(str(tmp_path), "card")
    assert set(extracted["utt_per_sec"]) == {"bfloat16_cold", "bfloat16_warm", "float32_cold", "float32_warm"}
    assert extracted["b32_bf16"]["utt_per_sec"] > 0 and "b32_f32" in extracted
    cs.phase_scoring(str(tmp_path), extracted)
    launches = cs.counts()
    # 4 CLI runs + the B=32 bf16 warm-up and timed run + the f32 warm-up, x 2 layers x 1 batch
    assert launches["attention_btd"] == 7 * 2
    assert launches["conv_frontend"] == 7 and launches["gru_bidir"] > 0
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
    assert len(step["score"]["score_batch_ms_runs"]) == 5  # scoring's eval forward of the same batch
    assert ops_gru.BiGRU.forward is ops_gru.BiGRU.forward_stacked  # the plain route is undone


def test_lora_phases_on_cpu(tmp_path, monkeypatch):
    """Phase 7 at a tiny size: Whisper extraction, ft_lora and the
    *_pretrained CLIs for Whisper and WavLM, the gradient check and the
    bf16 and f32 steps. Attention that needs a gradient goes through AttentionBtdTrain
    (here with the plain backward, counted as K4), as it does on the card."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech, whisper
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc

    def tiny_wavlm(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    def tiny_whisper(dtype="float32"):
        return whisper.WhisperEncoderConfig(num_mel_bins=16, d_model=128, encoder_layers=2,
                                            encoder_attention_heads=2, encoder_ffn_dim=256, dtype=dtype)

    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting_conv(*args, **kw):
        kc.LAUNCHES += 1
        return kc.conv_frontend_plain(*args, **kw)

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "LORA_SHAPE", dict(n_train=16, n_dev=8, seconds=(0.5, 1.5), steps=2))
    monkeypatch.setattr(speech, "wavlm_large", tiny_wavlm)
    monkeypatch.setattr(whisper, "whisper_large_v3", tiny_whisper)
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    for mod in (speech, whisper):
        monkeypatch.setattr(mod, "dot_product_attention_btd", routed)
    monkeypatch.setattr(speech, "conv_frontend", counting_conv)
    for mod, counter in ((ka, "LAUNCHES"), (ka, "BWD_LAUNCHES"), (kc, "LAUNCHES")):
        monkeypatch.setattr(mod, counter, 0)

    tmp = str(tmp_path)
    wavlm_dir = os.path.join(tmp, "wavlm-large")
    cs.write_wavlm_large(wavlm_dir)
    w = cs.phase_whisper_extraction(tmp)
    assert set(w["utt_per_sec"]) == {"bfloat16", "float32"}
    cs.phase_lora(tmp, w, wavlm_dir)
    launches = cs.counts()
    # K4: 2 layers x 2 steps for each fine-tune
    assert launches["attention_btd_bwd"] == 2 * 2 + 2 * 2
    assert launches["attention_btd"] > 0 and launches["conv_frontend"] > 0
    grads = cs.check_lora_grads(tmp, w, wavlm_dir)
    assert set(grads) == {"whisper", "wavlm"} and max(grads.values()) <= 1e-4
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        steps = cs.time_lora_steps(w, dtype)
        assert len(steps[f"{tag}_step_ms_runs"]) == 2 and all(np.isfinite(steps[f"{tag}_losses"]))


def test_text_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 8 at a tiny size (RoBERTa and DeBERTa at D=64, 20 transcripts,
    one batch each): the HF directories, the synthetic BPE and SentencePiece
    files, the CLIs, the launch counts (K7 through a counting plain
    version; K6 likewise on the SER_TPU_ATTN_IMPL=flash run) and the checks
    against the reference forwards."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import text
    from interspeech_ser_tpu_torch.ops import attention_core
    from interspeech_ser_tpu_torch.ops.kernels import attention_bhtd as kb

    def tiny_roberta(dtype="float32"):
        return text.RobertaConfig(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, dtype=dtype)

    def tiny_deberta(dtype="float32"):
        return text.DebertaV2Config(vocab_size=4000, hidden_size=64, num_heads=4, intermediate_size=128, dtype=dtype)

    def counting(counter, plain):
        def launch(*args, **kw):
            setattr(kb, counter, getattr(kb, counter) + 1)
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TEXT_SHAPE", dict(n_texts=20, words=(0, 121), max_len=80, n_words=300,
                                               deberta_layers=2))
    monkeypatch.setattr(text, "roberta_large", tiny_roberta)
    monkeypatch.setattr(text, "deberta_v2_xxlarge", tiny_deberta)
    monkeypatch.setattr(attention_core, "attention_bhtd", counting("LAUNCHES", kb.attention_bhtd_plain))
    monkeypatch.setattr(attention_core, "flash_attention", counting("FLASH_LAUNCHES", kb.flash_attention_plain))
    monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    for counter in ("LAUNCHES", "FLASH_LAUNCHES"):
        monkeypatch.setattr(kb, counter, 0)

    out = cs.phase_text(str(tmp_path), "a card, 700 W")
    assert set(out["texts_per_sec"]) == {"roberta_float32_cold", "roberta_float32_warm", "roberta_bfloat16_cold",
                                         "roberta_bfloat16_warm", "roberta_float32_flash", "deberta_float32",
                                         "deberta_bfloat16"}
    launches = cs.counts()
    assert (launches["attention_bhtd"], launches["flash_attention"]) == (4 * 2, 2)  # 4 default runs x 2 layers
    assert out["k6_vs_k7_max_abs"] <= 1e-5
    assert "SER_TPU_ATTN_IMPL" not in os.environ


def test_zoo_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 9 at a tiny size: XLS-R-2B-, HuBERT-XL- and wavlm-base-plus-shaped
    encoders (head dims 120, 80 and 64; layer-norm and group-norm frontends,
    pre- and post-LN stacks) through ``preprocess_cli speech``, the
    SER_TPU_FFN_KERNEL=1 SER_TPU_FRONTEND=3 run, the plain-pipeline
    comparisons, the full-depth run, ``lora_cli`` and a kernel-vs-plain
    gradient step over the HuBERT-XL and XLS-R-2B shapes, and ``lora_cli``
    over the base shape.
    K1, K2, K5 and K8 go through counting plain versions, attention that
    needs a gradient through AttentionBtdTrain (its backward counted as K4)."""
    import dataclasses

    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc, ffn_fused as kf
    from interspeech_ser_tpu_torch.ops.kernels import pos_conv as kp

    narrow = dict(conv_dim=(32,) * 4, conv_kernel=(10, 4, 4, 4), conv_stride=(5, 4, 4, 4), num_conv_pos_embeddings=16,
                  conv_pos_groups=4, num_buckets=32, max_distance=64)

    def tiny_xlsr(dtype="float32"):
        return dataclasses.replace(speech.SpeechConfig(
            hidden_size=240, num_layers=2, num_heads=2, intermediate_size=480, conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, **narrow), dtype=dtype)

    def tiny_hubert(dtype="float32"):
        return dataclasses.replace(tiny_xlsr(dtype), hidden_size=160, intermediate_size=320, model_type="hubert")

    def tiny_base(dtype="float32"):
        return speech.SpeechConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                                   attention_type="wavlm", dtype=dtype, **narrow)

    def counting(mod, plain):
        def launch(*args, **kw):
            mod.LAUNCHES += 1
            return plain(*args, **kw)
        return launch

    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting_conv(wav, layers, *args, **kw):  # K2 launches its layer-0 kernel, then one per later layer
        kc.LAUNCHES += 1
        kc.LAYER_LAUNCHES += len(layers) - 1
        return kc.conv_frontend_plain(wav, layers, *args, **kw)

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "ZOO_SHAPE", dict(xlsr_layers=2, hubert_layers=1, n_wavs=4, seconds=(0.5, 1.5),
                                              full_wavs=2, full_seconds=1.0))
    monkeypatch.setattr(cs, "LORA_SHAPE", dict(n_train=16, n_dev=8, seconds=(0.5, 1.5), steps=2))
    monkeypatch.setattr(cs, "wavlm_base_plus", tiny_base)
    monkeypatch.setattr(speech, "wav2vec2_xlsr_2b", tiny_xlsr)
    monkeypatch.setattr(speech, "hubert_xlarge", tiny_hubert)
    monkeypatch.setattr(speech, "dot_product_attention_btd", routed)
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    monkeypatch.setattr(speech, "conv_frontend", counting_conv)
    monkeypatch.setattr(speech, "ffn_fused", counting(kf, kf.ffn_fused_plain))
    monkeypatch.setattr(speech, "pos_conv", counting(kp, kp.pos_conv_plain))
    for mod, counter in ((ka, "LAUNCHES"), (ka, "BWD_LAUNCHES"), (kc, "LAUNCHES"), (kc, "LAYER_LAUNCHES"),
                         (kf, "LAUNCHES"), (kp, "LAUNCHES")):
        monkeypatch.setattr(mod, counter, 0)
    for key in ("SER_TPU_FFN_KERNEL", "SER_TPU_FRONTEND"):
        monkeypatch.delenv(key, raising=False)

    out = cs.phase_zoo(str(tmp_path), "a card, 700 W")
    assert set(out["xlsr_2b"]["utt_per_sec"]) == {"bfloat16_cold", "bfloat16_warm", "float32_cold", "float32_warm"}
    assert out["xlsr_2b"]["k5_min_cos"] >= 0.999
    assert out["xlsr_2b_full"]["utt_per_sec"] > 0
    assert set(out["hubert_xl"]["utt_per_sec"]) == {"float32_once"}
    assert out["hubert_xl"]["lora_grad_rel_err"] <= 1e-4 and out["xlsr_2b"]["lora_grad_rel_err"] <= 1e-4
    launches = cs.counts()
    # K5: 2 layers x 1 batch on the SER_TPU_FFN_KERNEL=1 run; K4: 1 layer x 2 steps of lora_cli and
    # 1 layer of the gradient check over each of HuBERT-XL and XLS-R-2B, 2 layers x 2 steps over the base
    assert launches["ffn_fused"] == 2 and launches["attention_btd_bwd"] == 2 * (1 * 2 + 1) + 2 * 2
    # K8 once a batch of every extraction (5 XLS-R CLI runs, 2 full-depth runs, 1 HuBERT run, 2 base
    # runs; training leaves it off); K2 on every layer-norm run (the extractions, and each of the two
    # layer-norm fine-tunes' 2 steps, dev batch and kernel-route gradient step), never on the base
    # shape, its later layers only on the SER_TPU_FRONTEND=3 run (2 layers x 1 batch)
    assert launches["pos_conv"] == 5 + 2 + 1 + 2 and launches["conv_frontend"] == 5 + 2 + 1 + 2 * (2 + 1 + 1)
    assert launches["conv_frontend_layer"] == 2
    assert os.path.exists(out["wavlm_base_plus"]["lora_ckpt"])
    assert not any(k in os.environ for k in ("SER_TPU_FFN_KERNEL", "SER_TPU_FRONTEND"))


def test_ns3_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 10 over a tiny corpus: the reference-named FACodec checkpoints,
    ``ns3_prosody`` (cold, warm), ``ns3_prosody_speaker`` (cold, warm) and
    ``--codes`` with their file checks, the batched / batch-1 / CPU
    comparisons, the trimodal config, ``cli train`` and ``eval`` with
    ``--trimodal`` and the step timing. The FACodec encoder runs at ngf 8
    (its other widths and its hop as on the card); K3 / K3b go through
    counting plain versions."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models.ns3 import facodec
    from interspeech_ser_tpu_torch.ops import gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import gru as kg

    def counting(counter, plain):
        def launch(*args, **kw):
            setattr(kg, counter, getattr(kg, counter) + 1)
            return plain(*args, **kw)
        return launch

    small = dict(fusion_hidden_dim=16, batch_size=4)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    # 8 dev rows, one of each class: any prediction scores a macro-F1 above 0, so the trainer saves
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(n_train=8, n_dev=8, feat_dim=24, speech_len=(30, 70),
                                                text_len=(5, 20), epochs=1, config=small))
    # the trimodal run at lr 1e-2, so that its 4 steps learn the class means and the trainer saves a checkpoint
    # (the NS3 rows differ by utterance, so an untrained model may miss all 8 dev rows)
    monkeypatch.setattr(cs, "NS3_SHAPE", dict(seconds=(1.3, 1.6), first_seconds=0.5, n_speaker=3, min_codes=32,
                                              batch_size=4, profile_wavs=2, profile_seconds=0.5, whisper_dim=20,
                                              epochs=2, config=dict(small, lr=1e-2)))
    monkeypatch.setattr(facodec.FACodecEncoderV2Model.__init__, "__defaults__", (8, (2, 4, 5, 5), 256))
    monkeypatch.setattr(kg, "gru_bidir_carries", counting("LAUNCHES", kg.gru_bidir_carries_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries_bwd", counting("BWD_LAUNCHES", kg.gru_bidir_carries_bwd_plain))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    monkeypatch.setattr(kg, "LAUNCHES", 0)
    monkeypatch.setattr(kg, "BWD_LAUNCHES", 0)

    ns3 = cs.phase_ns3(str(tmp_path), cs.write_train_corpus(str(tmp_path)), "a card, 700 W")
    assert set(ns3["utt_per_sec"]) == {"prosody_cold", "prosody_warm", "speaker_cold", "speaker_warm",
                                       "speaker_first3"}
    assert ns3["max_abs"]["batched_vs_batch1"] <= 3e-4 and ns3["max_abs"]["short_prosody"] <= 3e-4
    assert ns3["max_abs"]["latents_batched_vs_batch1"] <= 1e-4
    assert ns3["distinct"]["codes"] >= 32 and ns3["distinct"]["prosody_rows"] >= 32
    assert not any(cs.counts().values())  # NS3 extraction launches no kernel
    tri = cs.phase_train(ns3["config_path"], trimodal=True)
    assert tri["n_modalities"] == 3 and tri["steps"] == 2 * 2
    assert cs.counts()["gru_bidir_bwd"] == 3 * 4 and cs.counts()["gru_bidir"] > 0
    step = cs.time_trimodal_step(ns3["config_path"], "a card, 700 W")
    assert len(step["train_step_ms_runs"]) == 5


def test_baseline_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 11 at a tiny size (WavLM at D=128 over 2 layers with a 3-layer
    frontend, 8 train / 4 dev / 2 test3 wavs of 0.5-1.5 s, micro-batches of
    4): ``baseline.cli`` train and eval for ``cat`` and ``dim``, the K4
    count, the frontend and gated-bias checks, the reload, batched vs
    batch-1, the gradient check and the step timings. Attention that needs a
    gradient goes through AttentionBtdTrain with the plain backward, counted
    as K4, as it does on the card."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc

    def tiny_wavlm(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting_conv(*args, **kw):
        kc.LAUNCHES += 1
        return kc.conv_frontend_plain(*args, **kw)

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "BASELINE_SHAPE", dict(
        n_train=8, n_dev=4, n_test3=2, seconds=(0.5, 1.5), batch_size=8, accumulation_steps=2, lr=1e-5,
        head_dim=16, epochs=1, grad_rows=4, grad_live=3, steps=2))
    monkeypatch.setattr(speech, "wavlm_large", tiny_wavlm)
    monkeypatch.setattr(speech, "dot_product_attention_btd", routed)
    monkeypatch.setattr(speech, "conv_frontend", counting_conv)
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    for mod, counter in ((ka, "LAUNCHES"), (ka, "BWD_LAUNCHES"), (kc, "LAUNCHES")):
        monkeypatch.setattr(mod, counter, 0)

    tmp = str(tmp_path)
    wavlm_dir = os.path.join(tmp, "wavlm-large")
    cs.write_wavlm_large(wavlm_dir)
    base = cs.phase_baseline(tmp, wavlm_dir)
    launches = cs.counts()
    # K4: 2 tasks x 2 layers x 2 micro-batches; K2 once a forward
    assert base["micro_batches"] == 2 and launches["attention_btd_bwd"] == 2 * 2 * 2
    assert launches["attention_btd"] > 0 and launches["conv_frontend"] > 0
    assert set(base["tasks"]) == {"cat", "dim"} and base["tasks"]["cat"]["batch1"]["utterances"] >= 2
    assert all(t["reload_max_abs"] <= 1e-5 and t["rel_attn_embed_moved"] > 0 for t in base["tasks"].values())
    grads = cs.check_baseline_grads(tmp, wavlm_dir, base["config_path"])
    assert grads["cat"]["worst"] <= 1e-4 and grads["dim"]["calls_worst_cosine"] >= 0.999
    assert grads["cat"]["k2_max_abs"] <= 1e-4 and grads["dim"]["k2_cosine"] >= 0.999
    assert grads["dim"]["grad_rel_l2_vs_plain_bf16"] <= 0.3
    steps = cs.time_baseline_steps(wavlm_dir, base["config_path"], "a card, 700 W")
    assert len(steps["f32_micro_step_ms_runs"]) == 2 and len(steps["bf16_micro_step_ms_runs"]) == 2
    assert steps["inference_s_per_audio_s"] > 0


def test_transcribe_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 12 at a tiny size (Whisper at D=64 over 2 + 2 layers, 300 BPE
    tokens before Whisper-large-v3's 1,609 added ones, 5 wavs of 0.5-1.5 s
    and one of 31 s at 16 / 22.05 / 44.1 / 8 kHz, batches of 2, 6 new
    tokens): the model directory and tokenizer files, ``transcribe_cli`` in
    bf16 and f32 with the CSV and native-loader checks, K1 = layers x
    batches, then checks (d)-(f) and the timings."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import whisper, whisper_decoder
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka

    n_regular = 300
    n_added = len(cs.whisper_added_tokens())

    def tiny_whisper(dtype="float32"):
        return whisper.WhisperEncoderConfig(num_mel_bins=16, d_model=64, encoder_layers=2, encoder_attention_heads=2,
                                            encoder_ffn_dim=128, dtype=dtype)

    def tiny_decoder(dtype="float32"):
        return whisper_decoder.WhisperDecoderConfig(vocab_size=n_regular + n_added, d_model=64, decoder_layers=2,
                                                    decoder_attention_heads=2, decoder_ffn_dim=128, dtype=dtype)

    def counting(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if not plain:
            ka.LAUNCHES += 1
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRANSCRIBE_SHAPE", dict(
        n_wavs=6, seconds=(0.5, 1.5), long_index=3, long_seconds=31.0, rates=(16000, 22050, 44100, 8000),
        batch_size=2, max_new_tokens=6, regular_tokens=n_regular, n_suppress=10, recompute_tokens=3,
        profile_steps=2))
    monkeypatch.setattr(whisper, "whisper_large_v3", tiny_whisper)
    monkeypatch.setattr(whisper_decoder, "whisper_large_v3_decoder", tiny_decoder)
    monkeypatch.setattr(whisper, "dot_product_attention_btd", counting)
    cs.zero_counts()

    tmp = str(tmp_path)
    tr = cs.run_transcription(tmp, "a card, 700 W")
    launches = cs.counts()
    assert launches["attention_btd"] == 2 * (3 + 3)  # 2 layers x 3 batches, in bf16 and in f32
    assert not any(v for k, v in launches.items() if k != "attention_btd")
    assert tr["names"] == [f"tr{i:02d}.wav" for i in range(6)] and tr["wavs"]["tr03.wav"] == (31.0, 8000)
    for run in tr["runs"].values():
        assert len(run["stats"].rows) == 6 and run["stats"].tokens[0].shape == (2, 4 + 6)
    res = cs.check_transcription(tr, "a card, 700 W")
    assert res["d"]["max_gap"] <= cs.TIE_GAP and res["d"]["steps"] >= 2
    assert res["e"]["equal"] and res["e"]["same_as_cli"]
    assert res["f"]["min_cos"] >= cs.BF16_STEP_COSINE and res["f"]["n"] == 2 * 6
    fp = res["f_products"]
    assert fp["n"] == 4 * 2 and fp["max_rel"] <= cs.F32_PRODUCT_REL < fp["rounded_min_rel"]
    assert sorted(tr["load_s"]) == [8000, 16000, 22050, 44100]
    assert all(v["native_s"] > 0 and v["python_s"] > 0 for v in tr["load_s"].values())
    for run in tr["runs"].values():
        st = run["stats"]
        assert 0 < st.emitted_tokens <= 6 * 6 and st.tokens_per_sec <= st.slots_per_sec
    for dtype in ("bfloat16", "float32"):
        t = res[dtype]
        assert t["encoder_ms"] > 0 and t["cross_kv_ms"] > 0 and t["step_ms"] > 0 and t["bound_by"] == "bytes"


def test_legacy_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 13 at a tiny size (phase 6's corpus at feature dim 24, H=16,
    batch 4): every LEGACY_RUNS entry through ``cli.main``, the per-run K3 /
    K3b counts, CSVs, checkpoints and the fromcat warm start, then the
    kernel-vs-plain gradient checks and the step timings."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.ops import gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import gru as kg
    from interspeech_ser_tpu_torch.train.engine import FusionEngine
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    def counting(counter, plain):
        def launch(*args, **kw):
            setattr(kg, counter, getattr(kg, counter) + 1)
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(
        n_train=12, n_dev=16, feat_dim=24, speech_len=(30, 70), text_len=(5, 20), epochs=2,
        config=dict(fusion_hidden_dim=16, batch_size=4, lr=1e-2),  # a dev F1 above 0 after one epoch: a checkpoint
    ))
    monkeypatch.setattr(kg, "gru_bidir_carries", counting("LAUNCHES", kg.gru_bidir_carries_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries_bwd", counting("BWD_LAUNCHES", kg.gru_bidir_carries_bwd_plain))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    monkeypatch.setattr(kg, "LAUNCHES", 0)
    monkeypatch.setattr(kg, "BWD_LAUNCHES", 0)

    config_path = cs.write_train_corpus(str(tmp_path))
    cfg = load_fusion_config(config_path)  # phase 6's cat checkpoint, the fromcat run's warm start
    os.makedirs(cfg.model_path)
    FusionEngine(cfg, seed=3, device="cpu").save_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"))

    cs.zero_counts()
    legacy = cs.phase_legacy(str(tmp_path), config_path)
    runs = legacy["runs"]
    assert list(runs) == [stem for stem, _ in cs.LEGACY_RUNS]
    # 3 train steps + 4 dev batches a train run at batch 4; the MoE's 4 experts, 2 modalities
    assert runs["train_cat_bimodal_lazy_moe"]["launches"]["gru_bidir"] == 4 * 2 * (3 + 4)
    assert runs["train_cat_bimodal_lazy_moe"]["launches"]["gru_bidir_bwd"] == 4 * 2 * 3
    assert runs["eval_cat_bimodal_lazy_moe"]["launches"]["gru_bidir"] == 4 * 2 * 4
    assert runs["train_cat_wavlm_lazy"]["launches"]["gru_bidir"] == 0
    assert runs["train_dim_bimodal_lazy_fromcat"]["warm_start_skipped"] == ["classifier.3.weight", "classifier.3.bias"]
    assert runs["train_cat_bimodal_lazy_moe"]["flat_keys"] and not runs["train_cat_bimodal_lazy_fiona"]["flat_keys"]
    assert runs["test_dim_bimodal_lazy"]["rows"] == 16
    assert cs.counts()["gru_bidir"] == sum(r["launches"]["gru_bidir"] for r in runs.values())

    steps = cs.check_legacy_steps(legacy, "card")
    assert all(steps[stem]["grad_rel_err"] <= 1e-4 for stem in cs.LEGACY_GRAD_CHECKS)
    assert len(steps["train_cat_bimodal_lazy_moe"]["train_step_ms_runs"]) == 5
    assert len(steps["train_cat_bimodal_lazy_moe"]["score"]["score_batch_ms_runs"]) == 5
    assert ops_gru.BiGRU.forward is ops_gru.BiGRU.forward_stacked  # the plain route is undone


def test_joint_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 14 at a tiny size (WavLM at D=128 over 2 layers, RoBERTa-large and
    -base shapes at D=64 / 48 over 2 / 3 layers, phase 11's corpus at 8 train /
    4 dev wavs, micro-batches of 4): every JOINT_RUNS stem through
    ``joint_cli.main`` with its launches against the prediction (K1 / K4
    through AttentionBtdTrain with the plain backward, K2, K8 and K7 through
    counting plain versions), the reloads, batched vs batch-1, the timings
    and the ftall gradient check."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech, text
    from interspeech_ser_tpu_torch.ops import attention_core
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, attention_bhtd as kb
    from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as kc, pos_conv as kp

    def tiny_wavlm(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting(mod, plain):
        def launch(*args, **kw):
            mod.LAUNCHES += 1
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "BASELINE_SHAPE", dict(
        n_train=8, n_dev=4, n_test3=2, seconds=(0.5, 1.5), batch_size=8, accumulation_steps=2, lr=1e-5,
        head_dim=16, epochs=1, grad_rows=4, grad_live=3, steps=2))
    monkeypatch.setattr(cs, "JOINT_SHAPE", dict(batch_size=8, accum_step=2, epochs=1, lr=1e-3, head_dim=16,
                                                words=(0, 60), grad_rows=4, grad_live=3, steps=2))
    monkeypatch.setattr(speech, "wavlm_large", tiny_wavlm)
    monkeypatch.setattr(text, "roberta_large", lambda dtype="float32": text.RobertaConfig(
        hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, dtype=dtype))
    monkeypatch.setattr(cs, "roberta_base", lambda dtype="float32": text.RobertaConfig(
        hidden_size=48, num_layers=3, num_heads=3, intermediate_size=96, dtype=dtype))
    monkeypatch.setattr(speech, "dot_product_attention_btd", routed)
    monkeypatch.setattr(speech, "conv_frontend", counting(kc, kc.conv_frontend_plain))
    monkeypatch.setattr(speech, "pos_conv", counting(kp, kp.pos_conv_plain))
    monkeypatch.setattr(attention_core, "attention_bhtd", counting(kb, kb.attention_bhtd_plain))
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    monkeypatch.delenv("SER_TPU_FRONTEND", raising=False)
    for mod, counter in ((ka, "LAUNCHES"), (ka, "BWD_LAUNCHES"), (kc, "LAUNCHES"), (kp, "LAUNCHES"),
                         (kb, "LAUNCHES")):
        monkeypatch.setattr(mod, counter, 0)

    tmp = str(tmp_path)
    wavlm_dir, roberta_dir = os.path.join(tmp, "wavlm-large"), os.path.join(tmp, "roberta-large")
    cs.write_wavlm_large(wavlm_dir)
    cs.write_text_model(roberta_dir, text.RobertaModel, text.roberta_large(), "RobertaModel")
    cs.write_bpe_files(roberta_dir, cs.synthetic_words(cs.SEED + 6), text.roberta_large().vocab_size)
    config_path = cs.write_baseline_corpus(tmp)
    cs.zero_counts()
    joint = cs.phase_joint(tmp, config_path, wavlm_dir, roberta_dir)
    runs = joint["runs"]
    assert list(runs) == list(cs.JOINT_RUNS) and joint["n_micro"] == 2 and joint["dev_batches"] == 1
    # frozen: 2 micro-batches + 1 dev batch; K7 = RoBERTa layers (base 3, large 2) x batches
    assert runs["train_cat_roberta_wavlm"]["launches"]["attention_bhtd"] == 3 * 3
    assert runs["train_cat_roberta_wavlm_large"]["launches"]["attention_bhtd"] == 2 * 3
    ftall = runs["train_cat_roberta_wavlm_ftall"]["launches"]
    assert (ftall["attention_btd"], ftall["attention_btd_bwd"], ftall["attention_bhtd"], ftall["pos_conv"]) == \
        (2 * 3, 2 * 2, 3 * 1, 0)
    assert runs["train_cat_roberta"]["launches"] == {**dict.fromkeys(cs.KERNELS, 0), "attention_bhtd": 3}
    assert cs.counts() == {k: sum(r["launches"][k] for r in runs.values()) for k in cs.KERNELS}
    assert runs["train_cat_roberta_wavlm_ftall"]["files"]["final_ssl.pt"] > 0
    checks = cs.check_joint_runs(joint, "a card, 700 W")
    assert set(checks) == set(cs.JOINT_RUNS)
    assert all(c["reload_max_abs"] <= 1e-5 and c["batch1_max_abs"] <= 1e-4 for c in checks.values())
    assert all(len(checks[s]["step_ms_runs"]) == 2 for s in cs.JOINT_TIMED)
    grads = cs.check_joint_grads(tmp, wavlm_dir, joint)
    assert grads["worst"] <= 1e-4 and grads["tensors"] > 50


def test_info_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 15 at a tiny size: phase 6's corpus at 16 + 16 rows of dim 24,
    the proto stems cut to 2 rows a class (8 a gender), the melspec corpus at
    16 + 16 wavs of 0.3-0.6 s, ProtoAngularEngine at C x U = 16, phase 11's
    corpus and a 2-layer WavLM for the legacy trainers, phase 14's corpus
    for the joint run; K3 / K3b through counting plain versions, K1 / K4 / K2
    / K7 / K8 as the joint rehearsal counts them. Checks each run's launches
    against the prediction, the reloads, the reference-encoder gradient check
    and the step timings."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech, text
    from interspeech_ser_tpu_torch.ops import attention_core, gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, attention_bhtd as kb
    from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as kc, gru as kg, pos_conv as kp
    from interspeech_ser_tpu_torch.train import proto_engine as pe

    def tiny_wavlm(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting(mod, plain, counter="LAUNCHES"):
        def launch(*args, **kw):
            setattr(mod, counter, getattr(mod, counter) + 1)
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(
        n_train=16, n_dev=16, feat_dim=24, speech_len=(10, 30), text_len=(5, 10), epochs=1, config={}))
    monkeypatch.setattr(cs, "INFO_SHAPE", dict(n_train=16, n_dev=16, seconds=(0.3, 0.6), proto_epochs=2,
                                               angular_utter=2, steps=2, tp_prob=0.9, grad_rows=16, ce_batch=8))
    for variant, cut in (("wavlm_only", dict(U=2, U_val=2)), ("wavlm_ce", dict(U=2, U_val=2)),
                         ("melspec_only", dict(U=2, U_val=2)), ("melspec_only_gender", dict(U=8, U_val=8)),
                         ("wavlm_only_gender", dict(U=8, U_val=8))):
        monkeypatch.setitem(pe._PROTO_VARIANTS, variant, {**pe._PROTO_VARIANTS[variant], **cut})
    monkeypatch.setattr(cs, "BASELINE_SHAPE", dict(
        n_train=8, n_dev=4, n_test3=2, seconds=(0.5, 1.5), batch_size=8, accumulation_steps=2, lr=1e-5,
        head_dim=16, epochs=1, grad_rows=4, grad_live=3, steps=2))
    monkeypatch.setattr(cs, "JOINT_SHAPE", dict(batch_size=8, accum_step=2, epochs=1, lr=1e-3, head_dim=16,
                                                words=(0, 60), grad_rows=4, grad_live=3, steps=2))
    monkeypatch.setattr(speech, "wavlm_large", tiny_wavlm)
    monkeypatch.setattr(text, "roberta_large", lambda dtype="float32": text.RobertaConfig(
        hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, dtype=dtype))
    monkeypatch.setattr(cs, "roberta_base", lambda dtype="float32": text.RobertaConfig(
        hidden_size=48, num_layers=3, num_heads=3, intermediate_size=96, dtype=dtype))
    monkeypatch.setattr(speech, "dot_product_attention_btd", routed)
    monkeypatch.setattr(speech, "conv_frontend", counting(kc, kc.conv_frontend_plain))
    monkeypatch.setattr(speech, "pos_conv", counting(kp, kp.pos_conv_plain))
    monkeypatch.setattr(attention_core, "attention_bhtd", counting(kb, kb.attention_bhtd_plain))
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    monkeypatch.setattr(kg, "gru_bidir_carries", counting(kg, kg.gru_bidir_carries_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries_bwd", counting(kg, kg.gru_bidir_carries_bwd_plain, "BWD_LAUNCHES"))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    monkeypatch.delenv("SER_TPU_FRONTEND", raising=False)
    for spec in cs.KERNELS.values():
        monkeypatch.setattr(spec["module"], spec.get("counter", "LAUNCHES"), 0)

    tmp = str(tmp_path)
    train_config = cs.write_train_corpus(tmp)
    wavlm_dir, roberta_dir = os.path.join(tmp, "wavlm-large"), os.path.join(tmp, "roberta-large")
    cs.write_wavlm_large(wavlm_dir)
    cs.write_text_model(roberta_dir, text.RobertaModel, text.roberta_large(), "RobertaModel")
    cs.write_bpe_files(roberta_dir, cs.synthetic_words(cs.SEED + 6), text.roberta_large().vocab_size)
    baseline_config = cs.write_baseline_corpus(tmp)
    corpus = cs.write_joint_corpus(tmp, baseline_config, wavlm_dir, roberta_dir)
    large = "train_cat_roberta_wavlm_large"
    joint = {"configs": corpus["configs"], "runs": {large: {"predicted": cs.predict_joint_launches(
        "large", 2, 2, n_micro=2, dev_batches=1, text_dev_batches=1)}}}

    cs.zero_counts()
    info = cs.phase_info(tmp, train_config, baseline_config, wavlm_dir, joint)
    runs = info["runs"]
    assert list(runs) == list(cs.PROTO_RUNS) + ["ProtoAngularEngine", "train_cat_baselinelike_focalloss",
                                                "train_cat_baselinelike_xvector", "joint large + timbre"]
    assert cs.counts() == {k: sum(r["launches"][k] for r in runs.values()) for k in cs.KERNELS}
    # the reference encoder: 2 epochs x (1 step + 1 val batch) K3, 2 K3b; no kernel under ProtoSERNet
    assert runs["train_cat_melspec_lazy_protoangularloss_only_gender"]["launches"]["gru_bidir"] == 4
    assert runs["train_cat_melspec_lazy_protoangularloss_only_gender"]["launches"]["gru_bidir_bwd"] == 2
    for stem in ("train_cat_wavlm_lazy_protoangularloss_only", "train_cat_wavlm_lazy_protoangularloss",
                 "train_cat_melspec_lazy_protoangularloss_only", "train_cat_wavlmlarge_lazy_protoangularloss_only_gender",
                 "train_cat_baselinelike_xvector"):
        assert not any(runs[stem]["launches"].values()), stem
    assert runs["ProtoAngularEngine"]["launches"]["gru_bidir"] == 1 + 1  # 1 step + 1 embed batch
    # the baseline: 2 layers x (2 micro-batches + 1 dev batch) K1, 2 x 2 K4, K2 once a forward
    focal = runs["train_cat_baselinelike_focalloss"]["launches"]
    assert (focal["attention_btd"], focal["attention_btd_bwd"], focal["conv_frontend"]) == (6, 4, 3)
    assert runs["train_cat_baselinelike_focalloss"]["perturbed"] > 0
    assert runs["train_cat_melspec_lazy_protoangularloss_only"]["perturbed"] > 0
    assert runs["joint large + timbre"]["perturbed"] > 0
    reloads = cs.check_info_reloads(info)
    assert max(reloads.values()) <= 1e-5 and len(reloads) == 6
    steps = cs.check_info_steps(info, "a card, 700 W")
    assert steps["grad_rel_err"] <= 1e-4 and len(steps["xvector_step_ms_runs"]) == 2
    assert ops_gru.BiGRU.forward is ops_gru.BiGRU.forward_stacked  # the plain route is undone


def test_decoder_and_adapter_phases_on_cpu(tmp_path, monkeypatch):
    """Phase 16 at a tiny size: (a) the FACodec checkpoints (the encoder at
    ngf 8, the full decoder and redecoder at 16 HiFiGAN channels) through the
    loaders, 2 x 0.5-s wavs, every decode / redecode check, the CPU
    comparison and the train-mode autoencode; no launch. (b) the wrapper's
    methods over a wavlm-base-plus-shaped (group norm, post-LN, 2 layers) and
    a WavLM-large-shaped (layer norm, pre-LN, 3 layers) directory, 2 steps of
    4 rows, each run's launches against ``predict_adapter_launches`` (K1, K2
    through counting plain versions, K4 through AttentionBtdTrain's counted
    plain backward), the gradient check on 2-layer copies and the prompt's
    batch-1 checks."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.models.ns3 import facodec
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc

    narrow = dict(conv_dim=(32,) * 4, conv_kernel=(10, 4, 4, 4), conv_stride=(5, 4, 4, 4), num_conv_pos_embeddings=16,
                  conv_pos_groups=4, num_buckets=32, max_distance=64)
    real_bwd = ka.attention_btd_bwd

    def counted_bwd(*args, **kw):
        ka.BWD_LAUNCHES += 1
        return real_bwd(*args, **kw)

    def routed(q, k, v, H, key_mask=None, scale=None, gate=None, shared_bias=None, plain=False):
        if plain:
            return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)
        ka.LAUNCHES += 1
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)):
            return ka.AttentionBtdTrain.apply(q, k, v, H, key_mask, scale, gate, shared_bias)
        return ka.attention_btd_plain(q, k, v, H, key_mask, scale, gate, shared_bias)

    def counting_conv(*args, **kw):
        kc.LAUNCHES += 1
        return kc.conv_frontend_plain(*args, **kw)

    small = dict(upsample_initial_channel=16)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "DECODE_SHAPE", dict(n_wavs=2, seconds=0.5, cpu_seconds=0.5, train_rows=2,
                                                 train_seconds=0.5, quantizer_dropout=0.5, spread_codes=32,
                                                 decoder=small, redecoder=small))
    monkeypatch.setattr(cs, "ADAPTER_SHAPE", dict(rows=4, seconds=(0.3, 0.6), steps=2, lr=1e-3, classes=2,
                                                  grad_layers=2))
    monkeypatch.setattr(facodec.FACodecEncoderV2Model.__init__, "__defaults__", (8, (2, 4, 5, 5), 256))
    monkeypatch.setattr(speech, "dot_product_attention_btd", routed)
    monkeypatch.setattr(speech, "conv_frontend", counting_conv)
    monkeypatch.setattr(ka, "attention_btd_bwd", counted_bwd)
    for key in ("SER_TPU_ATTN_IMPL", "SER_TPU_FRONTEND"):
        monkeypatch.delenv(key, raising=False)
    for spec in cs.KERNELS.values():
        monkeypatch.setattr(spec["module"], spec.get("counter", "LAUNCHES"), 0)

    tmp, smi = str(tmp_path), "a card, 700 W"
    out = cs.phase_decoder(tmp, smi)
    assert not any(cs.counts().values())
    assert out["max_abs"]["quantized_vs_codes"] <= 1e-5 and out["cpu"]["decode_max_abs"] == 0.0
    assert min(out["max_abs"][k] for k in ("decode_residual", "redecode_rolled_speaker", "redecode_residual")) > 1e-4
    assert out["train"]["without_finite_grad"] == [] and out["train"]["vq_loss_rel_err"] == 0.0
    assert len(out["decode_ms_runs"]) == 3 and out["distinct_codes"][1] > 1
    # the decoder file also feeds phase 10's prosody extractor
    from interspeech_ser_tpu_torch.models.loader import build_prosody_extractor

    paths = [os.path.join(tmp, "facodec_full", n) for n in ("ns3_facodec_encoder_v2.bin",
                                                            "ns3_facodec_decoder_v2_full.bin")]
    assert build_prosody_extractor(paths[1], paths[0], with_speaker=True) is not None

    cs.write_speech_model(os.path.join(tmp, "wavlm-base-plus"), speech.SpeechConfig(
        hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, attention_type="wavlm", **narrow),
        "WavLMModel", do_normalize=False)
    cs.write_speech_model(os.path.join(tmp, "wavlm-large"), speech.SpeechConfig(
        hidden_size=64, num_layers=3, num_heads=2, intermediate_size=128, conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, attention_type="wavlm", **narrow), "WavLMModel")
    cs.zero_counts()
    adapters, kept = cs.phase_adapters(tmp, smi)
    runs = adapters["runs"]
    assert list(runs) == [f"{d}/{m}" for d, m in cs.ADAPTER_RUNS]
    assert cs.counts() == {k: sum(r["predicted"].get(k, 0) for r in runs.values()) for k in cs.KERNELS}
    # K4: 2 steps x 1 layer under adapters alone on the 2-layer base, x 2 layers under prompts, x 3 / 2 on large
    assert [r["launches"]["attention_btd_bwd"] for r in runs.values()] == [2, 2, 4, 4, 4, 6]
    assert [r["launches"]["conv_frontend"] for r in runs.values()] == [0, 0, 0, 0, 5, 3]
    assert all(r["base_unchanged"] and r["tuned_moved"] == r["trainable"] for r in runs.values())
    grads = cs.check_adapter_grads(tmp)
    assert set(grads) == {"wavlm-large", "wavlm-base-plus"} and max(g["worst"] for g in grads.values()) <= 1e-4
    assert all(g["tensors"] == 2 * 2 * 2 + 2 * 5 for g in grads.values())  # 2 layers x 2 LoRA pairs, 4 adapter + 1 prompt
    batch1 = cs.check_prompt_batch1(tmp, kept)
    assert max(batch1.values()) <= 1e-4


def test_parallel_predictions_and_audit_expectations():
    """Phase 17's launch predictions per rank and its audit expectations."""
    import chip_smoke as cs

    # fusion: every rank runs its rows of every batch, as the one process does
    assert cs.predict_parallel_launches("fusion", 1, 2, n_mod=2, train_batches=2, dev_batches=1) == {
        "gru_bidir": 6, "gru_bidir_bwd": 4}
    # data-parallel extraction: whole batches in turn, 5 batches over 2 ranks -> 3 and 2
    assert cs.predict_parallel_launches("dp_extract", 0, 2, batches=5, layers=24)["attention_btd"] == 24 * 3
    assert cs.predict_parallel_launches("dp_extract", 1, 2, batches=5, layers=24) == {
        "attention_btd": 48, "conv_frontend": 2, "pos_conv": 2}
    # tensor parallelism: every model rank runs every batch
    assert cs.predict_parallel_launches("tp_extract", 1, 2, batches=1, layers=24)["attention_btd"] == 24
    assert cs.predict_parallel_launches("lora", 0, 2, layers=24, steps=2, dev_batches=1) == {
        "attention_btd": 72, "attention_btd_bwd": 48, "conv_frontend": 3}
    from interspeech_ser_tpu_torch.parallel import audit

    rec = audit.empty_audit()
    cs.check_audit(rec, cs.expected_audit("one_rank"), "one rank")
    rec["all-reduce"] = {"count": 2, "elements": 2 * 100}
    rec["broadcast"] = {"count": 7, "elements": 100}
    cs.check_audit(rec, cs.expected_audit("train", steps=2, trainable=100), "dp")
    for bad in (dict(steps=3, trainable=100), dict(steps=2, trainable=99)):
        with pytest.raises(AssertionError):
            cs.check_audit(rec, cs.expected_audit("train", **bad), "dp")
    with pytest.raises(AssertionError):
        cs.check_audit(rec, cs.expected_audit("one_rank"), "one rank")
    rec = audit.empty_audit()
    rec["all-reduce"] = {"count": 2 * 24, "elements": 12345}
    cs.check_audit(rec, cs.expected_audit("tp_extract", layers=24, batches=1), "tp")


def test_parallel_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 17 at a tiny size on 2 gloo CPU ranks: a 2-layer WavLM with 4
    heads (TP=2: 2 a rank), phase 4's extraction through ``speech_main``,
    phase 6's corpus at H=16 and phase 7's wavs; every comparison, the
    audits and the report (launch counts are the card's: the CPU ranks run
    the plain versions)."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.preprocess_cli import speech_main

    def tiny(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(speech, "wavlm_large", tiny)
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(
        n_train=10, n_dev=6, feat_dim=24, speech_len=(30, 70), text_len=(5, 20), epochs=2,
        config=dict(fusion_hidden_dim=16, batch_size=4)))
    monkeypatch.setattr(cs, "LORA_SHAPE", dict(n_train=8, n_dev=2, seconds=(0.5, 1.5), steps=2))
    monkeypatch.setattr(cs, "PARALLEL_SHAPE", dict(cs.PARALLEL_SHAPE, budget_seconds=2))
    tmp = str(tmp_path)
    cs.write_wavlm_large(os.path.join(tmp, "wavlm-large"))
    cs.write_wavs(os.path.join(tmp, "wavs"), 6, (0.5, 1.5), cs.SEED)
    for dtype in ("bfloat16", "float32"):
        speech_main(["--ssl_type", os.path.join(tmp, "wavlm-large"), "--wav_dir", os.path.join(tmp, "wavs"),
                     "--save_path", os.path.join(tmp, f"feats_{dtype}"), "--dtype", dtype, "--device", "cpu"])
    config_path = cs.write_train_corpus(tmp)
    cs.write_lora_corpus(tmp)
    report = cs.phase_parallel(tmp, config_path, "card")
    assert report["world"] == 2 and report["nccl_world_1"] is None  # no card: no NCCL world
    assert report["fusion"]["rank0"]["param_max_abs"] <= report["fusion"]["one"]["param_bar"]
    assert report["fusion"]["rank1"]["audit"].startswith("collectives: all-reduce×")
    assert report["extract"]["dp"]["max_abs"] <= 1e-5 and report["extract"]["cli_f32"]["max_abs"] <= 1e-5
    assert report["extract"]["dp"]["audit_rank1"] == "collectives: all-reduce×1 (4 elems)"
    assert report["tp"]["cos_min"] >= 0.99999 and report["tp"]["rank1"]["heads"] == [2]
    assert report["one_audit"] == "collectives: NONE"
    assert report["lora"]["rank0"]["max_abs"] <= report["lora"]["one"]["bar"]


def _synthetic_trace():
    """A Chrome trace in the profiler's layout: two step spans on the host,
    launch calls of both categories inside and outside them, and the
    kernels they launched, one of them running past its span's end."""
    span = lambda name, ts, dur: dict(ph="X", cat="user_annotation", name=name, pid=1, tid=1, ts=ts, dur=dur)
    launch = lambda corr, ts, cat="cuda_runtime": dict(ph="X", cat=cat, name="cudaLaunchKernel", pid=1, tid=1, ts=ts,
                                                       dur=2, args={"correlation": corr})
    kernel = lambda corr, name, ts, dur: dict(ph="X", cat="kernel", name=name, pid=0, tid=7, ts=ts, dur=dur,
                                              args={"correlation": corr})
    gpu = lambda name, ts, dur: dict(ph="X", cat="gpu_user_annotation", name=name, pid=0, tid=7, ts=ts, dur=dur)
    return [
        span("extract_step_0", 100, 50), span("extract_step_1", 200, 50), span("other", 300, 10),
        launch(1, 110), launch(2, 120, "cuda_driver"), launch(3, 160), launch(4, 249), launch(5, 301),
        kernel(1, "void attention_btd_mma_kernel<64>(...)", 130, 20),
        kernel(2, "void pos_conv_wgmma_kernel<64>(...)", 150, 200),  # launched in step 0, runs past it
        kernel(3, "void attention_btd_mma_kernel<64>(...)", 205, 10),  # runs in step 1, launched between spans
        kernel(4, "void conv_frontend_mma_kernel<false>(...)", 360, 5),  # launched at step 1's end
        kernel(5, "void attention_btd_mma_kernel<64>(...)", 400, 5),  # another span's
        dict(ph="i", cat="kernel", name="marker", pid=0, tid=7, ts=210, args={}),
        gpu("extract_step_0", 130, 220), gpu("extract_step_1", 355, 10),
    ]


def test_kernels_by_span_on_a_synthetic_trace():
    import chip_smoke as cs

    events = _synthetic_trace()
    route, spans = cs.kernels_by_span(events, ["extract_step_0", "extract_step_1", "other"])
    assert route == "correlation" and [k["args"]["correlation"] for k in spans["other"]] == [5]
    assert [k["args"]["correlation"] for k in spans["extract_step_0"]] == [1, 2]
    assert [k["args"]["correlation"] for k in spans["extract_step_1"]] == [4]
    assert {n: cs.count_events(spans["extract_step_0"], names) for n, names in cs.LAUNCH_EVENTS.items()} == {
        "K1": 1, "K2": 0, "K8": 1}
    assert cs.launch_calls(events, spans["extract_step_0"] + [{"args": {"correlation": 99}}]) == {
        "cudaLaunchKernel": 2, "none": 1}
    # no launch call in the trace: the device ranges of the spans' names hold their kernels
    route, spans = cs.kernels_by_span([e for e in events if e["cat"] not in cs.LAUNCH_CATS],
                                      ["extract_step_0", "extract_step_1"])
    assert route == "gpu_user_annotation"
    assert [k["args"]["correlation"] for k in spans["extract_step_0"]] == [1, 2, 3]
    assert [k["args"]["correlation"] for k in spans["extract_step_1"]] == [4]
    assert cs.kernels_by_span(events, ["extract_step_0", "extract_step_1"], "gpu_user_annotation") == (route, spans)
    # a launch call 3 us into its host op and 3 us before its end; the synthetic calls name no op
    op = dict(ph="X", cat="cpu_op", name="aten::mm", pid=1, tid=1, ts=100, dur=10, args={"External id": 5})
    call = dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, ts=103, dur=4,
                args={"External id": 5, "correlation": 9})
    assert cs.clock_margins([op, call]) == (3, 3) and cs.clock_margins(events) == (None, None)


def test_profiling_phase_on_cpu(tmp_path, monkeypatch):
    """Phase 18's paths at a tiny size, in this process: ``profile_trace`` over a 2-layer WavLM and a
    2-layer Whisper encoder (their spans in the trace files), the fusion
    train steps under ``StepTimer`` with K3 / K3b counted, ``RTFMeter`` and
    ``SER_TPU_TRACE=0``. K1, K2, K8, K3 and K3b go through counting plain
    versions; kernel attribution needs the card's trace."""
    import chip_smoke as cs
    from interspeech_ser_tpu_torch import profile_trace
    from interspeech_ser_tpu_torch.models import speech, whisper
    from interspeech_ser_tpu_torch.ops import attention_core, gru as ops_gru
    from interspeech_ser_tpu_torch.ops.kernels import attention as ka, conv_frontend as kc, gru as kg, pos_conv as kp

    def tiny(dtype="float32"):
        return speech.SpeechConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
            feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
            num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype,
        )

    def tiny_whisper(dtype="float32"):
        return whisper.WhisperEncoderConfig(num_mel_bins=16, d_model=32, encoder_layers=2,
                                            encoder_attention_heads=2, encoder_ffn_dim=64, dtype=dtype)

    def counting(mod, counter, plain):
        def launch(*args, **kw):
            setattr(mod, counter, getattr(mod, counter) + 1)
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(speech, "wavlm_large", tiny)
    monkeypatch.setattr(whisper, "whisper_large_v3", tiny_whisper)
    monkeypatch.setattr(cs, "PROFILING_SHAPE", dict(wavlm_steps=2, batch=2, seconds=0.5, whisper_steps=1,
                                                    train_steps=1))
    monkeypatch.setattr(profile_trace, "WHISPER_ROWS", 1)
    monkeypatch.setattr(cs, "TRAIN_SHAPE", dict(
        n_train=4, n_dev=2, feat_dim=24, speech_len=(10, 20), text_len=(5, 10), epochs=1,
        config=dict(fusion_hidden_dim=16, batch_size=4)))
    monkeypatch.setattr(attention_core, "attention_btd", counting(ka, "LAUNCHES", ka.attention_btd_plain))
    monkeypatch.setattr(speech, "conv_frontend", counting(kc, "LAUNCHES", kc.conv_frontend_plain))
    monkeypatch.setattr(speech, "pos_conv", counting(kp, "LAUNCHES", kp.pos_conv_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries", counting(kg, "LAUNCHES", kg.gru_bidir_carries_plain))
    monkeypatch.setattr(kg, "gru_bidir_carries_bwd", counting(kg, "BWD_LAUNCHES", kg.gru_bidir_carries_bwd_plain))
    monkeypatch.setattr(ops_gru.BiGRU, "forward", ops_gru.BiGRU.forward_stacked)
    monkeypatch.delenv("SER_TPU_TRACE", raising=False)
    monkeypatch.delenv("SER_TPU_FRONTEND", raising=False)
    for spec in cs.KERNELS.values():
        monkeypatch.setattr(spec["module"], spec.get("counter", "LAUNCHES"), 0)

    tmp = str(tmp_path)
    config_path = cs.write_train_corpus(tmp)
    out = cs.profiling_paths(tmp, config_path, "a card, 700 W")
    launches = cs.counts()
    assert out["launches"] == launches
    # K1: 2 layers x 3 WavLM forwards + 2 x 2 Whisper; K2 and K8 once a WavLM forward;
    # K3 / K3b: 2 modalities x (warm-up + 2 x 1 timed + 1 traced + 1 traced-off step)
    assert (launches["attention_btd"], launches["conv_frontend"], launches["pos_conv"]) == (10, 3, 3)
    assert launches["gru_bidir"] == launches["gru_bidir_bwd"] == 2 * 5
    assert list(out["wavlm"]["spans"]) == ["extract_step_0", "extract_step_1"]
    assert list(out["whisper"]["spans"]) == ["extract_step_0"]
    assert min(out["wavlm"]["trace_bytes"], out["whisper"]["trace_bytes"]) > 0
    assert out["rtf"]["audio_s"] == 2 * 2 * 0.5 and out["rtf"]["rtf"] > 0
    assert out["train"]["launches"]["gru_bidir_bwd"] == 2 * 2 and "train_step: total" in out["train"]["report"]
    assert not os.path.exists(os.path.join(tmp, "trace_off")) and os.listdir(os.path.join(tmp, "trace_train"))
    assert os.environ.get("SER_TPU_TRACE") is None
    assert cs.kernel_records(tmp) == (0, 0)  # no launch call on the CPU
    json.dumps(out)  # what the phase's own process hands back
