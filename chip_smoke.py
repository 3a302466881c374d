#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one CUDA card (built for
an H100, ``sm_90a``) and needs nothing else: it builds the hand-written
kernels from ``interspeech_ser_tpu_torch/csrc/`` into ``build/``, holds each
kernel against its plain PyTorch version at the main path's shapes, then
drives the serving path, the fusion training path, the LoRA fine-tuning
path, the text-extraction path, the speech-encoder zoo, the NS3 prosody
extractor with the trimodal trainer, the challenge baseline, Whisper
transcription, the legacy fusion trainers, the joint RoBERTa + WavLM
trainers, the information-encoder family (the proto-angular trainers, the
timbre perturbation, the legacy baselinelike trainers with the x-vector
engine), the FACodec full decoder and redecoder and the lora_wavlm wrapper's
adapter / prompt fine-tune methods through their entry points at full width,
then the multi-device surface on spawned ranks, then the profiling helpers:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: nvcc, seconds and the compiler's register report;
3. kernel parity and timing, kernel vs plain version (median of 5 runs,
   CUDA events around one call, host time included, after a warm-up; K2
   and K8 also in runs of 10 back-to-back calls; TF32 off), with each
   kernel's bound (bytes
   or operations at the H100's published peaks) and one library call that
   computes the same function where there is one:
   K1 attention at WavLM-large shapes (gated bias + ragged key mask, f32 and
   bf16; SDPA with a float mask) and its no-bias / no-mask variants at
   Whisper-large shapes; K7 (one-shot) and K6 (streaming) attention on
   [B, H, T, 64] heads at RoBERTa-large's extraction shape (B=64, H=16, T=80,
   ragged key mask) and the WavLM-large shape with the gated bias, K6 also at
   B=8, H=20, T=1500 (f32 and bf16; SDPA with a float mask), K7 also at
   Tk = 2048 (f32 and bf16), K6 and K7 in f32 and K7 in bf16 on views one
   element off 16 bytes; K1 also at
   HuBERT-XL's and XLS-R-2B's head dims (80 and 120: B=16, T=499, ragged
   key mask); K2 the fused frontend on 10-s waveforms at depths 1-7 (its
   layer-0 kernel, and its later-layer kernel at depths 2-7); K5 the
   fused FFN at the WavLM-large and XLS-R-2B layers (two ``F.linear`` and
   ``F.gelu``); K8 the grouped positional conv at 120, 64 and 48 channels a
   group (cuDNN ``F.conv1d``; its per-call weight re-layout timed apart),
   K2's layer-0 and K8's launch plans against the built kernels (threads,
   shared bytes, resident blocks an SM), and K2's bf16 GELU table against
   ``F.gelu``; K3 the BiGRU recurrence and K3b its backward
   at the fusion trainer's batch (2B=128 rows, T=512, H=512; cuDNN
   ``nn.GRU``), K3 and K3b with their route, cluster size and rows, the
   clusters resident at once, and on edge shapes (odd row groups, holed
   masks, H=100, H=640 on the other route, K3b also H=3000), K3b's three
   stages (gate recompute, recurrence, dW) timed apart; K9 one
   direction of it, forward and reverse (B=64), with its route; K4 the
   attention backward at the Whisper-large fine-tune shape (B=8, T=1500, no
   bias, no mask), the WavLM-large one (gated bias + ragged mask) and
   HuBERT-XL's and XLS-R-2B's head dims (80, 120: B=16, T=499, ragged mask,
   with and without the gated bias), f32 and bf16, rerun bit-identical
   (autograd through SDPA); then K1 + K4 in f32 (the FP32-pipe micro-tile
   kernels) and bf16 (the tensor-core kernels) at every head dim and T = 499
   and 1500 with a fully masked row; K1 also at Whisper-large-v3's layer
   (B=8, T=1500, D=1280, H=20, no mask) in f32 and bf16 beside SDPA, rerun
   bit-identical; and the f32 K1 / K4 kernels' tiles, shared memory and
   resident blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
   against ``attention_f32_plan``, and the f32 K6 / K7 launchers' routes,
   block rows, tiles and shared memory against ``bhtd_f32_plan``;
4. extraction: a seeded random-init WavLM-large (24 layers, D=1024) written
   as an HF directory, 8 seeded wavs of 3-12 s, ``preprocess_cli.speech_main``
   in bf16 and in f32 (each run twice, cold then warm); shapes,
   finiteness, launch counts, and one f32 utterance against the plain path
   on the card; then one bf16 batch of 32 10-s wavs (the default budget)
   timed and profiled, and the same batch profiled in f32 (device idle
   share, the shares of K1, K2's layer-0 kernel and K8);
5. scoring: the bimodal WavLM-large + RoBERTa-large config at full fusion
   width (H=512, feat dims 1024/1024), ``cli.eval_main`` and ``cli.test_main``
   over the extracted features; CSV format, and every logit against a
   batch-1 plain forward on the CPU;
6. training: the same config over 128 train and 64 dev seeded synthetic
   utterances (speech [150-499, 1024], text [20-80, 1024]), ``cli.train_main``
   for 2 epochs, then ``cli.eval_main`` on its checkpoint: finite losses, a
   strict load, K3b launches = modalities x optimizer steps, the dev CSV;
   then one train step's gradients through the kernels against the plain
   path on the card, the median train-step time and a profile of 2 steps;
7. LoRA: a seeded random-init Whisper-large-v3 (32 layers, D=1280, H=20,
   FFN 5120, 128 mels) as an HF directory, ``preprocess_cli.whisper_main``
   on 8 seeded wavs of 3-30 s in bf16 and f32 (frame counts, and utt0
   against the plain path); then ``lora_cli`` (ft_lora's defaults: rank 8,
   alpha 16, q/v, batch 8, f32) for 1 epoch over 16 train and 8 dev
   utterances and ``whisper_pretrained_main`` with its checkpoint; the same
   over WavLM-large and ``speech_pretrained_main``: finite losses, K4
   launches = layers x steps, frame counts. Then one LoRA step's gradients
   through K1 + K4 against the plain path (full width, 2 layers, Whisper and
   WavLM), and the median Whisper LoRA step in bf16 and in f32 (the engine's
   default, what ``lora_cli`` runs), each with a profile of 2 steps (K1's and
   K4's shares of device time);
8. text: a seeded random-init RoBERTa-large (24 layers, D=1024, H=16, FFN
   4096, vocab 50265) as an HF directory with synthetic ``vocab.json`` and
   ``merges.txt``, and 256 seeded transcripts of 0-120 words;
   ``preprocess_cli.roberta_main`` at ``--max_len 80`` in f32 and bf16 (cold
   then warm) and once more in f32 with ``SER_TPU_ATTN_IMPL=flash``: shapes
   [80, 1024], finiteness, K7 = layers x batches per default run, K6 on the
   flash run and its files against the K7 run's, one text against the
   plain path on the card; then ``preprocess_cli.deroberta_main`` on a
   seeded DeBERTa-v2-xxlarge at full width (D=1536, H=24, FFN 6144, vocab
   128100, 256 position buckets) cut to 2 layers, with a synthetic
   ``spm.model``, in f32 and bf16: shapes [80, 1536], finiteness, one text
   against a CPU forward of the same weights. Texts per second for each run;
9. the speech-encoder zoo: a seeded random-init wav2vec2-XLS-R-2B at full
   width (D=1920, H=16, FFN 7680) cut to 8 layers as an HF directory,
   ``preprocess_cli.speech_main`` in bf16 and f32 (cold, warm): shapes,
   finiteness, K1 = layers x batches, K8 = batches, K5 = 0, and utt0 against
   the plain f32 pipeline on the card; once more in bf16 under
   ``SER_TPU_FFN_KERNEL=1 SER_TPU_FRONTEND=3`` (K5 = layers x batches, K2's
   later-layer kernel = 2 x batches, files within cosine 0.999 of the
   default run); XLS-R-2B at full depth (48
   layers) built on the card, one 160-s bf16 batch of 16 10-s wavs: utt/s,
   peak device memory, a profile; HuBERT-XL at full width cut to 2 layers in
   f32; ``lora_cli`` over HuBERT-XL and XLS-R-2B at full width cut to 2
   layers (head dims 80, 120: K4 = layers x steps), each with one step's
   gradients through K1 + K4 against the plain path; the wavlm-base-plus
   shape (group-norm frontend, post-LN: no K2) in bf16 and f32, then
   ``lora_cli`` over it for 1 epoch;
10. NS3 prosody and the trimodal trainer (BASELINE config #4): seeded
   random-init full-width FACodec encoder and decoder ``.bin`` files in the
   reference's naming (weight-normed convs and linears, the encoder in the
   ``weight_g`` / ``weight_v`` key style, the decoder in the
   ``parametrizations`` one; the VQ codebook spread over the latents of
   seeded voiced waves, so that frames take many codes); seeded voiced
   wavs of 2-12 s (the first 1 s) with an F0 contour and a syllable-rate
   envelope, named as phase 6's corpus, F0 by class;
   ``preprocess_cli ns3_prosody`` and ``ns3_prosody_speaker`` over all of
   them (cold, warm), ``ns3_prosody_speaker`` and ``ns3_prosody --codes``
   on the first 8: shapes [T, 256], [T, 512] and [T] int32, finiteness, a
   floor on distinct codes and on distinct prosody rows; the batched
   pre-VQ latents of those 8 against their batch-1 latents on the card;
   one utterance's batched file against its batch-1 forward on the card
   (3e-4) and that against the CPU (1e-4), the prosody half on the frames
   whose VQ top-2 gap exceeds 1e-5; utt/s, and a profile of one warm
   speaker batch of 16 10-s wavs (device idle share, peak memory); then
   ``cli.train_main --trimodal`` for 2 epochs over config #4 (feat dims
   1280 / 1024 / 256, focal loss, batch 64: synthetic Whisper-large
   features, phase 6's RoBERTa-large files and the extracted NS3 files) and
   ``cli.eval_main --trimodal``, then the median trimodal train step;
11. the challenge baseline (an end-to-end fine-tune of phase 4's
   WavLM-large): 64 train, 16 dev and 8 test3 seeded voiced wavs of 2-12 s
   (F0 by class) with a label CSV (8 emotions, EmoAct / EmoDom / EmoVal,
   Split_Set) and ``config_cat.json``; ``baseline.cli.train_main`` for
   ``cat`` (f32) and ``dim`` (bf16) with benchmark/run_cat.sh's
   hyperparameters (batch 32, 4 accumulation steps, lr 1e-5, head 1024) for
   one epoch, then ``eval_main`` on dev and test3: K4 = 24 layers x 8
   micro-batches a task, the frontend bit for bit and the gated-bias
   tensors moved in ``final_ssl.pt``, the saved files reloaded against the
   run's dev outputs (1e-5), dev batches of 8 against batch-1 (1e-4), the
   CSVs' columns and rows; one micro-step through K2 + K1 + K4 against the
   plain path on a 2-layer full-width copy (f32 gradients within 1e-4, each
   bf16 K1 / K4 call within cosine 0.999 of its plain version); the median
   f32 and bf16 micro-steps (8 rows x 12 s), the AdamW step, peak memory,
   the f32 inference time per audio second and a profile of one
   micro-step in each dtype;
12. Whisper transcription: a seeded random-init Whisper-large-v3 (32 + 32
   layers, D=1280, H=20, FFN 5120, 128 mels, vocab 51,866) as an HF
   ``WhisperForConditionalGeneration`` directory with float16 weights, a
   synthetic byte-level tokenizer in large-v3's layout (50,257 BPE tokens,
   then the specials, languages and timestamps at their ids) and a
   ``generation_config.json`` with a forced 4-token prompt and suppressed
   ids; 16 seeded wavs of 3-30 s and one of 34 s at 16, 22.05, 44.1 and 8
   kHz; ``transcribe_cli.main`` (batch 16, 200 new tokens) in bf16 and in
   f32: (a) one CSV row per wav in sorted order, (b) K1 = 32 layers x
   batches and no other kernel, (c) every wav through the native loader;
   then on the first batch (d) the f32 run's tokens teacher-forced
   through ``WhisperDecoderModel`` (each emitted token within TIE_GAP of its
   step's maximum, near-ties counted), (e) ``greedy_decode`` =
   ``greedy_decode_cached`` in f32 over 8 new tokens, (f) the bf16 cached
   decoder's step logits against the f32 teacher-forced ones (cosine);
   the encoder ms a batch, the cross-K/V projection ms, the median decode
   step beside its bound, tokens/s, utt/s, peak memory and the device's
   idle share over 8 profiled decode steps, in each dtype;
13. the legacy fusion surface (the ``bin/old`` trainers, ``cli.LEGACY``):
   phase 6's corpus with seeded EmoAct / EmoDom / EmoVal columns and a seeded
   gender CSV; one epoch each of ``cli.main([runner, '--legacy', stem,
   ...])`` for the MoE (then its ``eval``, which reads the flat-key
   checkpoint the JAX engine cannot), the GRL and SVM gender trainers, the
   gated-pool ``fiona`` trainer (then its ``eval``), the dim + CKA trainer
   (then ``eval_dim`` and ``test_dim``), the dim trainer warm-started from
   phase 6's cat checkpoint and the wavlm-only classifier: finite losses,
   per run K3 = experts x modalities x (train steps + scored batches) and K3b
   = experts x modalities x train steps (4 experts for the MoE, 0 for the
   single-modality model) and no other kernel, the CSVs, the checkpoints'
   keys and strict reloads, the warm start's kept and skipped keys; then one
   train step's gradients through K3 + K3b against the plain path for the
   MoE, the GRL head and dim + CKA, and the median MoE and dim train steps
   and the MoE's scoring forward at batch 64;
14. the joint RoBERTa + WavLM trainers (the ``bin/old/train_cat_roberta*``
   stems through ``joint_cli.main``): phase 11's corpus with seeded
   transcripts of phase 8's words, phase 4's WavLM-large, phase 8's
   RoBERTa-large and a seeded RoBERTa-base-width directory (D = 768, 12
   layers), phase 11's hyperparameters (batch 32, 4 accumulation steps) for
   one epoch of ``base``, ``ftall``, ``large``, ``cka`` and the text-only
   trainer in f32: finite losses, the files and their keys, each run's
   launches against its prediction (frozen runs: K1 = 24 x batches, K7 =
   RoBERTa layers x batches, K2's layer 0 and K8 once a batch; ``ftall``: K1
   = 24 x batches, K4 = 24 x micro-batches, K7 on the dev batches; the
   text-only trainer: K7 on its dev batches), the saved files reloaded
   strictly against each run's dev logits (1e-5), dev batches against
   batch-1 (1e-4), one ``ftall`` micro-step through K1 + K4 against the
   plain path on a 2-layer full-width copy (f32 gradients within 1e-4), the
   median ``ftall``, ``large`` and ``cka`` micro-steps (8 rows x 12 s) and
   their peak memory;
15. the information-encoder path: the five ``bin/old/*protoangularloss*``
   stems through ``train.proto_engine.main`` for two epochs each
   (``ProtoSERNet`` 1024 -> 512 over phase 6's WavLM-large-width ``.pt``
   features at C x U = 80, with the CE stem's dev batches of 32 and the
   4-head gender net at 64; over 160 seeded voiced wavs of 1-3 s the melspec
   ``ProtoSERNet`` at 80, timbre-perturbed at p = 0.5, and the
   ``BidirectionalReferenceEncoder`` at 64), ``ProtoAngularEngine`` (feat
   1024, H = 256, C x U = 32) for one epoch and its ``embed``, then
   ``baseline.cli`` ``train_cat_baselinelike_focalloss`` with the timbre
   perturbation (p = 0.5) and ``train_cat_baselinelike_xvector`` for one
   epoch over phase 11's corpus and WavLM-large (phase 11's hyperparameters),
   and one ``joint_cli`` ``large`` epoch with the perturbation over phase
   14's corpus: per run the launches against the prediction (K3 a forward and
   K3b a train step of a BiGRU net, nothing for ``ProtoSERNet`` and the
   x-vector, phase 11's K1 / K4 / K2 for the baseline run, phase 14's
   ``large`` launches for the joint one), finite losses, the files, the
   perturbation changed wavs it drew; each ``angle_ser.pt`` / ``ser.pt`` /
   ``final_xvector.pt`` reloaded against its run's val or dev loss (1e-5);
   one reference-encoder step at batch 64 through K3 + K3b against the
   plain path (gradients within 1e-4); and the median train step of each net;
16. the FACodec full decoder and redecoder, and the adapter fine-tune
   methods: (a) seeded reference-named full-width FACodec encoder, full
   decoder (three VQ banks, timbre encoder, HiFiGAN 1536 channels, hop 200;
   its file also carries phase 10's prosody subset) and redecoder (HiFiGAN
   1280) ``.bin`` files through ``models/loader.py``; 8 seeded voiced 10-s
   wavs: the encoder's content latents and the extractor's prosody latents
   through ``quantize_v2`` -> codes -> ``codes_to_wav`` in f32 (TF32 off):
   decoding the quantized latents equals decoding the codes (1e-5), wavs
   [8, 160000] within [-1, 1], the redecoder under the batch's speaker
   embeddings rolled by one row differs from under its own, ``use_residual``
   changes the decode and the redecode; one 2-s clip on the card against
   the CPU (codes equal away from a VQ near tie, wavs from the CPU's codes
   within 1e-3); one train-mode autoencode of 4 x 4 s at quantizer dropout
   0.5 drawn from a CPU generator (a finite gradient on every parameter, VQ
   losses within 1e-5 relative of the CPU's); decode and redecode ms a
   batch, utt/s, peak memory and profiles; (b) ``lora_model.
   build_wavlm_wrapper`` over phase 9's wavlm-base-plus with ``adapter``,
   ``adapter_l``, ``embedding_prompt`` and ``combined`` and over phase 4's
   WavLM-large with ``adapter`` and ``combined``: fresh adapters against the
   base encoder's hidden states (1e-5), 3 AdamW steps over the tuned tensors
   and the head on 8 seeded wavs of 3-6 s (the base weights bit for bit
   unchanged, every tuned tensor moved), a dev batch through
   ``lora_evaluation.EvalMetric``, each run's K1 / K4 / K2 launches against
   ``predict_adapter_launches``; then ``combined`` on 2-layer full-width
   copies of both through K1 + K4 against the plain path (the tuned tensors'
   gradients of a smooth probe of the hidden states within 1e-4) and
   ``embedding_prompt``'s padded batch against batch-1 (1e-4);
17. the multi-device surface (``parallel/``, one process a rank over
   ``torch.distributed``): the one process, then 2 spawned ranks (gloo on
   the one card they share; NCCL, one card a rank, where there are 2), then
   a world of one NCCL rank (init, all-reduce, all-gather and broadcast on
   the card): (a) one ``FusionEngine`` epoch over phase 6's features at
   batch 64 (each rank its 32 rows, K3 + K3b per rank): the dev macro-F1
   equal, every loss within 1e-5 relative and every parameter within Adam's
   budget (2 lr a step, + 1e-5) of the one process's; (b) phase 4's
   WavLM-large through ``speech_main`` in bf16 and f32 (every ``.pt`` within
   1e-2 / 1e-5 of phase 4's) and through the pipeline at a 24-s token budget
   (several batches, whole batches a rank: within 1e-5 of the one
   process's); (c) ``model_parallel=2`` f32 extraction at full width (8
   heads a rank through K1; cosine to phase 4's files >= 0.99999, max abs
   reported); (d) 2 LoRA steps over phase 7's wavs (the factors and the head
   within Adam's budget of the one process's); (e) each rank's launches
   against ``predict_parallel_launches`` and collectives against
   ``expected_audit`` (DP: one all-reduce of the trainable elements a step;
   DP extraction: one of the 4 stats; TP: two a layer a batch; the one
   process: ``NONE``); step ms and utt/s of the one process beside 2 ranks
   (plumbing on a shared card, not a speed-up);
18. profiling (``utils/profiling.py``, ``profile_trace.py``), in a
   spawned process of its own (this one's, after the phases before, has
   lost kernel records at a trace's start; a small trace here records how
   many): (a)
   ``profile_trace`` of WavLM-large in bf16 (B=32 x 10 s, 2 steps): the
   Chrome trace's step spans, and in each step 24 K1, 1 K2 layer-0 and 1 K8
   kernels attributed to its span (a kernel belongs to the span that holds
   its launch call, joined by the correlation id; ``kernels_by_span``), each
   span's host ms beside its kernels' device ms and K1's share, the trace's
   size; (b) the same for the Whisper-large-v3 encoder (B=8 x 30 s): 32 K1 a
   step; (c) 5 fusion train steps at batch 64 in ``StepTimer.span`` with
   the loss read back: the timer's total >= 0.98 x the CUDA events around
   the steps, K3 = K3b = modalities x steps, and, as a record, 5 more timed
   with no readback; (d) ``RTFMeter`` over (a)'s steps: rtf = inference s /
   audio s, its report; (e) ``SER_TPU_TRACE=0`` around one step writes
   nothing.

The launch counters are zeroed just before phase 4 and read after phase 5
(the serving path), zeroed again just before phase 6 and read after its
eval (the training path), zeroed again just before phase 7's extraction and
read after its last ``*_pretrained`` run (the LoRA path), zeroed again
just before phase 8 and read after it (the text path), zeroed again just
before phase 9 and read after it (the zoo path), and zeroed again just
before phase 10 and read after its NS3 extraction (every count 0: the
extractor has no kernel, as in the JAX package) and after its trimodal
eval (the trimodal path), and zeroed again just before phase 11 and read
after its last ``eval_main`` (the baseline path: K1, K4 and K2's layer 0,
no other kernel), and zeroed again just before phase 12 and read after its
two ``transcribe_cli`` runs (the transcription path: K1 alone; the decoder
is plain PyTorch, as it is plain XLA in the JAX package), and zeroed again
just before phase 13 and read after its last run (the legacy path: K3 and
K3b alone, also counted run by run), and zeroed again just before phase 14
and read after its last ``joint_cli`` run (the joint path: K1, K4, K7, K2's
layer 0 and K8, counted run by run), and zeroed again just before phase 15
and read after its last run (the information-encoder path: K3 / K3b under
the BiGRU nets, K1, K4 and K2's layer 0 under the baseline run, phase 14's
kernels under the joint run, counted run by run), and zeroed again just
before phase 16's decoder and read after it (every count 0: the decoder and
the redecoder have no kernel, as in the JAX package), and zeroed again just
before its adapter runs and read after the last (the adapter path: K1, K4
and, on WavLM-large, K2's layer 0, each run's counts equal to its
prediction), and zeroed before each of phase 17's runs in the one process
and in every rank and read after it (the multi-device path: their sum),
and counted in phase 18's own process from its start to its end (the
profiling path: K1, K2's layer 0 and K8 under the traces, K3 / K3b under
the timed train steps).
K9 has no path (none
calls it in the JAX package either): phase 3 holds it to its plain version.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time
import wave

import numpy as np
import torch

from interspeech_ser_tpu_torch.ops.kernels import _build
from interspeech_ser_tpu_torch.ops.kernels import attention as k_attn
from interspeech_ser_tpu_torch.ops.kernels import attention_bhtd as k_bhtd
from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as k_conv
from interspeech_ser_tpu_torch.ops.kernels import ffn_fused as k_ffn
from interspeech_ser_tpu_torch.ops.kernels import gru as k_gru
from interspeech_ser_tpu_torch.ops.kernels import pos_conv as k_pos
from interspeech_ser_tpu_torch.parallel import audit

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
DEVICE = "cuda"
# H100 SXM published peaks (dense): HBM bytes/s, FP32 (non-tensor-core) and
# bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
KERNELS = {
    "attention_btd": dict(
        module=k_attn, source="interspeech_ser_tpu_torch/csrc/attention_btd.cu",
        replaces="interspeech_ser_tpu/ops/pallas/flash_attention_short.py:293",
    ),
    "attention_btd_bwd": dict(
        module=k_attn, counter="BWD_LAUNCHES", source="interspeech_ser_tpu_torch/csrc/attention_btd_bwd.cu",
        replaces="interspeech_ser_tpu/ops/pallas/attention_bwd.py:137",
    ),
    "attention_bhtd": dict(
        module=k_bhtd, source="interspeech_ser_tpu_torch/csrc/attention_bhtd.cu",
        replaces="interspeech_ser_tpu/ops/pallas/flash_attention_short.py:455",
    ),
    "flash_attention": dict(
        module=k_bhtd, counter="FLASH_LAUNCHES", source="interspeech_ser_tpu_torch/csrc/flash_attention.cu",
        replaces="interspeech_ser_tpu/ops/pallas/flash_attention.py:99",
    ),
    "conv_frontend": dict(  # K2's layer-0 kernel, one launch a call
        module=k_conv, source="interspeech_ser_tpu_torch/csrc/conv_frontend.cu",
        replaces="interspeech_ser_tpu/ops/pallas/conv_frontend.py:134",
    ),
    "conv_frontend_layer": dict(  # K2's later-layer kernel, depth - 1 launches a call; times are the depth-2 call's
        module=k_conv, counter="LAYER_LAUNCHES", source="interspeech_ser_tpu_torch/csrc/conv_frontend.cu",
        replaces="interspeech_ser_tpu/ops/pallas/conv_frontend.py:134", headline="depth2_f32",
    ),
    "gru_bidir": dict(
        module=k_gru, source="interspeech_ser_tpu_torch/csrc/gru_bidir.cu",
        replaces="interspeech_ser_tpu/ops/pallas/gru_kernel.py:357",
    ),
    "gru_bidir_bwd": dict(
        module=k_gru, counter="BWD_LAUNCHES", source="interspeech_ser_tpu_torch/csrc/gru_bidir_bwd.cu",
        replaces="interspeech_ser_tpu/ops/pallas/gru_kernel.py:297",
    ),
    "ffn_fused": dict(
        module=k_ffn, source="interspeech_ser_tpu_torch/csrc/ffn_fused.cu",
        replaces="interspeech_ser_tpu/ops/pallas/ffn_fused.py:46",
    ),
    "pos_conv": dict(
        module=k_pos, source="interspeech_ser_tpu_torch/csrc/pos_conv.cu",
        replaces="interspeech_ser_tpu/ops/pallas/pos_conv.py:43",
    ),
    "gru_sequence": dict(  # no path launches it (none does in the JAX package): a parity case
        module=k_gru, counter="SEQ_LAUNCHES", source="interspeech_ser_tpu_torch/csrc/gru_bidir.cu",
        replaces="interspeech_ser_tpu/ops/pallas/gru_kernel.py:82",
    ),
}
# the profiler's names of K1's and K4's CUDA kernels (the f32 and the bf16 ones;
# attention_btd_kernel, dkdv_kernel and dq_kernel name the earlier f32 kernels,
# so that scripts/time_f32_attention_pair.py reads an older checkout's profile too)
K1_EVENTS = ("attention_btd_f32_kernel", "attention_btd_mma_kernel", "attention_btd_kernel")
K4_EVENTS = ("delta_kernel", "dkdv_f32_kernel", "dkdv_mma_kernel", "dkdv_kernel", "dq_f32_kernel", "dq_mma_kernel",
             "dq_kernel", "dbias_reduce")
# K7's f32 and bf16 kernels (attention_bhtd_kernel names the earlier f32 kernel, so that
# scripts/time_f32_attention_pair.py reads an older checkout's profile too)
K7_EVENTS = ("attention_bhtd_f32_kernel", "attention_bhtd_mma_kernel", "attention_bhtd_kernel")
# K2's layer-0 kernels (conv_frontend_kernel, conv_frontend_mma_kernel, the bf16 GELU table's fill) and
# later-layer kernel; K8's kernels (pos_conv_f32_kernel,
# pos_conv_wgmma_kernel, and the earlier pos_conv_kernel / pos_conv_mma_kernel of an older checkout)
K2_EVENTS = ("conv_frontend", "gelu_table_kernel", "conv_layer_kernel")
K8_EVENTS = ("pos_conv",)
K3_EVENTS = ("gru_bidir_kernel", "gru_bidir_cluster_kernel")  # K3's two routes
# K3b's kernels: the row route, the cluster route's recurrence, the gate / dW products and the dW sum
K3B_EVENTS = ("gru_bidir_bwd_kernel", "gru_bidir_bwd_cluster_kernel", "gru_gemm_kernel", "gru_dw_reduce_kernel")


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


def run_ms(fn, n: int = 10, reps: int = 5) -> tuple:
    """(device ms, host ms) of a call in a run of n back-to-back calls: CUDA
    events around the run and the host clock around its calls, each over n
    (median of ``reps`` runs, after a warm-up). In a run the calls' host time
    overlaps the device's work; ``median_ms``, which every kernel's ``ms``
    is, times one call alone with its host time."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - h0) * 1e3 / n)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times), statistics.median(host)


def roofline_ms(nbytes: float, flops: float, peak_flops: float):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _sdpa_yardstick(q, k, v, H, key_mask, gate, pos_bias, ref):
    """``scaled_dot_product_attention`` with the additive float mask
    gate * bias + key mask (the key mask alone without a bias, no mask
    without either), which computes K1's function: its median ms
    (mask built outside the timing) and its max-abs gap to the plain version."""
    import torch.nn.functional as F

    B, T, D = q.shape
    heads = [t.view(B, T, H, D // H).transpose(1, 2) for t in (q, k, v)]
    attn_mask = None
    if key_mask is not None:
        attn_mask = torch.zeros_like(key_mask).masked_fill(key_mask == 0, float("-inf"))[:, None, None, :]
    if pos_bias is not None:
        attn_mask = gate[..., None] * pos_bias[None] + (0 if attn_mask is None else attn_mask)
    if attn_mask is not None:
        attn_mask = attn_mask.to(q.dtype)
    out = F.scaled_dot_product_attention(*heads, attn_mask=attn_mask).transpose(1, 2).reshape(B, T, D)
    return median_ms(lambda: F.scaled_dot_product_attention(*heads, attn_mask=attn_mask)), max_abs(out, ref)


def check_attention(g, results) -> None:
    # WavLM-large layer: ragged lengths; length 400 leaves the last key tile
    # (448..498) fully masked for that row
    lengths = [499, 480, 451, 400, 333, 250, 130, 64]
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = _attention_inputs(g, 8, 499, 1024, 16, lengths, True, dt)
        out = k_attn.attention_btd(*args, **kw)
        require(torch.equal(out, k_attn.attention_btd(*args, **kw)), f"K1 WavLM {dt} gave different bits on a rerun")
        ref = k_attn.attention_btd_plain(*args, **kw)
        err, cos = max_abs(out, ref), cosine(out, ref)
        ms = median_ms(lambda: k_attn.attention_btd(*args, **kw))
        plain_ms = median_ms(lambda: k_attn.attention_btd_plain(*args, **kw))
        library_ms, lib_err = _sdpa_yardstick(*args, **kw, ref=ref)
        name = "f32" if dt == torch.float32 else "bf16"
        q, k, v, H = args
        B, T, D = q.shape
        nbytes = q.element_size() * 4 * q.numel() + 4 * (kw["gate"].numel() + kw["pos_bias"].numel()
                                                       + kw["key_mask"].numel())
        flops = 4 * T * D * sum(lengths) + 8 * H * T * sum(lengths)  # QK^T, PV and the softmax over live keys
        bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
        log(f"[parity] K1 attention_btd B8 T499 D1024 H16 bias+mask {name}: "
            f"max_abs {err:.3e} cos {cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"SDPA with float mask {library_ms:.3f} ms (vs plain max_abs {lib_err:.3e}); "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        if dt == torch.float32:
            require(err <= 1e-4, f"K1 f32 max_abs {err} > 1e-4")
        else:
            require(cos >= 0.999, f"K1 bf16 cosine {cos} < 0.999")
        main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
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
    # HuBERT-XL (hd 80) and XLS-R-2B (hd 120) layers: B=16, T=499, ragged key
    # mask, no bias (standard attention)
    lengths16 = lengths + [499, 470, 402, 380, 310, 222, 160, 90]
    for D in (1280, 1920):
        for dt in (torch.float32, torch.bfloat16):
            args, kw = _attention_inputs(g, 16, 499, D, 16, lengths16, False, dt)
            out = k_attn.attention_btd(*args, **kw)
            ref = k_attn.attention_btd_plain(*args, **kw)
            err, cos = max_abs(out, ref), cosine(out, ref)
            ms = median_ms(lambda: k_attn.attention_btd(*args, **kw))
            plain_ms = median_ms(lambda: k_attn.attention_btd_plain(*args, **kw))
            library_ms, lib_err = _sdpa_yardstick(*args, **kw, ref=ref)
            q, _, _, H = args
            B, T, _ = q.shape
            nbytes = q.element_size() * 4 * q.numel() + 4 * kw["key_mask"].numel()
            flops = 4 * T * D * sum(lengths16) + 8 * H * T * sum(lengths16)
            bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
            name = f"hd{D // 16}_" + ("f32" if dt == torch.float32 else "bf16")
            log(f"[parity] K1 attention_btd B16 T499 D{D} H16 (hd {D // 16}) mask {name}: max_abs {err:.3e} "
                f"cos {cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA with float mask "
                f"{library_ms:.3f} ms (vs plain max_abs {lib_err:.3e}); bound {bound_ms:.4f} ms ({bound_by})")
            if dt == torch.float32:
                require(err <= 1e-4 * min(1.0, float(ref.abs().max())), f"K1 {name} max_abs {err} > 1e-4")
                require(torch.equal(out, k_attn.attention_btd(*args, **kw)), f"K1 {name} gave different bits on a rerun")
            else:
                require(cos >= 0.999, f"K1 {name} cosine {cos} < 0.999")
            main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            del args, kw, out, ref
            torch.cuda.empty_cache()
    results["attention_btd"] = main


def check_attention_whisper(g, results) -> None:
    """K1 at Whisper-large-v3's layer (B=8, T=1500, D=1280, H=20, no bias, no
    mask; what every Whisper extraction and LoRA forward runs, 32 times a
    batch), f32 and bf16, against its plain version and beside SDPA; a rerun
    bit-identical. Bars: f32 max-abs <= 1e-4, bf16 cosine >= 0.999."""
    main = results.setdefault("attention_btd", {})
    for dt in (torch.float32, torch.bfloat16):
        args, kw = _attention_inputs(g, 8, 1500, 1280, 20, None, False, dt)
        out = k_attn.attention_btd(*args, **kw)
        same = torch.equal(out, k_attn.attention_btd(*args, **kw))
        ref = k_attn.attention_btd_plain(*args, **kw)
        err, cos = max_abs(out, ref), cosine(out, ref)
        ms = median_ms(lambda: k_attn.attention_btd(*args, **kw))
        plain_ms = median_ms(lambda: k_attn.attention_btd_plain(*args, **kw))
        library_ms, lib_err = _sdpa_yardstick(*args, **kw, ref=ref)
        q, _, _, H = args
        B, T, D = q.shape
        nbytes = q.element_size() * 4 * q.numel()
        flops = 4 * T * D * B * T + 8 * H * T * B * T
        bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
        name = "whisper_" + ("f32" if dt == torch.float32 else "bf16")
        log(f"[parity] K1 attention_btd B8 T1500 D1280 H20 (Whisper-large-v3) {name}: max_abs {err:.3e} "
            f"cos {cos:.7f}; bit-identical rerun {same}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
            f"{library_ms:.3f} ms (vs plain max_abs {lib_err:.3e}); bound {bound_ms:.4f} ms ({bound_by})")
        if dt == torch.float32:
            require(err <= 1e-4, f"K1 {name} max_abs {err} > 1e-4")
        else:
            require(cos >= 0.999, f"K1 {name} cosine {cos} < 0.999")
        require(same, f"K1 {name} gave different bits on a rerun")
        main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        del args, kw, out, ref
        torch.cuda.empty_cache()


def check_f32_plans() -> dict:
    """The f32 K1 and K4 kernels' tiles, shared memory and resident blocks an
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) against
    ``attention_f32_plan``: the same tile and bytes, one block of 256 threads
    an SM."""
    plans = {}
    for kind in k_attn.F32_KINDS:
        for hd in k_attn.K1_HEAD_DIMS:
            for bias in (False, True):
                tile, nbytes, blocks = k_attn.attention_f32_occupancy(hd, bias, kind)
                plan = k_attn.attention_f32_plan(hd, bias, kind)
                require((tile, nbytes, blocks) == (plan.tile, plan.smem_bytes, plan.blocks_per_sm),
                        f"f32 {kind} hd {hd} bias {bias}: built {(tile, nbytes, blocks)} != planned "
                        f"{(plan.tile, plan.smem_bytes, plan.blocks_per_sm)}")
                plans[f"{kind}_hd{hd}{'_bias' if bias else ''}"] = dict(tile=tile, smem_bytes=nbytes, blocks_per_sm=blocks)
    log("[parity] f32 K1 / K4 plans (tile, shared bytes, blocks an SM): " + "; ".join(
        f"{n} {p['tile']} {p['smem_bytes']} {p['blocks_per_sm']}" for n, p in plans.items()))
    return plans


def check_bhtd_f32_plans() -> dict:
    """The f32 K6 and K7 launchers' route, block rows, tile and shared memory
    against ``bhtd_f32_plan`` at the shapes of ``check_attention_bhtd`` (and
    K7 on both sides of its route boundaries, Tk = 256 / 257, 640 / 641), with the
    resident blocks an SM the build reports."""
    plans = {}
    for name, cases in (("attention_bhtd", ((80, 80), (499, 499), (256, 256), (257, 257), (640, 640), (641, 641),
                                            (2048, 2048))),
                        ("flash_attention", ((80, 80), (499, 499), (1500, 1500)))):
        for tq, tk in cases:
            for bias in (False, True):
                built = k_bhtd.bhtd_f32_occupancy(name, tq, tk, bias)
                plan = k_bhtd.bhtd_f32_plan(name, tq, tk, bias)
                require(built[:4] == (plan.route, plan.rows, plan.tile, plan.smem_bytes) and built[4] >= 1,
                        f"f32 {name} Tq {tq} Tk {tk} bias {bias}: built {built} != planned {plan}")
                plans[f"{name}_tk{tk}{'_bias' if bias else ''}"] = built
    log("[parity] f32 K7 / K6 plans (route, rows, tile, shared bytes, blocks an SM): " + "; ".join(
        f"{n} {p}" for n, p in plans.items()))
    return plans


def check_conv_plans() -> dict:
    """K8's and K2's layer-0 launch plans against the built kernels: every
    group width at K = 128 (the zoo's), 256 and 2, and layer 0 at k = 10 and
    16 with either GELU, in f32 and bf16. The built kernel's threads and
    shared bytes are the plan's, and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    gives at least the blocks an SM the plan counts on (the kernels' launch
    bounds)."""
    plans = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = "f32" if dt == torch.float32 else "bf16"
        for C in k_pos.GROUP_WIDTHS:
            for K in (128, 256, 2):
                plan = k_pos.pos_conv_plan(C, K, dt)
                built = k_pos.pos_conv_occupancy(plan)
                require(built[:2] == (plan.threads, plan.smem_bytes) and built[2] >= plan.blocks_per_sm,
                        f"K8 {dname} C {C} K {K}: built {built} != planned {plan}")
                plans[f"pos_conv_{dname}_c{C}_k{K}"] = dict(frames=plan.frames, stages=plan.stages, threads=built[0],
                                                            smem_bytes=built[1], blocks_per_sm=built[2])
        for ksize in (10, 16):
            for approx in (False, True):
                plan = k_conv.conv_frontend_plan(8, 31999, dt, ksize)
                built = k_conv.conv_frontend_occupancy(dt, ksize, approx)
                require(built[:2] == (plan.threads, plan.smem_bytes) and built[2] >= plan.blocks_per_sm,
                        f"K2 layer 0 {dname} k {ksize} approx {approx}: built {built} != planned {plan}")
                plans[f"conv_frontend_{dname}_k{ksize}{'_tanh' if approx else ''}"] = dict(
                    blocks=plan.blocks, frames=plan.frames, threads=built[0], smem_bytes=built[1],
                    blocks_per_sm=built[2])
    log("[parity] K8 / K2 layer-0 plans (threads, shared bytes, blocks an SM): " + "; ".join(
        f"{n} {p['threads']} {p['smem_bytes']} {p['blocks_per_sm']}" for n, p in plans.items()))
    return plans


def _bhtd_case(g, B, H, T, lengths, bias: bool, dt, offset: bool = False):
    """[B, T, H*64] projections viewed as [B, H, T, 64] heads (the text path's
    layout), a key mask from ``lengths`` and the factored gate * bias. With
    ``offset`` each projection starts one element into its buffer, so no row
    of q, k or v starts on 16 bytes."""
    dev = "cuda"
    n = B * T * H * 64
    q, k, v = (torch.randn(n + offset, generator=g, device=dev).to(dt)[int(offset):].view(B, T, H, 64).transpose(1, 2)
               for _ in range(3))
    kw = {}
    if lengths is not None:
        kw["key_mask"] = (torch.arange(T, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).float()
    if bias:
        kw["gate"] = 1.0 + torch.rand(B, H, T, generator=g, device=dev)
        kw["pos_bias"] = torch.randn(H, T, T, generator=g, device=dev)
    return (q, k, v), kw


def _sdpa_bhtd(q, k, v, key_mask=None, gate=None, pos_bias=None, bias_dtype=None):
    """``scaled_dot_product_attention`` with the additive float mask (gate *
    bias + key mask; none where there is neither) that computes the function
    of K6 / K7; -> (its median ms with the mask built outside the timing, its
    output). f32 views that do not start on 16 bytes are copied to aligned
    tensors first, outside the timing: SDPA's f32 kernel faults on them
    (cudaErrorMisalignedAddress). bf16 views are timed as given."""
    import torch.nn.functional as F

    if q.dtype == torch.float32 and any(t.data_ptr() % 16 for t in (q, k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
    B, Tk = q.shape[0], k.shape[2]
    mask = None
    if pos_bias is not None:
        mask = gate[..., None] * pos_bias.to(bias_dtype).float()[None]
    if key_mask is not None:
        masked = torch.zeros(B, 1, 1, Tk, device=q.device).masked_fill(key_mask[:, None, None, :] == 0, float("-inf"))
        mask = masked if mask is None else mask + masked
    if mask is not None:
        mask = mask.to(q.dtype)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return median_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)), out


def check_attention_bhtd(g, results) -> None:
    """K7 (one-shot) and K6 (streaming) against their plain versions: at
    RoBERTa-large's extraction shape (B=64, H=16, T=80, ragged key mask), at
    the WavLM-large shape with the factored gate * bias (B=8, H=16, T=499),
    and K6 at a long shape (B=8, H=20, T=1500, no bias, no mask), and at the
    same shape with a ragged key mask (the Tk tail and masked 64-key tiles);
    then both at B=4, H=16, T=499 with the bias and row 1's keys all masked
    (sum(V) / Tk_p, Tk_p = 512 for both), that row also held alone. f32 and
    bf16. K7 also at its longest key length, Tk = 2048 (B=2, H=16, gated
    bias, ragged mask: the two-pass routes), f32 and bf16; and at RoBERTa's
    width with q, k and v one element off 16 bytes (B=4, T=80, row 1 fully
    masked): K6 and K7 in f32, K7 in bf16 (bf16 K6 refuses such views).
    Bars: f32 max-abs <= 1e-5; bf16 cosine >= 0.9999, and on the dead row
    also max-abs <= 1e-2 x max|ref| of the row (f32: max-abs <= 1e-5). Each
    line gives the kernel's achieved TFLOP/s and its share of the bound."""
    rng = np.random.default_rng(SEED)
    roberta_lengths = [80] * 8 + [int(n) for n in rng.integers(3, 81, 56)]
    wavlm_lengths = [499, 480, 451, 400, 333, 250, 130, 64]
    long_lengths = [1500, 1437, 1290, 1111, 900, 777, 400, 65]
    both, k6, k7 = ("attention_bhtd", "flash_attention"), ("flash_attention",), ("attention_bhtd",)
    f32, bf16 = torch.float32, torch.bfloat16
    # shape name, (B, H, T), key lengths, bias, offset views, {dtype: kernels}
    cases = [("roberta", (64, 16, 80), roberta_lengths, False, False, {f32: both, bf16: both}),
             ("wavlm", (8, 16, 499), wavlm_lengths, True, False, {f32: both, bf16: both}),
             ("long", (8, 20, 1500), None, False, False, {f32: k6, bf16: k6}),
             ("long_masked", (8, 20, 1500), long_lengths, False, False, {f32: k6, bf16: k6}),
             ("dead_row", (4, 16, 499), [499, 0, 300, 77], True, False, {f32: both, bf16: both}),
             ("tk2048", (2, 16, 2048), [2048, 1337], True, False, {f32: k7, bf16: k7}),
             # bf16 K6 copies rows by 16-byte cp.async and refuses views off 16 bytes
             ("offset", (4, 16, 80), [80, 0, 51, 7], False, True, {f32: both, bf16: k7})]
    for shape, (B, H, T), lengths, bias, offset, by_dtype in cases:
        for dt, kernels in by_dtype.items():
            args, kw = _bhtd_case(g, B, H, T, lengths, bias, dt, offset)
            if offset:
                require(all(t.data_ptr() % 16 != 0 for t in args), "the offset views start on 16 bytes")
            dname = "f32" if dt == torch.float32 else "bf16"
            for name in kernels:
                fn = k_bhtd.attention_bhtd if name == "attention_bhtd" else k_bhtd.flash_attention
                plain = k_bhtd.attention_bhtd_plain if name == "attention_bhtd" else k_bhtd.flash_attention_plain
                out = fn(*args, **kw)
                ref = plain(*args, **kw)
                err, cos = max_abs(out, ref), cosine(out, ref)
                ms = median_ms(lambda: fn(*args, **kw))
                plain_ms = median_ms(lambda: plain(*args, **kw))
                bias_dt = dt if name == "attention_bhtd" else torch.float32
                library_ms, lib_out = _sdpa_bhtd(*args, **kw, bias_dtype=bias_dt)
                lib_err = max_abs(lib_out, ref)
                item = args[0].element_size()
                nbytes = item * 4 * args[0].numel() + (4 * B * T if lengths is not None else 0)
                if bias:
                    nbytes += 4 * kw["gate"].numel() + (item if name == "attention_bhtd" else 4) * kw["pos_bias"].numel()
                live = B * T if lengths is None else sum(lengths)
                flops = 4 * H * T * 64 * live + 8 * H * T * live  # QK^T, PV and the softmax over live keys
                bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
                log(f"[parity] {'K7' if name == 'attention_bhtd' else 'K6'} {name} {shape} B{B} H{H} T{T} "
                    f"bias={bias} mask={lengths is not None} {dname}: max_abs {err:.3e} cos {cos:.7f}; "
                    f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound), "
                    f"plain {plain_ms:.4f} ms, SDPA with float mask {library_ms:.4f} ms "
                    f"(vs plain max_abs {lib_err:.3e}); bound {bound_ms:.4f} ms ({bound_by})")
                if dt == torch.float32:
                    require(err <= 1e-5, f"{name} {shape} f32 max_abs {err} > 1e-5")
                else:
                    require(cos >= 0.9999, f"{name} {shape} bf16 cosine {cos} < 0.9999")
                dead = [b for b in range(B) if lengths is not None and lengths[b] == 0]
                if dead:  # the row with no live key, alone: sum(V) / Tk_p
                    d_err, d_cos = max_abs(out[dead], ref[dead]), cosine(out[dead], ref[dead])
                    d_rel = d_err / float(ref[dead].abs().max())
                    log(f"[parity]   {name} {shape} {dname} fully masked row: max_abs {d_err:.3e} "
                        f"(x max|ref| {d_rel:.2e}) cos {d_cos:.7f}")
                    if dt == torch.float32:
                        require(d_err <= 1e-5, f"{name} {shape} f32 dead row max_abs {d_err} > 1e-5")
                    else:  # cosine cannot see a wrong scale (Tk for Tk_p): max-abs too
                        require(d_cos >= 0.9999 and d_rel <= 1e-2,
                                f"{name} {shape} bf16 dead row cosine {d_cos} < 0.9999 or max-abs {d_rel} x max|ref| > 1e-2")
                key = dname if shape == "roberta" else f"{shape}_{dname}"
                results.setdefault(name, {})[key] = dict(
                    max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
                del out, ref, lib_out
            del args, kw
            torch.cuda.empty_cache()


FRONTEND_KERNELS, FRONTEND_STRIDES = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)


def _frontend_layers(g, depth: int) -> list:
    """Seeded parameters of the layer-norm frontend's first ``depth`` layers
    (conv0: 1 -> 512, k=10, s=5; then 512 -> 512)."""
    dev = "cuda"
    layers = []
    for i in range(depth):
        c_in, k = (1 if i == 0 else 512), FRONTEND_KERNELS[i]
        layers.append(k_conv.FrontendLayer(
            torch.randn(512, c_in, k, generator=g, device=dev) / (c_in * k) ** 0.5,
            0.1 * torch.randn(512, generator=g, device=dev), 1.0 + 0.1 * torch.randn(512, generator=g, device=dev),
            0.1 * torch.randn(512, generator=g, device=dev), FRONTEND_STRIDES[i]))
    return layers


def bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order (-0 and +0 both 0): a difference is a distance in ulps."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -(b & 0x7FFF), b)


def check_conv_frontend(g, results) -> None:
    """K2 on wav [8, 160000] (10 s) at depths 1-7: depth 1 in f32 and bf16,
    each with the erf and the tanh GELU; depths 2-7 in f32 (erf) and bf16
    (tanh), as the encoders run them. Depth 1 is the layer-0 kernel's case
    (``conv_frontend``), depths 2-7 the later-layer kernel's
    (``conv_frontend_layer``). Bars: f32 max-abs <= 1e-4 at depth 1 and
    <= 1e-4 x max|ref| at depths 2-7, bf16 cosine >= 0.999. No one library call computes conv + LayerNorm +
    GELU, so there is no yardstick; at depths >= 2 the default route for
    the same layers (K2 at depth 1, then cuDNN convs in the compute dtype
    with f32 LayerNorms, as ``ConvFeatureExtractor`` runs them) is timed
    beside it as ``route_ms``. ``ms`` and ``route_ms`` are one call alone,
    host time included, as every kernel is timed; ``run_ms`` and
    ``host_ms`` are a call's device and host time in a run of back-to-back
    calls (``run_ms``). Every case is rerun bit-identical. The bf16
    layer-0 kernel's GELU table is held to ``F.gelu`` on the same bf16
    inputs (``gelu_table``)."""
    import torch.nn.functional as F

    def default_route(wav, layers, dt, approx, eps):
        x = k_conv.conv_frontend(wav, layers[:1], dt, approx, eps)
        for layer in layers[1:]:
            y = F.conv1d(x.transpose(1, 2), layer.weight.to(dt), layer.bias.to(dt), stride=layer.stride)
            y = F.layer_norm(y.transpose(1, 2).float(), (512,), layer.ln_weight, layer.ln_bias, eps)
            x = F.gelu(y.to(dt), approximate="tanh" if approx else "none")
        return x

    main, later = {}, {}
    # the table holds the kernel's own GELU: compare with torch's (an older checkout's package has none)
    for approx in ((False, True) if hasattr(k_conv, "gelu_table") else ()):
        got = k_conv.gelu_table(approx)
        z = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
        want = F.gelu(z, approximate="tanh" if approx else "none")
        keep = torch.isfinite(z) & torch.isfinite(want)  # every finite z; inf and NaN give NaN or inf in both
        ulps = (bf16_order(got) - bf16_order(want)).abs()[keep]
        n_diff, worst = int((ulps != 0).sum()), int(ulps.max())
        same = (got.view(torch.int16) == want.view(torch.int16)) | (torch.isnan(got) & torch.isnan(want))
        require(bool(same[~keep].all()), "K2 GELU table: a non-finite z whose value differs from F.gelu's")
        log(f"[parity] K2 bf16 GELU table ({'tanh' if approx else 'erf'}), {int(keep.sum())} finite z: "
            f"{n_diff} differ from F.gelu in bf16, by at most {worst} ulp")
        require(worst <= 1, f"K2 bf16 GELU table ({'tanh' if approx else 'erf'}) {worst} ulp from F.gelu")
        main[f"gelu_table_{'tanh' if approx else 'erf'}"] = dict(n_values=int(keep.sum()), n_differ=n_diff,
                                                                   max_ulp=worst)
    wav = torch.randn(8, 160000, generator=g, device="cuda")
    all_layers = _frontend_layers(g, 7)
    for depth in range(1, 8):
        layers = all_layers[:depth]
        variants = ([(torch.float32, False), (torch.float32, True), (torch.bfloat16, False), (torch.bfloat16, True)]
                    if depth == 1 else [(torch.float32, False), (torch.bfloat16, True)])
        for dt, approx in variants:
            args = (wav, layers, dt, approx, 1e-5)
            out = k_conv.conv_frontend(*args)
            ref = k_conv.conv_frontend_plain(*args)
            err, cos = max_abs(out, ref), cosine(out, ref)
            again = torch.equal(out, k_conv.conv_frontend(*args))
            ms = median_ms(lambda: k_conv.conv_frontend(*args))
            in_run, host_ms = run_ms(lambda: k_conv.conv_frontend(*args))
            plain_ms = median_ms(lambda: k_conv.conv_frontend_plain(*args))
            # conv products + bias, LayerNorm and GELU (~30 operations per output) for every layer
            t, mm_flops, ew_flops, c_in = wav.shape[1], 0.0, 0.0, 1
            for layer in layers:
                k = layer.weight.shape[2]
                t = (t - k) // layer.stride + 1
                mm_flops += 2 * 8 * t * 512 * c_in * k
                ew_flops += 30 * 8 * t * 512
                c_in = 512
            peak = PEAK_F32 if dt == torch.float32 else PEAK_BF16  # bf16 products: the input and weights are rounded
            nbytes = 4 * (wav.numel() + sum(layer.weight.numel() + 3 * 512 for layer in layers)) \
                + out.element_size() * out.numel()
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, (mm_flops / peak + ew_flops / PEAK_F32) * 1e3
            bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
            dname = ("f32" if dt == torch.float32 else "bf16")
            name = dname + ("_tanh" if approx else "_erf") if depth == 1 else f"depth{depth}_{dname}"
            route = ""
            if depth > 1:
                route_ms = median_ms(lambda: default_route(*args))
                route = f", the default route (K2 depth 1 + cuDNN) {route_ms:.3f} ms"
            log(f"[parity] K2 conv_frontend depth {depth} wav[8,160000] -> {list(out.shape)} {name}: "
                f"max_abs {err:.3e} cos {cos:.7f}; bit-identical rerun {again}; kernel {ms:.4f} ms "
                f"({bound_ms / ms:.1%} of the bound; in a run of 10 calls {in_run:.4f} ms and {1e3 * host_ms:.1f} us "
                f"of host time a call), plain {plain_ms:.3f} ms{route}; "
                f"bound {bound_ms:.4f} ms ({bound_by}); no single library call does conv+LN+GELU")
            require(again, f"K2 {name} gave different bits on a rerun")
            if dt == torch.float32 and depth == 1:
                require(err <= 1e-4, f"K2 {name} max_abs {err} > 1e-4")
            elif dt == torch.float32:
                require(err <= 1e-4 * float(ref.abs().max()), f"K2 {name} max_abs {err} > 1e-4 x max|ref|")
            else:
                require(cos >= 0.999, f"K2 {name} cosine {cos} < 0.999")
            case = dict(max_abs_err=err, cosine=cos, ms=ms, run_ms=in_run, host_ms=host_ms, plain_ms=plain_ms,
                        library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by)
            if depth > 1:
                case["route_ms"] = route_ms
            (main if depth == 1 else later)[name] = case
            del out, ref
        torch.cuda.empty_cache()
    results["conv_frontend"], results["conv_frontend_layer"] = main, later


def _ffn_inputs(g, M: int, K: int, Fd: int, dt):
    dev = "cuda"
    x = torch.randn(M, K, generator=g, device=dev).to(dt)
    w_up = torch.randn(Fd, K, generator=g, device=dev) / K ** 0.5
    b_up = 0.1 * torch.randn(Fd, generator=g, device=dev)
    w_down = torch.randn(K, Fd, generator=g, device=dev) / Fd ** 0.5
    b_down = 0.1 * torch.randn(K, generator=g, device=dev)
    return x, w_up, b_up, w_down, b_down


def check_ffn_fused(g, results) -> None:
    """K5 at the WavLM-large layer (M = 32 x 499 frames, 1024 -> 4096 ->
    1024) and the XLS-R-2B one (M = 16 x 499, 1920 -> 7680 -> 1920), f32
    with the erf GELU and bf16 with the tanh form (as the encoders run
    them). Bars: f32 max-abs <= 1e-4 x max|ref|, bf16 cosine >= 0.999.
    Yardstick: two ``F.linear`` (cuBLAS) around ``F.gelu`` in the compute
    dtype, the intermediate written to device memory."""
    import torch.nn.functional as F

    main = {}
    for shape, (M, K, Fd) in (("xlsr_2b", (16 * 499, 1920, 7680)), ("wavlm", (32 * 499, 1024, 4096))):
        for dt, approx in ((torch.float32, False), (torch.bfloat16, True)):
            x, w_up, b_up, w_down, b_down = _ffn_inputs(g, M, K, Fd, dt)
            args = (x, w_up, b_up, w_down, b_down, approx)
            out = k_ffn.ffn_fused(*args)
            ref = k_ffn.ffn_fused_plain(*args)
            err, cos = max_abs(out, ref), cosine(out, ref)
            again = torch.equal(out, k_ffn.ffn_fused(*args))
            ms = median_ms(lambda: k_ffn.ffn_fused(*args))
            plain_ms = median_ms(lambda: k_ffn.ffn_fused_plain(*args))
            wu, wd, bu, bd = w_up.to(dt), w_down.to(dt), b_up.to(dt), b_down.to(dt)
            gelu = "tanh" if approx else "none"
            library_ms = median_ms(lambda: F.linear(F.gelu(F.linear(x, wu, bu), approximate=gelu), wd, bd))
            lib_cos = cosine(F.linear(F.gelu(F.linear(x, wu, bu), approximate=gelu), wd, bd), ref)
            item = x.element_size()
            nbytes = item * (x.numel() + w_up.numel() + w_down.numel() + out.numel()) + 4 * (Fd + K)
            flops = 2 * M * Fd * 2 * K
            bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
            name = ("f32" if dt == torch.float32 else "bf16") if shape == "xlsr_2b" else \
                f"{shape}_" + ("f32" if dt == torch.float32 else "bf16")
            log(f"[parity] K5 ffn_fused {shape} M{M} {K}->{Fd}->{K} {name}: max_abs {err:.3e} "
                f"(max|ref| {float(ref.abs().max()):.3f}) cos {cos:.7f}; bit-identical rerun {again}; kernel "
                f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound), plain "
                f"{plain_ms:.3f} ms, two F.linear + F.gelu {library_ms:.3f} ms (cos vs plain "
                f"{lib_cos:.7f}); bound {bound_ms:.4f} ms ({bound_by})")
            if dt == torch.float32:
                require(err <= 1e-4 * float(ref.abs().max()), f"K5 {name} max_abs {err} > 1e-4 x max|ref|")
            else:
                require(cos >= 0.999, f"K5 {name} cosine {cos} < 0.999")
            require(again, f"K5 {name} gave different bits on a rerun")
            main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            del x, w_up, w_down, out, ref, wu, wd
            torch.cuda.empty_cache()
    # Waves: a cluster owns 128 rows, one CTA an SM. If 15 clusters fit on the
    # card at once, 8 and 15 clusters take one wave, 16 two and XLS-R-2B's 63
    # five. bf16 at the XLS-R-2B widths, weights cast beforehand.
    x, w_up, b_up, w_down, b_down = _ffn_inputs(g, 16 * 499, 1920, 7680, torch.bfloat16)
    w_up, w_down = w_up.to(torch.bfloat16), w_down.to(torch.bfloat16)
    waves = {str(M): median_ms(lambda: k_ffn.ffn_fused(x[:M], w_up, b_up, w_down, b_down, True))
             for M in (1024, 1920, 2048, 4096, 16 * 499)}
    log("[parity] K5 ffn_fused bf16 1920->7680->1920 by rows: "
        + ", ".join(f"M {m} ({-(-int(m) // 128)} clusters) {t:.3f} ms" for m, t in waves.items()))
    main["bf16_ms_by_rows"] = waves
    del x, w_up, w_down
    torch.cuda.empty_cache()
    results["ffn_fused"] = main


def check_pos_conv(g, results) -> None:
    """K8, the grouped positional conv (K = 128 taps, 16 groups, T = 499
    frames -> 500), at XLS-R-2B (C = 120 channels a group, B = 16),
    WavLM-large (C = 64, B = 32) and the base encoders (C = 48, B = 32), f32
    and bf16. Bars: f32 max-abs <= 1e-4 x max|ref|, bf16 cosine >= 0.999, a
    rerun bit-identical. ``ms`` is the wrapper's call, which lays the weight
    out afresh each time (``relayout_ms``, 118 MB of f32 read at C = 120, by
    K8's layout kernel, bit-identical to torch's permuted copy, whose time
    is ``relayout_torch_ms``),
    ``kernel_ms`` the launch alone on the laid-out weight, each one call
    alone with its host time, as every kernel is timed; ``run_ms`` and
    ``host_ms`` are the wrapper's device and host time a call in a run of
    back-to-back calls (``run_ms``). Yardstick: cuDNN ``F.conv1d(groups=16)``
    in the compute dtype on [B, D, T], timed as ``ms``."""
    import torch.nn.functional as F

    main = {}
    for shape, (B, C) in (("xlsr_2b", (16, 120)), ("wavlm", (32, 64)), ("base", (32, 48))):
        D, T, K = 16 * C, 499, 128
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(B, T, D, generator=g, device="cuda").to(dt)
            w = torch.randn(D, C, K, generator=g, device="cuda") / (C * K) ** 0.5
            out = k_pos.pos_conv(x, w, 16)
            ref = k_pos.pos_conv_plain(x, w, 16)
            err, cos = max_abs(out, ref), cosine(out, ref)
            again = torch.equal(out, k_pos.pos_conv(x, w, 16))
            ms = median_ms(lambda: k_pos.pos_conv(x, w, 16))
            in_run, host_ms = run_ms(lambda: k_pos.pos_conv(x, w, 16))
            nbytes = x.element_size() * (x.numel() + w.numel() + out.numel())
            flops = 2 * B * (T + 1) * D * K * C
            bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
            relayout_ms = kernel_ms = copy_ms = None
            split = ""
            if hasattr(k_pos, "weight_layout"):  # an older checkout's package (the A/B script) has no such split
                wl = k_pos.weight_layout(w, 16, dt)
                wg = w.view(16, C, C, K)
                wg = wg.permute(0, 3, 1, 2) if dt == torch.bfloat16 else wg.permute(0, 2, 3, 1)
                require(torch.equal(wl, torch.empty(wg.shape, dtype=dt, device="cuda").copy_(wg)),
                        f"K8 {dt} weight layout differs from torch's permuted copy")
                relayout_ms = median_ms(lambda: k_pos.weight_layout(w, 16, dt))
                copy_ms = median_ms(lambda: torch.empty(wg.shape, dtype=dt, device="cuda").copy_(wg))
                kernel_ms = median_ms(lambda: k_pos.launch(x, wl, 16, K))
                plan = k_pos.pos_conv_plan(C, K, dt)
                split = (f" = weight re-layout {relayout_ms:.3f} (torch's permuted copy {copy_ms:.3f}) + launch "
                         f"{kernel_ms:.3f} ({flops / kernel_ms / 1e9:.1f}"
                         f" TFLOP/s, {bound_ms / kernel_ms:.1%} of the bound; {plan.frames} frames x {plan.threads}"
                         f" threads a block)")
                del wl, wg
            plain_ms = median_ms(lambda: k_pos.pos_conv_plain(x, w, 16))
            xt, wt = x.transpose(1, 2).contiguous(), w.to(dt)
            library_ms = median_ms(lambda: F.conv1d(xt, wt, padding=K // 2, groups=16))
            lib_cos = cosine(F.conv1d(xt, wt, padding=K // 2, groups=16).transpose(1, 2), ref)
            dname = "f32" if dt == torch.float32 else "bf16"
            name = dname if shape == "xlsr_2b" else f"{shape}_{dname}"
            log(f"[parity] K8 pos_conv {shape} B{B} T{T} D{D} C{C} K{K} {dname}: max_abs {err:.3e} "
                f"(max|ref| {float(ref.abs().max()):.3f}) cos {cos:.7f}; bit-identical rerun {again}; kernel "
                f"{ms:.4f} ms{split} (in a run of 10 calls {in_run:.4f} ms and {1e3 * host_ms:.1f} us of host time a "
                f"call), plain {plain_ms:.3f} ms, cuDNN "
                f"F.conv1d(groups=16) {library_ms:.4f} ms "
                f"(cos vs plain {lib_cos:.7f}); bound {bound_ms:.4f} ms ({bound_by})")
            if dt == torch.float32:
                require(err <= 1e-4 * float(ref.abs().max()), f"K8 {name} max_abs {err} > 1e-4 x max|ref|")
            else:
                require(cos >= 0.999, f"K8 {name} cosine {cos} < 0.999")
            require(again, f"K8 {name} gave different bits on a rerun")
            main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, run_ms=in_run, host_ms=host_ms,
                              relayout_ms=relayout_ms, relayout_torch_ms=copy_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                              library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
            del x, xt, out, ref
            torch.cuda.empty_cache()
    results["pos_conv"] = main


def _gru_inputs(g, B: int, T: int, H: int, min_len: int = 150):
    """The fusion BiGRU at the main path's shapes: 2B stacked rows, ragged
    lengths from ``min_len`` to T (prefix masks; the backward rows reversed
    in time)."""
    dev = "cuda"
    bound = H ** -0.5
    x_proj = 0.5 * torch.randn(2 * B, T, 3 * H, generator=g, device=dev)
    w_hh2 = (torch.rand(2, H, 3 * H, generator=g, device=dev) * 2 - 1) * bound
    b_hh2 = (torch.rand(2, 3 * H, generator=g, device=dev) * 2 - 1) * bound
    lengths = torch.randint(min_len, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    m = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    mask = torch.cat([m, m.flip(1)], dim=0).contiguous()
    return x_proj, w_hh2, b_hh2, mask, lengths


def _cudnn_gru(x_proj, w_hh2, b_hh2, lengths):
    """One cuDNN ``nn.GRU(6H -> H, bidirectional)`` that computes K3's function:
    input [x_proj_f | x_proj_b un-reversed], W_ih = [I 0] and [0 I], b_ih = 0,
    packed by lengths. Returns the module and its packed input."""
    from torch.nn.utils.rnn import pack_padded_sequence

    B = x_proj.shape[0] // 2
    H = w_hh2.shape[1]
    gru = torch.nn.GRU(6 * H, H, batch_first=True, bidirectional=True).cuda()
    eye = torch.eye(3 * H, device="cuda")
    zero = torch.zeros_like(eye)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.cat([eye, zero], 1))
        gru.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], 1))
        gru.bias_ih_l0.zero_()
        gru.bias_ih_l0_reverse.zero_()
        for d, sfx in ((0, ""), (1, "_reverse")):
            getattr(gru, f"weight_hh_l0{sfx}").copy_(w_hh2[d].t())
            getattr(gru, f"bias_hh_l0{sfx}").copy_(b_hh2[d])
    x = torch.cat([x_proj[:B], x_proj[B:].flip(1)], dim=-1).requires_grad_()
    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True, enforce_sorted=False)
    return gru, x, packed


def _unpack(gru_out, T: int) -> torch.Tensor:
    from torch.nn.utils.rnn import pad_packed_sequence

    return pad_packed_sequence(gru_out, batch_first=True, total_length=T)[0]


def check_gru(g, results) -> None:
    """K3 at the fusion trainer's batch (2B=128 rows, T=512, H=512, ragged
    prefix masks) against its plain version and cuDNN ``nn.GRU``, with the
    route, cluster size C and rows R the launch planner took and how many such
    clusters the card holds at once; then edge cases: 2B=74 (not a multiple
    of R), a mask with holes (not a prefix), H=100 (not a multiple of the
    cluster's 32 units a CTA) and H=640 (the one-block-per-row route). Bar:
    f32 max-abs <= 1e-4 on every case. Also times cuDNN's identity input
    projection alone (one ``F.linear`` of [64*512, 6H] x [6H, 3H]; ``nn.GRU``
    runs one per direction), the part of the yardstick that is not the
    recurrence."""
    import torch.nn.functional as F

    B, T, H = 64, 512, 512
    x_proj, w_hh2, b_hh2, mask, lengths = _gru_inputs(g, B, T, H)
    args = (x_proj, w_hh2, b_hh2, mask, B)
    plan = k_gru.gru_bidir_plan(2 * B, H)
    active = k_gru.max_active_clusters(H) if plan.route == "cluster" else None
    with torch.no_grad():
        out = k_gru.gru_sequence_bidir(*args)
        ref_card = k_gru.gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None]
        err, cos = max_abs(out, ref_card), cosine(out, ref_card)
        ms = median_ms(lambda: k_gru.gru_sequence_bidir(*args))
        plain_ms = median_ms(lambda: k_gru.gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None])
        gru, _, packed = _cudnn_gru(x_proj, w_hh2, b_hh2, lengths)
        lib = _unpack(gru(packed)[0], T)
        lib_err = max_abs(lib, torch.cat([out[:B], out[B:].flip(1)], dim=-1))
        library_ms = median_ms(lambda: gru(packed))
        x_in = torch.randn(B * T, 6 * H, generator=g, device="cuda")
        proj_ms = median_ms(lambda: F.linear(x_in, gru.weight_ih_l0))
        del gru, packed, lib, x_in
    valid = float(mask.sum())
    nbytes = 4 * (x_proj.numel() + w_hh2.numel() + b_hh2.numel() + mask.numel() + out.numel())
    bound_ms, bound_by = roofline_ms(nbytes, valid * (6 * H * H + 12 * H), PEAK_F32)
    log(f"[parity] K3 gru_bidir x_proj[128,512,1536] H512 ragged f32: route {plan.route}, C={plan.cluster} CTAs "
        f"x R={plan.rows} rows a cluster, {plan.smem_bytes} B of shared memory a CTA, grid {plan.grid}, "
        f"{active} such clusters resident at once; max_abs {err:.3e} cos {cos:.7f}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN nn.GRU {library_ms:.3f} ms "
        f"(incl. identity input projection, {proj_ms:.3f} ms a direction alone; vs K3 max_abs {lib_err:.3e}); "
        f"bound {bound_ms:.3f} ms ({bound_by})")
    require(err <= 1e-4, f"K3 f32 max_abs {err} > 1e-4")
    require(lib_err <= 1e-3, f"cuDNN GRU yardstick differs from K3 by {lib_err}: not the same function")
    main = {"f32": dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        library_input_projection_ms=proj_ms, bound_ms=bound_ms, bound_by=bound_by,
                        route=plan.route, cluster=plan.cluster, rows=plan.rows, smem_bytes=plan.smem_bytes,
                        max_active_clusters=active)}
    del x_proj, w_hh2, b_hh2, mask, out, ref_card
    for name, (B, T, H), holes in (("odd_rows", (37, 96, 512), False), ("holes", (64, 96, 512), True),
                                   ("h100", (5, 64, 100), True), ("row_route", (6, 64, 640), True)):
        x_proj, w_hh2, b_hh2, mask, _ = _gru_inputs(g, B, T, H, min_len=T // 3)
        if holes:  # a third of the steps masked anywhere, in both directions
            mask = (mask * (torch.rand(mask.shape, generator=g, device="cuda") > 0.33).float()).contiguous()
        plan = k_gru.gru_bidir_plan(2 * B, H)
        with torch.no_grad():
            out = k_gru.gru_bidir_carries(x_proj, w_hh2, b_hh2, mask)
            ref = k_gru.gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask)
        e = max_abs(out, ref)
        log(f"[parity] K3 gru_bidir {name} 2B={2 * B} T={T} H={H} holes={holes}: route {plan.route}, "
            f"C={plan.cluster}, R={plan.rows}; max_abs {e:.3e}")
        require(e <= 1e-4, f"K3 {name} f32 max_abs {e} > 1e-4")
        main[name] = dict(max_abs_err=e, route=plan.route, cluster=plan.cluster, rows=plan.rows)
    results["gru_bidir"] = main


def check_gru_sequence(g, results) -> None:
    """K9, one direction of the masked GRU, forward and reverse, at B=64,
    T=512, H=512 with ragged prefix masks. Bar: f32 max-abs <= 1e-5 (the
    outputs lie in [-1, 1]). Yardstick: one cuDNN unidirectional
    ``nn.GRU(3H -> H)`` with an identity input projection, packed by
    lengths; for the reverse case each row's valid prefix is reversed
    before it (outside the timing), which is what K9's reverse order does
    with a prefix mask."""
    from torch.nn.utils.rnn import pack_padded_sequence

    B, T, H = 64, 512, 512
    dev = "cuda"
    bound = H ** -0.5
    x_proj = 0.5 * torch.randn(B, T, 3 * H, generator=g, device=dev)
    w_hh = (torch.rand(H, 3 * H, generator=g, device=dev) * 2 - 1) * bound
    b_hh = (torch.rand(3 * H, generator=g, device=dev) * 2 - 1) * bound
    lengths = torch.randint(150, T + 1, (B,), generator=g, device=dev)
    lengths[0] = T
    steps = torch.arange(T, device=dev)[None]
    mask = (steps < lengths[:, None]).float()
    # row b's valid prefix reversed: position i holds step len_b - 1 - i
    rev = torch.where(steps < lengths[:, None], lengths[:, None] - 1 - steps, steps)
    plan = k_gru.gru_sequence_plan(B, H)
    active = k_gru.max_active_clusters(H, "gru_sequence") if plan.route == "cluster" else None
    log(f"[parity] K9 gru_sequence B={B} H={H}: route {plan.route}, C={plan.cluster} CTAs x R={plan.rows} rows a "
        f"cluster, {plan.smem_bytes} B of shared memory a CTA, grid {plan.grid}, {active} such clusters resident")
    gru = torch.nn.GRU(3 * H, H, batch_first=True).cuda()
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * H, device=dev))
        gru.bias_ih_l0.zero_()
        gru.weight_hh_l0.copy_(w_hh.t())
        gru.bias_hh_l0.copy_(b_hh)
    main = {}
    with torch.no_grad():
        for reverse in (False, True):
            args = (x_proj, w_hh, b_hh, mask, reverse)
            out = k_gru.gru_sequence(*args)
            ref = k_gru.gru_sequence_plain(*args)
            err, cos = max_abs(out, ref), cosine(out, ref)
            ms = median_ms(lambda: k_gru.gru_sequence(*args))
            plain_ms = median_ms(lambda: k_gru.gru_sequence_plain(*args))
            xin = torch.gather(x_proj, 1, rev[:, :, None].expand(-1, -1, 3 * H)) if reverse else x_proj
            packed = pack_padded_sequence(xin, lengths.cpu(), batch_first=True, enforce_sorted=False)
            lib = _unpack(gru(packed)[0], T)
            if reverse:
                lib = torch.gather(lib, 1, rev[:, :, None].expand(-1, -1, H))
            lib_err = max_abs(lib, out)
            library_ms = median_ms(lambda: gru(packed))
            valid = float(mask.sum())
            nbytes = 4 * (x_proj.numel() + w_hh.numel() + b_hh.numel() + mask.numel() + out.numel())
            bound_ms, bound_by = roofline_ms(nbytes, valid * (6 * H * H + 12 * H), PEAK_F32)
            name = "reverse_f32" if reverse else "f32"
            log(f"[parity] K9 gru_sequence x_proj[64,512,1536] H512 ragged {name}: max_abs {err:.3e} cos "
                f"{cos:.7f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN nn.GRU {library_ms:.3f} ms "
                f"(incl. identity input projection; vs K9 max_abs {lib_err:.3e}); bound {bound_ms:.3f} ms ({bound_by})")
            require(err <= 1e-5, f"K9 {name} max_abs {err} > 1e-5")
            require(lib_err <= 1e-3, f"cuDNN GRU yardstick differs from K9 by {lib_err}: not the same function")
            main[name] = dict(max_abs_err=err, cosine=cos, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, route=plan.route, cluster=plan.cluster,
                              max_active_clusters=active)
    results["gru_sequence"] = main


def _gru_bwd_errors(out, ref) -> dict:
    """K3b's bars: dx_proj max-abs / max(1, max|ref|); dW_hh2 and db_hh2 (sums
    over rows and steps) max-abs / max|ref|."""
    return {
        "dx_proj": max_abs(out[0], ref[0]) / max(1.0, float(ref[0].abs().max())),
        "dW_hh2": max_abs(out[1], ref[1]) / float(ref[1].abs().max()),
        "db_hh2": max_abs(out[2], ref[2]) / float(ref[2].abs().max()),
    }


def check_gru_bwd(g, results) -> None:
    """K3b against the plain backward on the card, on K3's carries and a
    non-uniform upstream cotangent, at the fusion trainer's batch (2B=128,
    T=512, H=512), with its route, the clusters resident at once and the
    times of its three stages apart (the gate recompute, the recurrence, the
    dW / db product); then edge cases: 2B=74 (a partial row group), a mask
    with holes, H=100 (not a multiple of 32), H=640 and H=3000 (the
    one-block-per-row route). Bars: dx_proj max-abs <= 1e-4 x max(1,
    max|ref|); dW_hh2 and db_hh2 max-abs <= 1e-4 x max|ref|; reruns
    bit-identical."""
    B, T, H = 64, 512, 512
    x_proj, w_hh2, b_hh2, mask, lengths = _gru_inputs(g, B, T, H)
    plan = k_gru.gru_bidir_bwd_plan(2 * B, H)
    active = k_gru.max_active_clusters(H, "gru_bidir_bwd") if plan.route == "cluster" else None
    with torch.no_grad():
        h = k_gru.gru_bidir_carries(x_proj, w_hh2, b_hh2, mask)
        scale = 0.5 + torch.rand(2 * B, T, 1, generator=g, device="cuda")
        gr = torch.randn(2 * B, T, H, generator=g, device="cuda") * scale
        args = (x_proj, w_hh2, b_hh2, mask, h, gr)
        out = k_gru.gru_bidir_carries_bwd(*args)
        ref = k_gru.gru_bidir_carries_bwd_plain(*args)
        dx_ref = float(ref[0].abs().max())
        errs = _gru_bwd_errors(out, ref)
        again = k_gru.gru_bidir_carries_bwd(*args)
        deterministic = all(torch.equal(a, b) for a, b in zip(out, again))
        del again, ref
        ms = median_ms(lambda: k_gru.gru_bidir_carries_bwd(*args))
        plain_ms = median_ms(lambda: k_gru.gru_bidir_carries_bwd_plain(*args))
        # the stages apart, on the same inputs (launches to time, not counted)
        hp = k_gru.gate_preacts(h, w_hh2, b_hh2)
        gates_ms = median_ms(lambda: k_gru.gate_preacts(h, w_hh2, b_hh2))
        dhp = k_gru.bwd_recurrence(*args, hp)[1]
        recurrence_ms = median_ms(lambda: k_gru.bwd_recurrence(*args, hp))
        dw_ms = median_ms(lambda: k_gru.bwd_weight_grads(h, dhp))
        del hp, dhp
    # cuDNN's backward of the same function (it also differentiates its identity
    # input projection: dX and dW_ih, two [N, 6H] x [6H, 3H]-sized products)
    gru, x, packed = _cudnn_gru(x_proj, w_hh2, b_hh2, lengths)
    lib_out = _unpack(gru(packed)[0], T)
    gm = gr * mask[:, :, None]
    g_lib = torch.cat([gm[:B], gm[B:].flip(1)], dim=-1)
    wrt = [x] + list(gru.parameters())
    lib_grads = torch.autograd.grad(lib_out, wrt, g_lib, retain_graph=True)
    ref_m = k_gru.gru_bidir_carries_bwd_plain(x_proj, w_hh2, b_hh2, mask, h, gm)
    lib_err = max_abs(lib_grads[0][..., : 3 * H], ref_m[0][:B]) / max(1.0, float(ref_m[0].abs().max()))
    library_ms = median_ms(lambda: torch.autograd.grad(lib_out, wrt, g_lib, retain_graph=True))
    del lib_out, lib_grads, gru, x, packed, ref_m
    valid = float(mask.sum())
    nbytes = 4 * (x_proj.numel() + w_hh2.numel() + b_hh2.numel() + mask.numel() + h.numel()
                  + gr.numel() + out[0].numel() + out[1].numel() + out[2].numel())
    bound_ms, bound_by = roofline_ms(nbytes, valid * (18 * H * H + 30 * H), PEAK_F32)
    log(f"[parity] K3b gru_bidir_bwd [128,512] H512 ragged f32: route {plan.route}, C={plan.cluster} CTAs x "
        f"R={plan.rows} rows a cluster, {plan.smem_bytes} B of shared memory a CTA, grid {plan.grid}, {active} "
        f"such clusters resident at once, dW in {k_gru.dw_splits(2 * B, T, H)} row-step chunks; dx_proj "
        f"max_abs/max(1,|ref|) {errs['dx_proj']:.3e} (max|ref| {dx_ref:.3f}), dW rel {errs['dW_hh2']:.3e}, "
        f"db rel {errs['db_hh2']:.3e}; bit-identical rerun {deterministic}; kernel {ms:.3f} ms (gate recompute "
        f"{gates_ms:.3f}, recurrence {recurrence_ms:.3f}, dW/db {dw_ms:.3f}), plain {plain_ms:.3f} ms, cuDNN "
        f"nn.GRU backward {library_ms:.3f} ms (incl. the identity input projection's backward; dx vs plain "
        f"{lib_err:.3e}); bound {bound_ms:.3f} ms ({bound_by})")
    for name, e in errs.items():
        require(e <= 1e-4, f"K3b {name} error {e} > 1e-4")
    require(deterministic, "K3b gave different bits on a rerun")
    require(lib_err <= 1e-3, f"cuDNN GRU backward differs from the plain backward by {lib_err}")
    main = {"f32": dict(
        max_abs_err=max(errs.values()), rel_errs=errs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, gates_ms=gates_ms, recurrence_ms=recurrence_ms, dw_ms=dw_ms,
        route=plan.route, cluster=plan.cluster, rows=plan.rows, smem_bytes=plan.smem_bytes,
        max_active_clusters=active)}
    del x_proj, w_hh2, b_hh2, mask, h, gr, out, args
    for name, (B, T, H), holes in (("odd_rows", (37, 96, 512), False), ("holes", (64, 96, 512), True),
                                   ("h100", (5, 64, 100), True), ("row_route", (6, 64, 640), True),
                                   ("h3000", (2, 16, 3000), True)):
        x_proj, w_hh2, b_hh2, mask, _ = _gru_inputs(g, B, T, H, min_len=T // 3)
        if holes:  # a third of the steps masked anywhere, in both directions, and one step in every row
            mask = (mask * (torch.rand(mask.shape, generator=g, device="cuda") > 0.33).float())
            mask[:, T // 2] = 0
            mask = mask.contiguous()
        plan = k_gru.gru_bidir_bwd_plan(2 * B, H)
        with torch.no_grad():
            h = k_gru.gru_bidir_carries(x_proj, w_hh2, b_hh2, mask)
            gr = torch.randn(2 * B, T, H, generator=g, device="cuda")
            args = (x_proj, w_hh2, b_hh2, mask, h, gr)
            out = k_gru.gru_bidir_carries_bwd(*args)
            errs = _gru_bwd_errors(out, k_gru.gru_bidir_carries_bwd_plain(*args))
            same = all(torch.equal(a, b) for a, b in zip(out, k_gru.gru_bidir_carries_bwd(*args)))
        log(f"[parity] K3b gru_bidir_bwd {name} 2B={2 * B} T={T} H={H} holes={holes}: route {plan.route}, "
            f"C={plan.cluster}, R={plan.rows}; dx {errs['dx_proj']:.3e}, dW rel {errs['dW_hh2']:.3e}, db rel "
            f"{errs['db_hh2']:.3e}; bit-identical rerun {same}")
        for what, e in errs.items():
            require(e <= 1e-4, f"K3b {name} {what} error {e} > 1e-4")
        require(same, f"K3b {name} gave different bits on a rerun")
        main[name] = dict(max_abs_err=max(errs.values()), rel_errs=errs, route=plan.route, cluster=plan.cluster)
    results["gru_bidir_bwd"] = main


def _sdpa_bwd_yardstick(q, k, v, g, H, key_mask, gate, pos_bias, ref):
    """Autograd through ``scaled_dot_product_attention`` (with the float mask
    gate * bias + key mask where there is a bias, and its gradient then too;
    the key mask alone without a bias):
    the backward of K1's function. Its median ms (graph built once, outside
    the timing) and its dq's max-abs gap to the plain backward's."""
    import torch.nn.functional as F

    B, T, D = q.shape
    heads = [t.detach().view(B, T, H, D // H).transpose(1, 2).requires_grad_() for t in (q, k, v)]
    wrt, attn_mask = list(heads), None
    if key_mask is not None:
        attn_mask = torch.zeros_like(key_mask).masked_fill(key_mask == 0, float("-inf"))[:, None, None, :]
    if pos_bias is not None:
        attn_mask = (gate[..., None] * pos_bias[None] + (0 if attn_mask is None else attn_mask)).to(q.dtype)
        attn_mask.requires_grad_()
        wrt.append(attn_mask)
    elif attn_mask is not None:
        attn_mask = attn_mask.to(q.dtype)
    out = F.scaled_dot_product_attention(*heads, attn_mask=attn_mask)
    gh = g.view(B, T, H, D // H).transpose(1, 2)
    dq = torch.autograd.grad(out, wrt, gh, retain_graph=True)[0].transpose(1, 2).reshape(B, T, D)
    ms = median_ms(lambda: torch.autograd.grad(out, wrt, gh, retain_graph=True))
    return ms, max_abs(dq, ref)


def check_attention_bwd(g, results) -> None:
    """K4 against the plain backward on the card, on K1's output and lse, at
    the Whisper-large fine-tune shape (B=8, T=1500, D=1280, H=20, no bias, no
    mask), the WavLM-large shape (B=8, T=499, D=1024, H=16, gated bias
    and ragged key mask, every cotangent asked for) and HuBERT-XL's and
    XLS-R-2B's head dims (80 and 120: B=16, T=499, D=1280 / 1920, H=16,
    ragged key mask, with and without the gated bias), f32 and bf16. Bars: f32
    max-abs <= 1e-5 x max|ref| per output; bf16 cosine >= 0.999; a rerun
    bit-identical."""
    wavlm_lengths = [499, 480, 451, 400, 333, 250, 130, 64]
    zoo_lengths = wavlm_lengths + [499, 470, 402, 380, 310, 222, 160, 90]
    for shape, (B, T, D, H), lengths, bias in (("whisper", (8, 1500, 1280, 20), None, False),
                                               ("wavlm", (8, 499, 1024, 16), wavlm_lengths, True),
                                               ("hd80", (16, 499, 1280, 16), zoo_lengths, False),
                                               ("hd80_bias", (16, 499, 1280, 16), zoo_lengths, True),
                                               ("hd120", (16, 499, 1920, 16), zoo_lengths, False),
                                               ("hd120_bias", (16, 499, 1920, 16), zoo_lengths, True)):
        for dt in (torch.float32, torch.bfloat16):
            (q, k, v, _), kw = _attention_inputs(g, B, T, D, H, lengths, bias, dt)
            gr = torch.randn(B, T, D, generator=g, device="cuda").to(dt)
            out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
            args = (q, k, v, gr, H)
            got = k_attn.attention_btd_bwd(*args, **kw, out=out, lse=lse)
            ref = k_attn.attention_btd_bwd_plain(*args, **kw)
            again = k_attn.attention_btd_bwd(*args, **kw, out=out, lse=lse)
            deterministic = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
            names = ("dq", "dk", "dv", "dgate", "dbias")
            rel = {n: max_abs(a, b) / float(b.abs().max()) for n, a, b in zip(names, got, ref) if b is not None}
            cos = {n: cosine(a, b) for n, a, b in zip(names, got, ref) if b is not None}
            ms = median_ms(lambda: k_attn.attention_btd_bwd(*args, **kw, out=out, lse=lse))
            plain_ms = median_ms(lambda: k_attn.attention_btd_bwd_plain(*args, **kw))
            library_ms, lib_err = _sdpa_bwd_yardstick(*args, **kw, ref=ref[0])
            live = B * T if lengths is None else sum(lengths)
            item = q.element_size()
            nbytes = item * 7 * q.numel()  # q, k, v, g in; dq, dk, dv out
            if bias:
                nbytes += 4 * (kw["key_mask"].numel() + 2 * kw["gate"].numel()) + (item + 4) * kw["pos_bias"].numel()
            flops = 10 * H * T * (D // H) * live  # QK^T, dP = gV^T, dV, dQ, dK over live keys
            bound_ms, bound_by = roofline_ms(nbytes, flops, PEAK_F32 if dt == torch.float32 else PEAK_BF16)
            name = ("f32" if dt == torch.float32 else "bf16") if shape == "whisper" else \
                f"{shape}_" + ("f32" if dt == torch.float32 else "bf16")
            log(f"[parity] K4 attention_btd_bwd {shape} B{B} T{T} D{D} H{H} bias={bias} mask={lengths is not None} "
                f"{name}: rel max-abs {', '.join(f'{n} {e:.2e}' for n, e in rel.items())}; cos min "
                f"{min(cos.values()):.7f}; bit-identical rerun {deterministic}; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms (dq vs plain {lib_err:.3e}); "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if dt == torch.float32:
                for n, e in rel.items():
                    require(e <= 1e-5, f"K4 {shape} f32 {n} relative max-abs {e} > 1e-5")
            else:
                for n, c in cos.items():
                    require(c >= 0.999, f"K4 {shape} bf16 {n} cosine {c} < 0.999")
            require(deterministic, f"K4 {shape} {name} gave different bits on a rerun")
            results.setdefault("attention_btd_bwd", {})[name] = dict(
                max_abs_err=max(rel.values()), rel_errs=rel, cosine=min(cos.values()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            del got, ref, again, out, lse
            torch.cuda.empty_cache()


def check_attention_dead_row(g, results) -> None:
    """K1 and K4 against their plain versions at every head dim (64, 80,
    120; H=16) and both lengths (T=499 and 1500, neither a multiple of the
    64-key tile), f32 (the FP32-pipe kernels) and bf16 (the tensor-core
    kernels), with a ragged key mask in which row 1 has no live key at all.
    That row gets what the TPU kernel gives it: sum(V) / Tk_p (Tk_p = T
    rounded up to 128), lse -inf, and in the backward P = 1 / Tk_p on every
    key. Gated bias at T=499 (WavLM's case). Bars: f32 K1 max-abs <= 1e-4 x
    max|ref| and K4 <= 1e-5 x max|ref| per output, that row alone max-abs
    <= 1e-5; bf16 cosine >= 0.999 over every output and that row alone, and
    there (where cosine cannot see a wrong scale such as Tk for Tk_p) max-abs
    <= 1e-2 x max|ref| of the row; a rerun of K4 bit-identical."""
    for dt in (torch.float32, torch.bfloat16):
        f32 = dt == torch.float32
        for hd in (64, 80, 120):
            for T in (499, 1500):
                B, H = (4, 16) if T == 499 else (2, 16)
                lengths = [T, 0, T - 77, 130][:B] if B == 4 else [T - 3, 0]
                D = H * hd
                bias = T == 499
                (q, k, v, _), kw = _attention_inputs(g, B, T, D, H, lengths, bias, dt)
                gr = torch.randn(B, T, D, generator=g, device="cuda").to(dt)
                out, lse = k_attn.attention_btd_fwd(q, k, v, H, **kw)
                ref = k_attn.attention_btd_plain(q, k, v, H, **kw)
                lse_ok = bool(torch.isinf(lse[1]).all())
                ref_b = k_attn.attention_btd_bwd_plain(q, k, v, gr, H, **kw)
                got = k_attn.attention_btd_bwd(q, k, v, gr, H, **kw, out=out, lse=lse)
                again = k_attn.attention_btd_bwd(q, k, v, gr, H, **kw, out=out, lse=lse)
                same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
                # per output: (cosine, max-abs / max|ref|) over every row, and the same on row 1
                stats = {"out": (cosine(out, ref), max_abs(out, ref) / float(ref.abs().max()),
                                 cosine(out[1], ref[1]), max_abs(out[1], ref[1]),
                                 max_abs(out[1], ref[1]) / float(ref[1].abs().max()))}
                for n, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, ref_b):
                    if b is None:
                        continue
                    stats[n] = (cosine(a, b), max_abs(a, b) / float(b.abs().max())) + (
                        () if n == "dbias" else
                        (cosine(a[1], b[1]), max_abs(a[1], b[1]), max_abs(a[1], b[1]) / float(b[1].abs().max())))
                name = f"{'f32' if f32 else 'tc'}_hd{hd}_T{T}"
                log(f"[parity] K1 + K4 {'f32' if f32 else 'bf16 tensor cores'} hd {hd} B{B} T{T} H{H} bias={bias} "
                    f"row 1 fully masked (lse -inf {lse_ok}, K4 rerun bit-identical {same}): " + "; ".join(
                        f"{n} cos {st[0]:.7f} rel {st[1]:.2e}"
                        + (f", row 1 cos {st[2]:.7f} max_abs {st[3]:.2e} rel {st[4]:.2e}" if len(st) > 2 else "")
                        for n, st in stats.items()))
                for n, st in stats.items():
                    what = f"{'K1' if n == 'out' else 'K4'} {name} {n}"
                    if f32:
                        bar = 1e-4 if n == "out" else 1e-5
                        require(st[1] <= bar, f"{what} max-abs {st[1]} x max|ref| > {bar}")
                    else:
                        require(st[0] >= 0.999, f"{what} cosine {st[0]} < 0.999")
                    if len(st) == 2:  # dbias has no batch row
                        continue
                    if f32:
                        require(st[3] <= 1e-5, f"{what} row 1 max-abs {st[3]} > 1e-5")
                    else:
                        require(st[2] >= 0.999, f"{what} row 1 cosine {st[2]} < 0.999")
                        require(st[4] <= 1e-2, f"{what} row 1 max-abs {st[4]} x max|ref| > 1e-2")
                require(lse_ok, f"{name}: K1's lse of the fully masked row is not -inf")
                require(same, f"K4 {name} gave different bits on a rerun")
                results.setdefault("attention_btd", {})[name] = dict(cosine=stats["out"][0], dead_row_max_abs=stats["out"][3])
                results.setdefault("attention_btd_bwd", {})[name] = dict(
                    cosine=min(st[0] for n, st in stats.items() if n != "out"),
                    dead_row_max_abs=max(st[3] for n, st in stats.items() if n != "out" and len(st) > 2))
                del q, k, v, gr, out, lse, ref, ref_b, got, again
                torch.cuda.empty_cache()


# -- phases 4-5 -------------------------------------------------------------------


def write_wav(path: str, samples: np.ndarray, sr: int = 16000) -> None:
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_wavs(wav_dir: str, n: int, seconds, seed: int, prefix: str = "utt") -> dict:
    """``n`` seeded tones in noise of ``seconds`` (lo, hi) as ``<prefix><i>.wav``
    -> {stem: samples}."""
    rng = np.random.default_rng(seed)
    os.makedirs(wav_dir, exist_ok=True)
    lengths = {}
    for i in range(n):
        m = int(rng.uniform(*seconds) * 16000)
        t = np.arange(m) / 16000.0
        write_wav(os.path.join(wav_dir, f"{prefix}{i}.wav"),
                  0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(m))
        lengths[f"{prefix}{i}"] = m
    return lengths


def write_speech_model(model_dir: str, cfg, architecture: str, do_normalize: bool = True) -> None:
    """A seeded random-init speech encoder as an HF directory (the port's own
    HF key names; no transformers on the card's machine)."""
    from interspeech_ser_tpu_torch.models.speech import SpeechEncoderModel

    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = SpeechEncoderModel(cfg)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.to_hf(), "architectures": [architecture]}, f, indent=1)
    with open(os.path.join(model_dir, "preprocessor_config.json"), "w") as f:
        json.dump({"do_normalize": do_normalize, "sampling_rate": 16000}, f)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(model_dir, "pytorch_model.bin"))
    del model


def write_wavlm_large(model_dir: str) -> None:
    """Seeded random-init WavLM-large as an HF directory."""
    from interspeech_ser_tpu_torch.models.speech import wavlm_large

    write_speech_model(model_dir, wavlm_large(), "WavLMModel")


def counts() -> dict:
    return {name: getattr(spec["module"], spec.get("counter", "LAUNCHES")) for name, spec in KERNELS.items()}


def zero_counts() -> None:
    for spec in KERNELS.values():
        setattr(spec["module"], spec.get("counter", "LAUNCHES"), 0)


def phase_extraction(tmp: str, smi: str) -> dict:
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder
    from interspeech_ser_tpu_torch.models.speech import feat_extract_output_length, wavlm_large
    from interspeech_ser_tpu_torch.preprocess_cli import speech_main
    from interspeech_ser_tpu_torch.utils.audio import load_wav, normalize_waveform

    wav_dir = os.path.join(tmp, "wavs")
    n_samples = write_wavs(wav_dir, 8, (3.0, 12.0), SEED)
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
                             "--dtype", dtype, "--device", DEVICE])
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
    b32 = profile_wavlm_large(tmp, model_dir, smi)
    return {"utt_per_sec": rates, "feats_dir": os.path.join(tmp, "feats_float32"),
            "names": sorted(n_samples), "b32_bf16": b32["bfloat16"], "b32_f32": b32["float32"]}


# WavLM-large extraction at the default token budget (bf16, then f32): 32 x 10 s = 320 s, one batch
WAVLM_B32_SHAPE = dict(n_wavs=32, seconds=10.0)


def profile_wavlm_large(tmp: str, model_dir: str, smi: str) -> dict:
    """WavLM-large extraction at the default token budget: 32 seeded 10-s
    wavs in one B=32 batch through ``SpeechExtractionPipeline.run``, built
    as ``preprocess_cli speech`` builds it, in bf16 and then in f32 (the
    CLI's default dtype). bf16: one warm run timed (utt/s). Each dtype: a
    profile of another warm run: device busy and idle share, the shares of
    K1, K2's layer-0 kernel and K8, the top device ops."""
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder
    from interspeech_ser_tpu_torch.preprocess_cli import set_precision

    n, seconds = WAVLM_B32_SHAPE["n_wavs"], WAVLM_B32_SHAPE["seconds"]
    wav_dir = os.path.join(tmp, "wavs_10s")
    write_wavs(wav_dir, n, (seconds, seconds), SEED + 9)
    out = {}
    for dtype in ("bfloat16", "float32"):
        set_precision(dtype)
        model, cfg, do_norm = build_speech_encoder(model_dir, dtype=dtype)
        pipe = SpeechExtractionPipeline(model, cfg, do_normalize=do_norm, num_workers=4, device=DEVICE)
        pipe.run(wav_dir, os.path.join(tmp, f"b32_{dtype}_warmup"))
        sync()
        res = {}
        if dtype == "bfloat16":
            before = counts()
            stats = pipe.run(wav_dir, os.path.join(tmp, "b32"))
            sync()
            delta = {k: v - before[k] for k, v in counts().items()}
            require(stats.n_utts == n and stats.n_batches == 1, f"WavLM-large B=32: {stats}")
            require(delta["attention_btd"] == cfg.num_layers, f"WavLM-large B=32 launches {delta}")
            res = {"utt_per_sec": stats.utts_per_sec, "wall_s": stats.wall_seconds}
            log(f"[extract] WavLM-large bf16 B=32 x 10 s, one batch: {stats.wall_seconds:.3f} s = "
                f"{stats.utts_per_sec:.2f} utt/s ({smi})")
        if DEVICE == "cuda":
            res["profile"] = profile_extraction(pipe, wav_dir, os.path.join(tmp, f"b32_{dtype}_profile"),
                                                f"WavLM-large {dtype} B=32", smi)
        out[dtype] = res
        del pipe, model
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    set_tf32(False)
    return out


def profile_extraction(pipe, wav_dir: str, save: str, what: str, smi: str) -> dict:
    """A profile of one ``pipe.run``: wall and device-busy ms, the idle
    share, the shares of K1, K2 (its layer-0 kernel with the bf16 GELU
    table's fill, and its later-layer kernel) and K8, the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.run(wav_dir, save)
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    parts = {name: sum(e.self_device_time_total for e in kernels if any(n in e.key for n in names)) / 1e3
             for name, names in (("K1", K1_EVENTS), ("K2", K2_EVENTS), ("K8", K8_EVENTS))}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "parts_ms": parts, "k1_ms": parts["K1"],
           "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"[extract] profile of one warm {what} run: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%); "
        + ", ".join(f"{k} {v:.3f} ms = {100 * v / busy_ms:.2f}%" for k, v in parts.items()) + f" ({smi})")
    for name, ms, count in res["top"]:
        log(f"[extract]   {ms:9.3f} ms  x{count:<4d} {name}")
    return res


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
    dev_csv = cli.eval_main(["--config_path", config_path, "--device", DEVICE])
    test_out = cli.test_main(["--config_path", config_path, "--test_df", test_csv, "--device", DEVICE])
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


# -- phase 6 ---------------------------------------------------------------------

# the train phase's synthetic corpus and model: full fusion width (the
# config's H=512 and 1024/1024 feature dims, batch 64), few utterances
TRAIN_SHAPE = dict(n_train=128, n_dev=64, feat_dim=1024, speech_len=(150, 500), text_len=(20, 81),
                   epochs=2, config={})


def write_train_corpus(tmp: str) -> str:
    """Seeded synthetic WavLM-large / RoBERTa-large ``.pt`` features, label and
    transcript CSVs, and the bimodal config pointed at them -> config path."""
    from interspeech_ser_tpu_torch.utils.labels import CLASSES

    shape = TRAIN_SHAPE
    rng = np.random.default_rng(SEED + 2)
    dirs = [os.path.join(tmp, "train_speech"), os.path.join(tmp, "train_text")]
    for d in dirs:
        os.makedirs(d)
    D = shape["feat_dim"]
    means = rng.normal(scale=0.5, size=(8, D)).astype(np.float32)
    rows = []
    for i in range(shape["n_train"] + shape["n_dev"]):
        cls, name = i % 8, f"train_utt{i:03d}.wav"
        speech = rng.standard_normal((int(rng.integers(*shape["speech_len"])), D), dtype=np.float32) + means[cls]
        text = rng.standard_normal((int(rng.integers(*shape["text_len"])), D), dtype=np.float32)
        for d, f in zip(dirs, (speech, text)):
            torch.save(torch.from_numpy(f), os.path.join(d, name.replace(".wav", ".pt")))
        rows.append([name] + [float(c == cls) for c in range(8)]
                    + ["Train" if i < shape["n_train"] else "Development"])
    label_csv, transcripts = os.path.join(tmp, "train_labels.csv"), os.path.join(tmp, "train_transcripts.csv")
    with open(label_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName"] + CLASSES + ["Split_Set"]] + rows)
    with open(transcripts, "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[r[0], "words"] for r in rows])
    with open(os.path.join(ROOT, "configs", "config_cat_bimodal_lazy_lr1e4_head1.json")) as f:
        cfg = json.load(f)
    cfg.update(wav_dir=tmp, txt_dir=transcripts, lazy_dir1=dirs[0], lazy_dir2=dirs[1], label_path=label_csv,
               feat1_dim=D, feat2_dim=D, epochs=shape["epochs"], model_path=os.path.join(tmp, "train_experiment"),
               **shape["config"])
    path = os.path.join(tmp, "train_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_train(config_path: str, trimodal: bool = False) -> dict:
    """``cli train`` for the config's epochs, then ``cli eval`` on the
    checkpoint it wrote (``--trimodal`` on both when asked): finite losses,
    a strict load, K3b launched once per modality and optimizer step, the
    dev CSV's format."""
    from interspeech_ser_tpu_torch import cli
    from interspeech_ser_tpu_torch.models.fusion import MultiModalEmotionClassifier
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config
    from interspeech_ser_tpu_torch.utils.labels import CLASSES

    cfg = load_fusion_config(config_path, trimodal=trimodal or None)
    flags = ["--config_path", config_path, "--device", DEVICE] + ["--trimodal"] * trimodal
    t0 = time.perf_counter()
    best = cli.train_main(flags)
    sync()
    train_s = time.perf_counter() - t0
    dev_csv = cli.eval_main(flags)
    sync()
    logged = []
    for log_file in sorted(f for f in os.listdir(cfg.model_path) if f.startswith("loggingtxt-")):
        with open(os.path.join(cfg.model_path, log_file)) as f:
            logged += [float(v) for v in re.findall(r"(?:eval_loss|: loss) = (\S+)", f.read())]
    require(len(logged) >= cfg.epochs + 1, f"expected per-epoch and eval losses in the logs, got {logged}")
    require(all(np.isfinite(logged)), f"non-finite logged loss: {logged}")
    model = MultiModalEmotionClassifier(cfg.feat_dims, cfg.fusion_hidden_dim)
    model.load_state_dict(torch.load(os.path.join(cfg.model_path, "multimodal_ser.pt"), weights_only=True),
                          strict=True)
    with open(dev_csv, newline="") as f:
        table = list(csv.reader(f))
    four = re.compile(r"^-?\d+\.\d{4}$")
    require(table[0] == ["Filename", "Prediction"] + [f"class_{i}_prob" for i in range(len(CLASSES))],
            f"dev header {table[0]}")
    require(len(table) == 1 + TRAIN_SHAPE["n_dev"], f"dev rows {len(table) - 1}")
    require(all(all(four.match(v) for v in r[2:]) for r in table[1:]), "dev logits not 4-decimal")
    steps = cfg.epochs * -(-TRAIN_SHAPE["n_train"] // cfg.batch_size)
    log(f"[train] cli train{' --trimodal' * trimodal} {cfg.epochs} epochs x {steps // cfg.epochs} steps (batch "
        f"{cfg.batch_size}, H={cfg.fusion_hidden_dim}, feat dims {cfg.feat_dims}) in {train_s:.2f} s incl. dev evals; "
        f"best {best}; logged losses {logged}; {os.path.relpath(dev_csv, os.path.dirname(config_path))}: "
        f"{len(table) - 1} rows")
    return {"steps": steps, "n_modalities": len(cfg.feat_dims), "best": best, "train_s": train_s}


def train_step_fn(engine, batch, class_w):
    """One optimizer step of ``engine`` on ``batch`` (a fresh AdamW)."""
    engine.optimizer = engine.make_optimizer()

    def step():
        loss, _ = engine.accumulate_gradients(batch, class_w)
        engine.apply_gradients(engine.cfg.lr)
        return loss

    return step


def host_times_ms(fn, reps: int = 5) -> list:
    """Host-clock ms of ``reps`` runs of ``fn``, each synchronised, after a warm-up."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def first_train_batch(config_path: str) -> tuple:
    """-> (config, the first batch of the train split, class weights on the device)."""
    from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
    from interspeech_ser_tpu_torch.utils import labels as L
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    cfg = load_fusion_config(config_path)
    train_rows = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Train")
    ds = LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    batch = ds.collate(list(range(cfg.batch_size)), cfg.batch_size)
    return cfg, batch, torch.from_numpy(L.class_weights(train_rows)).to(DEVICE)


def check_train_step(config_path: str) -> dict:
    """One train step's gradients through the kernels (K3 + K3b) against the
    same step through the plain path (autograd through ``gru_scan``) on the
    same device, TF32 off, same init and dropout draws. Bar: per parameter
    max|g_kernel - g_plain| <= 1e-4 x max(max|g_plain|, 1e-3 x the largest
    gradient of the model); the floor covers parameters whose gradient is 0
    in exact arithmetic (the pooling scorers' biases). Then the median of 5
    timed train steps and a profile of 2."""
    from interspeech_ser_tpu_torch.ops.gru import BiGRU
    from interspeech_ser_tpu_torch.train.engine import FusionEngine

    cfg, batch, class_w = first_train_batch(config_path)
    grads = {}
    for route in ("kernel", "plain"):
        engine = FusionEngine(cfg, seed=SEED, device=DEVICE)
        kernel_forward = BiGRU.forward
        if route == "plain":
            BiGRU.forward = BiGRU.forward_scan
        try:
            loss, _ = engine.accumulate_gradients(batch, class_w)
        finally:
            BiGRU.forward = kernel_forward
        require(bool(torch.isfinite(loss)), f"{route} train-step loss {loss}")
        grads[route] = {n: p.grad.detach().clone() for n, p in engine.model.named_parameters()}
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    errs = {n: max_abs(grads["kernel"][n], gp) / max(float(gp.abs().max()), 1e-3 * top)
            for n, gp in grads["plain"].items()}
    worst = max(errs, key=errs.get)
    log(f"[train] one step's gradients, kernel path vs plain path on {DEVICE} (batch shapes "
        f"{[tuple(f.shape) for f in batch.feats]}): worst {worst} {errs[worst]:.3e} (bar 1e-4); "
        f"GRU weight_hh {errs['speech_gru.weight_hh_l0']:.3e}, speech projection "
        f"{errs['speech_projection.weight']:.3e}")
    require(errs[worst] <= 1e-4, f"train-step gradient {worst}: {errs[worst]} > 1e-4")
    del grads

    engine = FusionEngine(cfg, seed=SEED, device=DEVICE)
    step = train_step_fn(engine, batch, class_w)
    times = host_times_ms(step)
    step_ms = statistics.median(times)
    out = {"train_step_ms": step_ms, "train_step_ms_runs": times, "grad_rel_err": errs[worst]}
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            step()
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top8 = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        k3b_ms = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K3B_EVENTS)) / 1e3
        k3_ms = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K3_EVENTS)) / 1e3
        out["profile"] = {"wall_ms_2_steps": wall_ms, "device_busy_ms": busy_ms, "k3b_ms": k3b_ms, "k3_ms": k3_ms,
                          "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top8]}
        log(f"[train] profile of 2 steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, K3b (all its "
            f"kernels) {k3b_ms:.1f} ms = {100 * k3b_ms / busy_ms:.1f}%, K3 {k3_ms:.1f} ms")
        for name, ms, n in out["profile"]["top"]:
            log(f"[train]   {ms:9.3f} ms  x{n:<4d} {name}")
    log(f"[train] train step (batch {cfg.batch_size}, kernels, TF32 off): median {step_ms:.3f} ms "
        f"of runs {[round(t, 3) for t in times]}")
    out["score"] = time_scoring_forward(engine, batch)
    return out


def time_scoring_forward(engine, batch) -> dict:
    """Scoring's unit of work: the eval forward of one batch of 64 (what
    ``cli eval`` / ``test`` run per batch), its median of 5 host-clock runs
    and, on the card, K3's share of its device time."""
    feats = [torch.from_numpy(f).to(DEVICE) for f in batch.feats]
    masks = [torch.from_numpy(m).to(DEVICE) for m in batch.masks]
    engine.model.eval()

    def score():
        with torch.no_grad():
            engine.model(feats, masks)

    score()
    sync()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        score()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"score_batch_ms": statistics.median(times), "score_batch_ms_runs": times}
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            score()
            sync()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out["device_busy_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
        out["k3_ms"] = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K3_EVENTS)) / 1e3
        log(f"[score] eval forward of one batch of {len(batch.labels)} (shapes "
            f"{[tuple(f.shape) for f in batch.feats]}): median {out['score_batch_ms']:.3f} ms of runs "
            f"{[round(t, 3) for t in times]}; device busy {out['device_busy_ms']:.3f} ms, K3 {out['k3_ms']:.3f} ms "
            f"= {100 * out['k3_ms'] / out['device_busy_ms']:.1f}%")
    return out


# -- phase 7: LoRA fine-tuning ---------------------------------------------------

# the fine-tune corpus: seeded wavs, the Train / Development split of a label
# CSV; ft_lora's defaults (rank 8, alpha 16, q/v, batch 8) for one epoch
LORA_SHAPE = dict(n_train=16, n_dev=8, seconds=(3.0, 12.0), steps=5)


def write_whisper(model_dir: str, layers=None) -> None:
    """Seeded random-init Whisper-large-v3 encoder (32 layers, D=1280, H=20,
    FFN 5120, 128 mels; ``layers`` cuts the depth) as an HF directory."""
    import dataclasses

    from interspeech_ser_tpu_torch.models import whisper as mw

    cfg = mw.whisper_large_v3()
    if layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = mw.WhisperEncoderModel(cfg)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.to_hf(), "architectures": ["WhisperEncoder"]}, f, indent=1)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(model_dir, "pytorch_model.bin"))
    del model


def write_wavlm_layers(src_dir: str, model_dir: str, layers: int) -> None:
    """The first ``layers`` layers of an HF WavLM directory, at its width."""
    with open(os.path.join(src_dir, "config.json")) as f:
        cfg = json.load(f)
    sd = torch.load(os.path.join(src_dir, "pytorch_model.bin"), weights_only=True)
    keep = {k: v for k, v in sd.items()
            if not k.startswith("encoder.layers.") or int(k.split(".")[2]) < layers}
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg, "num_hidden_layers": layers}, f, indent=1)
    torch.save(keep, os.path.join(model_dir, "pytorch_model.bin"))


def check_features(save: str, lengths: dict, frames, dim: int, what: str) -> None:
    for stem, n in lengths.items():
        feats = torch.load(os.path.join(save, f"{stem}.pt"), weights_only=True)
        want = (frames(n), dim)
        require(tuple(feats.shape) == want and feats.dtype == torch.float32,
                f"{what} {stem}: {tuple(feats.shape)} {feats.dtype}, want {want} float32")
        require(bool(torch.isfinite(feats).all()), f"{what} {stem}: non-finite values")


def phase_whisper_extraction(tmp: str) -> dict:
    """``preprocess_cli.whisper_main`` over 8 seeded wavs of 3-30 s, bf16 and
    f32: frame counts min(ceil(n / 320), 1500), finiteness, K1 launches =
    layers x batches, and utt0 in f32 against the plain path on the card."""
    from interspeech_ser_tpu_torch.models import whisper as mw
    from interspeech_ser_tpu_torch.models.loader import build_whisper_encoder
    from interspeech_ser_tpu_torch.ops.mel import whisper_log_mel
    from interspeech_ser_tpu_torch.preprocess_cli import whisper_main
    from interspeech_ser_tpu_torch.utils.audio import load_wav

    cfg = mw.whisper_large_v3()
    wav_dir = os.path.join(tmp, "whisper_wavs")
    lengths = write_wavs(wav_dir, 8, (3.0, 30.0), SEED + 3)
    model_dir = os.path.join(tmp, "whisper-large-v3")
    t0 = time.perf_counter()
    write_whisper(model_dir)
    log(f"[whisper] wrote seeded random-init Whisper-large-v3 ({cfg.encoder_layers} layers, D={cfg.d_model}) "
        f"to {model_dir} in {time.perf_counter() - t0:.1f} s")
    frames = lambda n: min(-(-n // 320), cfg.max_source_positions)  # noqa: E731
    rates = {}
    for dtype in ("bfloat16", "float32"):
        save = os.path.join(tmp, f"whisper_feats_{dtype}")
        before = counts()
        stats = whisper_main(["--ssl_type", model_dir, "--wav_dir", wav_dir, "--save_path", save,
                              "--dtype", dtype, "--device", DEVICE])
        sync()
        delta = {k: v - before[k] for k, v in counts().items()}
        require(stats.n_utts == 8 and stats.n_failed == 0 and stats.n_batches == 1, f"whisper {dtype}: {stats}")
        require(delta["attention_btd"] == cfg.encoder_layers * stats.n_batches and delta["attention_btd_bwd"] == 0,
                f"whisper {dtype}: launches {delta}")
        check_features(save, lengths, frames, cfg.d_model, f"whisper {dtype}")
        rates[dtype] = stats.utts_per_sec
        log(f"[whisper] extraction {dtype}: {stats.n_utts} utts, {stats.audio_seconds:.1f} audio-s in "
            f"{stats.wall_seconds:.2f} s = {stats.utts_per_sec:.2f} utt/s; launches {delta}")
    set_tf32(False)
    model, _ = build_whisper_encoder(model_dir)
    model = model.to(DEVICE).eval()
    y, _ = load_wav(os.path.join(wav_dir, "utt0.wav"))
    w30 = torch.zeros(1, 480000)
    w30[0, : min(len(y), 480000)] = torch.from_numpy(y[:480000])
    with torch.inference_mode():
        ref = model(whisper_log_mel(w30.to(DEVICE), cfg.num_mel_bins), plain=True)["last_hidden_state"][0]
    n = frames(lengths["utt0"])
    got = torch.load(os.path.join(tmp, "whisper_feats_float32", "utt0.pt"), weights_only=True)
    cos = cosine(got, ref[:n].cpu())
    log(f"[whisper] utt0 float32 .pt vs plain f32 path on the card: cos {cos:.6f} max_abs "
        f"{max_abs(got, ref[:n].cpu()):.3e}")
    require(cos >= 0.999, f"whisper utt0 cosine {cos} < 0.999")
    del model
    return {"dir": model_dir, "wav_dir": wav_dir, "lengths": lengths, "utt_per_sec": rates}


def write_lora_corpus(tmp: str) -> str:
    """Seeded wavs and a label CSV with Train and Development rows -> its path."""
    from interspeech_ser_tpu_torch.baseline.podcast import CAT_COLUMNS

    shape = LORA_SHAPE
    n = shape["n_train"] + shape["n_dev"]
    write_wavs(os.path.join(tmp, "lora_wavs"), n, shape["seconds"], SEED + 4, prefix="ft")
    path = os.path.join(tmp, "lora_labels.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["FileName"] + CAT_COLUMNS + ["Split_Set"])
        for i in range(n):
            w.writerow([f"ft{i}.wav"] + [float(c == i % 8) for c in range(8)]
                       + ["Train" if i < shape["n_train"] else "Development"])
    return path


def fine_tune(tmp: str, model_dir: str, label_path: str, layers: int, name: str) -> str:
    """The port's ft_lora (``lora_cli``) for one epoch with its defaults: finite
    losses, K4 launches = layers x optimizer steps -> the checkpoint."""
    from interspeech_ser_tpu_torch import lora_cli

    steps = -(-LORA_SHAPE["n_train"] // 8)
    before = counts()
    t0 = time.perf_counter()
    res = lora_cli.main(["--ssl_type", model_dir, "--label_path", label_path, "--wav_dir",
                         os.path.join(tmp, "lora_wavs"), "--model_path", os.path.join(tmp, f"lora_{name}"),
                         "--epochs", "1", "--device", DEVICE])
    sync()
    seconds = time.perf_counter() - t0
    ckpt, logged = res["checkpoint"], res["losses"]
    delta = {k: v - before[k] for k, v in counts().items()}
    require(len(logged) == steps and all(np.isfinite(logged)), f"{name} fine-tune losses {logged}")
    require(delta["attention_btd_bwd"] == layers * steps,
            f"{name}: K4 launches {delta['attention_btd_bwd']} != {layers} layers x {steps} steps")
    sd = torch.load(ckpt, weights_only=True)
    n_factors = sum(k.endswith(".lora_A") for k in sd)
    require(n_factors == 2 * layers and any(float(v.abs().max()) > 0 for k, v in sd.items() if k.endswith("lora_B")),
            f"{name}: checkpoint has {n_factors} A factors (want {2 * layers}) or untrained B")
    log(f"[lora] {name} ft_lora 1 epoch ({steps} steps, batch 8, rank 8, f32) in {seconds:.2f} s incl. load and "
        f"the dev predict; losses {logged}; launches {delta}")
    return ckpt


def phase_lora(tmp: str, whisper: dict, wavlm_dir: str) -> dict:
    """The LoRA path: ft_lora over Whisper-large-v3, whisper_pretrained_main
    with its checkpoint, then the same over WavLM-large and
    speech_pretrained_main."""
    from interspeech_ser_tpu_torch.models import speech, whisper as mw
    from interspeech_ser_tpu_torch.preprocess_cli import speech_pretrained_main, whisper_pretrained_main

    wcfg, scfg = mw.whisper_large_v3(), speech.wavlm_large()
    label_path = write_lora_corpus(tmp)
    out = {}
    for name, model_dir, layers, extract, frames, dim in (
        ("whisper", whisper["dir"], wcfg.encoder_layers, whisper_pretrained_main,
         lambda n: min(-(-n // 320), wcfg.max_source_positions), wcfg.d_model),
        ("wavlm", wavlm_dir, scfg.num_layers, speech_pretrained_main,
         lambda n: speech.feat_extract_output_length(n, scfg), scfg.hidden_size),
    ):
        ckpt = fine_tune(tmp, model_dir, label_path, layers, name)
        save = os.path.join(tmp, f"{name}_pretrained_feats")
        stats = extract(["--ssl_type", model_dir, "--wav_dir", whisper["wav_dir"], "--save_path", save,
                         "--lora_ckpt", ckpt, "--device", DEVICE])
        sync()
        require(stats.n_utts == 8 and stats.n_failed == 0, f"{name} pretrained extraction: {stats}")
        check_features(save, whisper["lengths"], frames, dim, f"{name}_pretrained")
        log(f"[lora] {name}_pretrained_main: {stats.n_utts} utts in {stats.wall_seconds:.2f} s")
        out[name] = ckpt
    got = torch.load(os.path.join(tmp, "whisper_pretrained_feats", "utt0.pt"), weights_only=True)
    base = torch.load(os.path.join(tmp, "whisper_feats_float32", "utt0.pt"), weights_only=True)
    require(max_abs(got, base) > 0, "whisper_pretrained features equal the base encoder's: no LoRA merged")
    return out


def check_lora_grads(tmp: str, whisper: dict, wavlm_dir: str) -> dict:
    """One LoRA step's gradients through K1 + K4 against the plain attention
    path on the card (``lora_grad_check``) for Whisper-large-v3 and
    WavLM-large, each at full width cut to 2 layers."""
    whisper2 = os.path.join(tmp, "whisper-2layers")
    wavlm2 = os.path.join(tmp, "wavlm-2layers")
    write_whisper(whisper2, layers=2)
    write_wavlm_layers(wavlm_dir, wavlm2, 2)
    return {name: lora_grad_check(tmp, name, model_dir, 2)
            for name, model_dir in (("whisper", whisper2), ("wavlm", wavlm2))}


def lora_grad_check(tmp: str, name: str, model_dir: str, layers: int) -> float:
    """One LoRA step's gradients through K1 + K4 against the plain attention
    path on the card: f32, TF32 off, B factors drawn non-zero (so A gets a
    gradient), head dropout off, a batch of 8 fine-tune utterances; K4
    launches once a layer on the kernel route and never on the plain one.
    Bar: per LoRA factor and head parameter max|g_kernel - g_plain| <= 1e-4 x
    max|g_plain| -> the worst such ratio."""
    from interspeech_ser_tpu_torch.train.lora_engine import LoRAFTEngine

    set_tf32(False)
    engine = LoRAFTEngine(model_dir, device=DEVICE)
    engine.head.dropout_p = 0.0
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for pair in engine.lora.values():
            pair["lora_B"].copy_(0.01 * torch.randn(pair["lora_B"].shape, generator=gen))
    batch = lora_batch(engine, os.path.join(tmp, "lora_wavs"))
    grads = {}
    for route in ("kernel", "plain"):
        before = counts()["attention_btd_bwd"]
        for t in engine.trainable():
            t.grad = None
        loss_t = engine.loss(*batch, plain=route == "plain")
        loss_t.backward()
        loss = loss_t.item()
        sync()
        require(np.isfinite(loss), f"{name} {route} loss {loss}")
        launched = counts()["attention_btd_bwd"] - before
        require(launched == (layers if route == "kernel" else 0), f"{name} {route}: {launched} K4 launches")
        grads[route] = [t.grad.detach().clone() for t in engine.trainable()]
    errs = [max_abs(a, b) / float(b.abs().max()) for a, b in zip(grads["kernel"], grads["plain"])]
    log(f"[lora] {name} {layers} layers full width, one step's gradients through K1+K4 vs the plain path: "
        f"worst {max(errs):.3e} over {len(errs)} tensors (bar 1e-4); loss {loss:.6f}")
    require(max(errs) <= 1e-4, f"{name} LoRA gradient relative error {max(errs)} > 1e-4")
    del engine, grads
    return max(errs)


def lora_batch(engine, wav_dir: str, n: int = 8):
    """One training batch of ``n`` seeded wavs for ``engine``: (wav, mask, y, sample mask)."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.train.lora_engine import pad_batch
    from interspeech_ser_tpu_torch.utils.audio import normalize_waveform

    names = sorted(os.listdir(wav_dir))[:n]
    wavs = [normalize_waveform(w, engine.do_normalize) for w in bdata.load_audio(wav_dir, names)]
    wav, mask = pad_batch(wavs, n)
    return wav, mask, np.arange(n) % 8, np.ones(n, np.float32)


def time_lora_steps(whisper: dict, dtype: str) -> dict:
    """``LoRAFTEngine(dtype=dtype)`` on Whisper-large-v3, batch 8: the median of
    timed optimizer steps after a warm-up, and a profile of 2 steps (K1's and
    K4's shares of device time, the device's idle share). ``float32`` is the
    engine's default and what ``lora_cli`` runs. Keys are prefixed ``bf16_`` /
    ``f32_``."""
    from interspeech_ser_tpu_torch.train.lora_engine import LoRAFTEngine

    tag = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    engine = LoRAFTEngine(whisper["dir"], dtype=dtype, device=DEVICE)
    opt = torch.optim.AdamW(engine.trainable(), lr=5e-4, weight_decay=1e-2)
    batch = lora_batch(engine, whisper["wav_dir"])

    def step():
        opt.zero_grad(set_to_none=True)
        loss = engine.loss(*batch)
        loss.backward()
        opt.step()
        return loss

    step()
    sync()
    times, losses = [], []
    for _ in range(LORA_SHAPE["steps"]):
        t0 = time.perf_counter()
        losses.append(step().item())
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    require(all(np.isfinite(losses)), f"{tag} step losses {losses}")
    out = {f"{tag}_step_ms": statistics.median(times), f"{tag}_step_ms_runs": times, f"{tag}_losses": losses}
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            step()
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k4_ms = sum(e.self_device_time_total for e in kernels
                    if any(n in e.key for n in K4_EVENTS)) / 1e3
        k1_ms = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K1_EVENTS)) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out[f"{tag}_profile"] = {"wall_ms_2_steps": wall_ms, "device_busy_ms": busy_ms, "k4_ms": k4_ms, "k1_ms": k1_ms,
                                 "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
        log(f"[lora] {tag} profile of 2 steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%), K4 {k4_ms:.1f} ms = {100 * k4_ms / busy_ms:.1f}% and "
            f"K1 {k1_ms:.1f} ms = {100 * k1_ms / busy_ms:.1f}% of device time")
        for name, ms, n in out[f"{tag}_profile"]["top"]:
            log(f"[lora]   {ms:9.3f} ms  x{n:<4d} {name}")
    log(f"[lora] Whisper-large-v3 LoRA step {tag} batch 8: median {out[f'{tag}_step_ms']:.3f} ms of runs "
        f"{[round(t, 3) for t in times]}; losses {losses}")
    del engine, opt
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


# -- phase 8: text extraction ------------------------------------------------------

# the transcript corpus: seeded texts of 0-120 words drawn from a synthetic
# vocabulary of N_WORDS words (plus a few outside it), extracted at --max_len 80
TEXT_SHAPE = dict(n_texts=256, words=(0, 121), max_len=80, n_words=3000, deberta_layers=2)


def write_text_model(model_dir: str, model_cls, cfg, architecture: str) -> None:
    """A seeded random-init text encoder as an HF directory (the port's own
    HF key names; no transformers on the card's machine)."""
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = model_cls(cfg)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg.to_hf(), "architectures": [architecture]}, f, indent=1)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, os.path.join(model_dir, "pytorch_model.bin"))
    del model


def synthetic_words(seed: int) -> list:
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    return ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(TEXT_SHAPE["n_words"])]


def write_bpe_files(model_dir: str, words: list, vocab_size: int) -> int:
    """Synthetic byte-level BPE files: the specials, GPT-2's 256 byte
    symbols, and for each word the merges that build it after a space
    (``Ġ`` + its letters), while the ids stay below ``vocab_size``; -> the
    vocabulary's size."""
    from interspeech_ser_tpu_torch.utils.bpe import bytes_to_unicode

    sym = bytes_to_unicode()
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"])}
    for b in range(256):
        vocab[sym[b]] = len(vocab)
    merges = []
    for w in words:
        prefix = sym[ord(" ")]
        for ch in w:
            if prefix + ch not in vocab:
                if len(vocab) >= vocab_size:
                    break
                merges.append(f"{prefix} {ch}")
                vocab[prefix + ch] = len(vocab)
            prefix += ch
    with open(os.path.join(model_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return len(vocab)


def write_spm_file(model_dir: str, words: list) -> int:
    """A synthetic SentencePiece unigram model: DeBERTa's control pieces,
    ``▁`` + each word, and single letters; -> the number of pieces."""
    from interspeech_ser_tpu_torch.utils.spm import CONTROL, NORMAL, UNKNOWN, serialize_spm_model

    pieces = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL), ("[SEP]", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN),
              ("▁", -2.0, NORMAL)]
    pieces += [("▁" + w, -3.0 - i / len(words), NORMAL) for i, w in enumerate(dict.fromkeys(words))]
    pieces += [(c, -8.0, NORMAL) for c in "abcdefghijklmnopqrstuvwxyz.,?!'"]
    with open(os.path.join(model_dir, "spm.model"), "wb") as f:
        f.write(serialize_spm_model(pieces))
    return len(pieces)


def write_transcripts(tmp: str, words: list) -> tuple:
    """A transcript CSV of seeded texts (one empty; most words from ``words``,
    some outside it, some punctuation) -> (path, names, texts)."""
    rng = np.random.default_rng(SEED + 5)
    names, texts = [], []
    for i in range(TEXT_SHAPE["n_texts"]):
        n = 0 if i == 1 else int(rng.integers(*TEXT_SHAPE["words"]))
        toks = [words[int(j)] if rng.random() < 0.9 else "Zq" + words[int(j)][::-1]
                for j in rng.integers(0, len(words), n)]
        text = " ".join(toks)
        if n and rng.random() < 0.5:
            text = text.capitalize() + rng.choice([".", "?", "!", ", okay."])
        names.append(f"text{i:04d}.wav")
        texts.append(text)
    path = os.path.join(tmp, "text_transcripts.csv")
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[n, t] for n, t in zip(names, texts)])
    return path, names, texts


def check_text_features(save: str, names: list, shape: tuple, what: str) -> None:
    for n in names:
        feats = torch.load(os.path.join(save, n.replace(".wav", ".pt")), weights_only=True)
        require(tuple(feats.shape) == shape and feats.dtype == torch.float32,
                f"{what} {n}: {tuple(feats.shape)} {feats.dtype}, want {shape} float32")
        require(bool(torch.isfinite(feats).all()), f"{what} {n}: non-finite values")


def _text_run(main, model_dir: str, csv_path: str, save: str, dtype: str, impl=None):
    """One ``preprocess_cli`` text run -> (stats, launch deltas)."""
    before = counts()
    if impl is not None:
        os.environ["SER_TPU_ATTN_IMPL"] = impl
    try:
        stats = main(["--roberta_type", model_dir, "--df_path", csv_path, "--save_path", save,
                      "--max_len", str(TEXT_SHAPE["max_len"]), "--dtype", dtype, "--device", DEVICE])
    finally:
        os.environ.pop("SER_TPU_ATTN_IMPL", None)
    sync()
    return stats, {k: v - before[k] for k, v in counts().items()}


def phase_text(tmp: str, smi: str) -> dict:
    """``preprocess_cli roberta`` on a seeded random-init RoBERTa-large (full
    width and depth) in f32 and bf16, cold then warm, and once more in f32
    with SER_TPU_ATTN_IMPL=flash; then ``preprocess_cli deroberta`` on a
    DeBERTa-v2-xxlarge at full width, cut to 2 layers (layer 0's conv branch
    runs). Shapes, finiteness, K7 = layers x batches per default run and K6
    on the flash run, the flash run's files against the K7 run's, and one
    text of each model against a reference forward."""
    from interspeech_ser_tpu_torch.models import text
    from interspeech_ser_tpu_torch.models.loader import build_deberta_v2, build_roberta
    from interspeech_ser_tpu_torch.preprocess_cli import deroberta_main, roberta_main
    from interspeech_ser_tpu_torch.utils.spm import auto_tokenizer

    max_len = TEXT_SHAPE["max_len"]
    words = synthetic_words(SEED + 6)
    csv_path, names, texts = write_transcripts(tmp, words)
    rcfg = text.roberta_large()
    rdir = os.path.join(tmp, "roberta-large")
    t0 = time.perf_counter()
    write_text_model(rdir, text.RobertaModel, rcfg, "RobertaModel")
    n_vocab = write_bpe_files(rdir, words, rcfg.vocab_size)
    log(f"[text] wrote seeded random-init RoBERTa-large ({rcfg.num_layers} layers, D={rcfg.hidden_size}) and a "
        f"{n_vocab}-entry byte-level BPE in {time.perf_counter() - t0:.1f} s; {len(texts)} transcripts of "
        f"{min(len(t.split()) for t in texts)}-{max(len(t.split()) for t in texts)} words")
    n_batches = -(-len(texts) // 64)
    rates, dirs = {}, {}
    for dtype, rep, impl in (("float32", "cold", None), ("float32", "warm", None), ("bfloat16", "cold", None),
                             ("bfloat16", "warm", None), ("float32", "flash", "flash")):
        save = dirs[(dtype, rep)] = os.path.join(tmp, f"text_{dtype}_{rep}")
        stats, delta = _text_run(roberta_main, rdir, csv_path, save, dtype, impl)
        require(stats.n_utts == len(texts) and stats.n_batches == n_batches, f"roberta {dtype} {rep}: {stats}")
        want = rcfg.num_layers * n_batches
        got = (delta["attention_bhtd"], delta["flash_attention"])
        require(got == ((0, want) if impl == "flash" else (want, 0)),
                f"roberta {dtype} {rep}: K7, K6 launches {got}, want {(0, want) if impl else (want, 0)}")
        check_text_features(save, names, (max_len, rcfg.hidden_size), f"roberta {dtype} {rep}")
        rates[f"roberta_{dtype}_{rep}"] = stats.utts_per_sec
        log(f"[text] roberta {dtype} {rep}: {stats.n_utts} texts, {stats.n_batches} batches of 64 in "
            f"{stats.wall_seconds:.2f} s = {stats.utts_per_sec:.2f} texts/s ({smi}); launches {delta}")
    worst = max(max_abs(torch.load(os.path.join(dirs[("float32", "flash")], n.replace(".wav", ".pt")),
                                   weights_only=True),
                        torch.load(os.path.join(dirs[("float32", "warm")], n.replace(".wav", ".pt")),
                                   weights_only=True)) for n in names)
    log(f"[text] roberta f32: the K6 run's .pt files vs the K7 run's: max_abs {worst:.3e} (bar 1e-5)")
    require(worst <= 1e-5, f"K6 run differs from the K7 run by {worst}")

    # one text against the plain path on the card, f32, TF32 off
    set_tf32(False)
    i_long = max(range(len(texts)), key=lambda i: len(texts[i]))
    model, _ = build_roberta(rdir)
    model = model.to(DEVICE)
    toks = auto_tokenizer(rdir)([texts[i_long]], max_length=max_len)
    with torch.inference_mode():
        ids, mask = (torch.from_numpy(toks[k]).to(DEVICE) for k in ("input_ids", "attention_mask"))
        ref = model(ids, mask, plain=True)["last_hidden_state"][0].cpu()
    del model
    stem = names[i_long].replace(".wav", ".pt")
    for dtype, bar in (("float32", 1e-3), ("bfloat16", None)):
        got = torch.load(os.path.join(dirs[(dtype, "warm")], stem), weights_only=True)
        err, cos = max_abs(got, ref), cosine(got, ref)
        log(f"[text] roberta {stem} ({int(toks['attention_mask'].sum())} tokens) {dtype} .pt vs the plain f32 "
            f"path on the card: max_abs {err:.3e} cos {cos:.7f}")
        if bar is not None:
            require(err <= bar, f"roberta {dtype} {stem}: max_abs {err} > {bar}")

    profile = profile_text(rdir, names, texts, tmp, smi)

    # DeBERTa-v2-xxlarge at full width, cut to 2 layers
    dcfg = dataclasses.replace(text.deberta_v2_xxlarge(), num_layers=TEXT_SHAPE["deberta_layers"])
    ddir = os.path.join(tmp, "deberta-v2-xxlarge")
    t0 = time.perf_counter()
    write_text_model(ddir, text.DebertaV2Model, dcfg, "DebertaV2Model")
    n_pieces = write_spm_file(ddir, words)
    log(f"[text] wrote seeded random-init DeBERTa-v2-xxlarge at full width ({dcfg.num_layers} layers, "
        f"D={dcfg.hidden_size}, H={dcfg.num_heads}, vocab {dcfg.vocab_size}) and a {n_pieces}-piece "
        f"SentencePiece model in {time.perf_counter() - t0:.1f} s")
    for dtype in ("float32", "bfloat16"):
        save = dirs[(dtype, "deberta")] = os.path.join(tmp, f"deberta_{dtype}")
        stats, delta = _text_run(deroberta_main, ddir, csv_path, save, dtype)
        require(stats.n_utts == len(texts) and stats.n_batches == -(-len(texts) // 32), f"deberta {dtype}: {stats}")
        check_text_features(save, names, (max_len, dcfg.hidden_size), f"deberta {dtype}")
        rates[f"deberta_{dtype}"] = stats.utts_per_sec
        log(f"[text] deberta {dtype}: {stats.n_utts} texts, {stats.n_batches} batches of 32 in "
            f"{stats.wall_seconds:.2f} s = {stats.utts_per_sec:.2f} texts/s ({smi}); launches {delta}")
    model, _ = build_deberta_v2(ddir)  # on the CPU
    toks = auto_tokenizer(ddir)([texts[i_long]], max_length=max_len)
    with torch.inference_mode():
        ref = model(torch.from_numpy(toks["input_ids"]), torch.from_numpy(toks["attention_mask"]))
        ref = ref["last_hidden_state"][0]
    del model
    got = torch.load(os.path.join(dirs[("float32", "deberta")], stem), weights_only=True)
    err, cos = max_abs(got, ref), cosine(got, ref)
    log(f"[text] deberta {stem} ({int(toks['attention_mask'].sum())} tokens) f32 .pt vs a CPU forward of the same "
        f"weights: max_abs {err:.3e} cos {cos:.7f}")
    require(err <= 1e-3, f"deberta {stem}: max_abs {err} > 1e-3 against the CPU forward")
    return {"texts_per_sec": rates, "k6_vs_k7_max_abs": worst, "profile": profile}


def host_profile(fn, n: int = 10) -> list:
    """``fn()`` under cProfile: its wall and the ``n`` functions with the
    most self time, logged and returned. From Python 3.12 cProfile counts
    every thread (the ``.pt`` writers too); cProfile's per-call cost
    inflates Python-heavy code, so it finds candidates and measures none."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    sync()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, ncalls, self s, cumulative s, callers)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    rows = [(f"{name} ({os.path.basename(file)}:{line})", st[2] * 1e3, st[3] * 1e3, st[1])
            for (file, line, name), st in top]
    log(f"[text] host profile (cProfile) of the same run: wall {wall_ms:.1f} ms; by self time:")
    for name, self_ms, cum_ms, calls in rows:
        log(f"[text]   {self_ms:9.1f} ms self {cum_ms:9.1f} ms cum  x{calls:<6d} {name[:90]}")
    return rows


def profile_text(model_dir: str, names: list, texts: list, tmp: str, smi: str) -> dict:
    """Where a RoBERTa-large extraction run's time goes: the host's BPE over
    the corpus with a cold cache and the ``.pt`` writes alone, then (on the
    card) a profile of one warm
    ``TextExtractionPipeline.run`` in bf16 and in f32: wall, device busy,
    K7's and the GEMMs' shares of device time, the top kernels."""
    from interspeech_ser_tpu_torch.extract import streaming
    from interspeech_ser_tpu_torch.extract.pipeline import TextExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_roberta
    from interspeech_ser_tpu_torch.preprocess_cli import set_precision
    from interspeech_ser_tpu_torch.utils import ptio
    from interspeech_ser_tpu_torch.utils.spm import auto_tokenizer

    max_len = TEXT_SHAPE["max_len"]
    tokenizer = auto_tokenizer(model_dir)
    t0 = time.perf_counter()
    tokenizer(texts, max_length=max_len)
    out = {"tokenize_s": time.perf_counter() - t0}
    rows = torch.randn(len(names), max_len, 1024)
    save = os.path.join(tmp, "text_write_only")
    os.makedirs(save)
    t0 = time.perf_counter()
    writer = streaming.BoundedWriter(num_workers=4)
    for i, n in enumerate(names):
        writer.submit(ptio.save_tensor, rows[i], os.path.join(save, n.replace(".wav", ".pt")))
    writer.drain()
    out["write_s"] = time.perf_counter() - t0
    log(f"[text] host side alone: byte-level BPE of the {len(texts)} transcripts, cold cache, "
        f"{out['tokenize_s']:.3f} s; writing {len(names)} [{max_len}, 1024] f32 .pt files through the "
        f"pipeline's writer (4 threads) {out['write_s']:.3f} s")
    if DEVICE != "cuda":
        return out
    from torch.profiler import ProfilerActivity, profile

    def tokenize(batch):
        return tokenizer(batch, max_length=max_len)

    for dtype in ("bfloat16", "float32"):
        set_precision(dtype)
        model, cfg = build_roberta(model_dir, dtype=dtype)
        pipe = TextExtractionPipeline(model, cfg, tokenize, num_workers=4, device=DEVICE)
        pipe.run(names, texts, os.path.join(tmp, f"text_profile_warmup_{dtype}"))
        sync()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.run(names, texts, os.path.join(tmp, f"text_profile_{dtype}"))
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k7_ms = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in K7_EVENTS)) / 1e3
        gemm_ms = sum(e.self_device_time_total for e in kernels
                      if any(n in e.key.lower() for n in ("gemm", "nvjet", "cutlass", "sm90_xmma"))) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[dtype] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "k7_ms": k7_ms, "gemm_ms": gemm_ms,
                      "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
        log(f"[text] profile of one warm RoBERTa-large run, {len(texts)} texts, {dtype} ({smi}): wall "
            f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%), K7 "
            f"{k7_ms:.2f} ms = {100 * k7_ms / busy_ms:.1f}% and GEMMs {gemm_ms:.1f} ms = "
            f"{100 * gemm_ms / busy_ms:.1f}% of device time")
        for name, ms, n in out[dtype]["top"]:
            log(f"[text]   {ms:9.3f} ms  x{n:<4d} {name}")
        if dtype == "bfloat16":  # the host side of the same run, main thread, by self time
            out["host_top"] = host_profile(lambda: pipe.run(names, texts, os.path.join(tmp, "text_cprofile")))
        del pipe, model
    set_tf32(False)
    return out


# -- phase 9: the speech-encoder zoo -------------------------------------------

# XLS-R-2B at full width cut to ``xlsr_layers`` layers through the CLI, then at
# full depth from the seed; HuBERT-XL at full width cut to ``hubert_layers``;
# the wavlm-base-plus shape whole. ``n_wavs`` seeded wavs of ``seconds`` for
# the CLI runs, ``full_wavs`` of ``full_seconds`` for the full-depth run.
ZOO_SHAPE = dict(xlsr_layers=8, hubert_layers=2, n_wavs=8, seconds=(3.0, 12.0), full_wavs=16, full_seconds=10.0)


def wavlm_base_plus(dtype: str = "float32"):
    """``microsoft/wavlm-base-plus``'s shape (``lora_cli``'s default
    ``--ssl_type``): D=768, 12 layers, 12 heads, FFN 3072, a group-norm
    frontend without conv biases, a post-LN stack, WavLM's gated bias."""
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig

    return SpeechConfig(attention_type="wavlm", dtype=dtype)


def _speech_cli(model_dir: str, wav_dir: str, save: str, dtype: str, env=None):
    """One ``preprocess_cli speech`` run -> (stats, launch deltas)."""
    from interspeech_ser_tpu_torch.preprocess_cli import speech_main

    before = counts()
    os.environ.update(env or {})
    try:
        stats = speech_main(["--ssl_type", model_dir, "--wav_dir", wav_dir, "--save_path", save,
                             "--dtype", dtype, "--device", DEVICE])
    finally:
        for key in env or {}:
            os.environ.pop(key, None)
    sync()
    return stats, {k: v - before[k] for k, v in counts().items()}


def _plain_pipeline_run(model_dir: str, wav_dir: str, save: str) -> None:
    """The extraction pipeline in f32 with every kernel swapped for its plain
    version (the model's ``plain=True``), on the same batches as the CLI, so
    that a group-norm frontend sees the same padding."""
    import functools

    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder

    set_tf32(False)
    model, cfg, do_norm = build_speech_encoder(model_dir)
    pipe = SpeechExtractionPipeline(model, cfg, do_normalize=do_norm, num_workers=4, device=DEVICE)
    pipe.model.forward = functools.partial(pipe.model.forward, plain=True)
    before = counts()
    pipe.run(wav_dir, save)
    sync()
    require(counts() == before, f"the plain run launched kernels: {before} -> {counts()}")
    del pipe, model


def _compare_dirs(got_dir: str, ref_dir: str, stems) -> tuple:
    """-> (min cosine, max max-abs) of the ``.pt`` files of ``stems``."""
    cos, err = 1.0, 0.0
    for stem in stems:
        a, b = (torch.load(os.path.join(d, f"{stem}.pt"), weights_only=True) for d in (got_dir, ref_dir))
        cos, err = min(cos, cosine(a, b)), max(err, max_abs(a, b))
    return cos, err


def _zoo_cli_runs(tmp: str, name: str, cfg, model_dir: str, wav_dir: str, lengths: dict, dtypes, smi: str,
                  frontend: int) -> dict:
    """``preprocess_cli speech`` over the zoo wavs in each of ``dtypes`` (cold
    then warm for a model cut in depth, once otherwise): shapes, finiteness,
    K1 = layers x batches, K8 = batches, K2 = batches when ``frontend``
    (layer 0 only), K5 = 0; then utt0 of the f32 run against the plain pipeline."""
    from interspeech_ser_tpu_torch.models.speech import feat_extract_output_length

    frames = lambda n: feat_extract_output_length(n, cfg)  # noqa: E731
    rates = {}
    for dtype, rep in dtypes:
        save = os.path.join(tmp, f"zoo_{name}_{dtype}_{rep}")
        stats, delta = _speech_cli(model_dir, wav_dir, save, dtype)
        nb = stats.n_batches
        require(stats.n_utts == len(lengths) and stats.n_failed == 0, f"{name} {dtype} {rep}: {stats}")
        want = {"attention_btd": cfg.num_layers * nb, "pos_conv": nb, "conv_frontend": nb if frontend else 0,
                "conv_frontend_layer": 0, "ffn_fused": 0}
        require({k: delta[k] for k in want} == want, f"{name} {dtype} {rep}: launches {delta}, want {want}")
        check_features(save, lengths, frames, cfg.hidden_size, f"{name} {dtype} {rep}")
        rates[f"{dtype}_{rep}"] = stats.utts_per_sec
        log(f"[zoo] {name} {dtype} {rep}: {stats.n_utts} utts, {nb} batches, {stats.audio_seconds:.1f} audio-s in "
            f"{stats.wall_seconds:.2f} s = {stats.utts_per_sec:.2f} utt/s ({smi}); launches {delta}")
    plain = os.path.join(tmp, f"zoo_{name}_plain")
    _plain_pipeline_run(model_dir, wav_dir, plain)
    last = dtypes[-1][1]  # the warm run where there are two
    for dtype, bar in (("float32", 0.999), ("bfloat16", None)):
        if (dtype, last) in dtypes:
            cos, err = _compare_dirs(os.path.join(tmp, f"zoo_{name}_{dtype}_{last}"), plain, ["zoo0"])
            log(f"[zoo] {name} utt0 {dtype} .pt vs the plain f32 pipeline on the card: cos {cos:.7f} "
                f"max_abs {err:.3e}")
            if bar is not None:
                require(cos >= bar, f"{name} utt0 {dtype} cosine {cos} < {bar}")
    return {"utt_per_sec": rates}


def profile_xlsr_full_depth(tmp: str, smi: str) -> dict:
    """XLS-R-2B at full width and depth (48 layers), built on the card from
    the seed, bf16: one warm ``SpeechExtractionPipeline.run`` over 16 seeded
    10-s wavs (one 160-s batch) timed, peak device memory, and a profile of
    another: device busy, the kernels' shares, the top device ops."""
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.speech import SpeechEncoderModel, wav2vec2_xlsr_2b
    from interspeech_ser_tpu_torch.preprocess_cli import set_precision

    shape = ZOO_SHAPE
    wav_dir = os.path.join(tmp, "zoo_wavs_10s")
    write_wavs(wav_dir, shape["full_wavs"], (shape["full_seconds"],) * 2, SEED + 8)
    cfg = wav2vec2_xlsr_2b("bfloat16")
    set_precision("bfloat16")
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = SpeechEncoderModel(wav2vec2_xlsr_2b())
    pipe = SpeechExtractionPipeline(model, cfg, num_workers=4, device=DEVICE)
    del model
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[zoo] XLS-R-2B full depth ({cfg.num_layers} layers, D={cfg.hidden_size}, {n_params / 1e9:.3f} B "
        f"parameters) built on the card in bf16 in {time.perf_counter() - t0:.1f} s")
    pipe.run(wav_dir, os.path.join(tmp, "zoo_full_warmup"))
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = counts()
    stats = pipe.run(wav_dir, os.path.join(tmp, "zoo_full"))
    sync()
    delta = {k: v - before[k] for k, v in counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else float("nan")
    require(stats.n_utts == shape["full_wavs"] and stats.n_batches == 1, f"XLS-R-2B full depth: {stats}")
    require(delta["attention_btd"] == cfg.num_layers and delta["pos_conv"] == 1, f"full depth launches {delta}")
    out = {"utt_per_sec": stats.utts_per_sec, "wall_s": stats.wall_seconds, "peak_gb": peak_gb}
    log(f"[zoo] XLS-R-2B full depth bf16: {stats.n_utts} x {shape['full_seconds']:.0f}-s utts in one batch, "
        f"{stats.wall_seconds:.3f} s = {stats.utts_per_sec:.2f} utt/s; peak device memory {peak_gb:.2f} GB ({smi}); "
        f"launches {delta}")
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.run(wav_dir, os.path.join(tmp, "zoo_full_profile"))
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

        def share(*names):
            return sum(e.self_device_time_total for e in kernels if any(n in e.key for n in names)) / 1e3

        parts = {"K1": share(*K1_EVENTS), "K8": share(*K8_EVENTS), "K2": share(*K2_EVENTS),
                 "GEMMs": sum(e.self_device_time_total for e in kernels
                              if any(n in e.key.lower() for n in ("gemm", "nvjet", "cutlass", "sm90_xmma"))) / 1e3}
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "parts_ms": parts,
                          "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
        log(f"[zoo] profile of one warm full-depth run: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%); "
            + ", ".join(f"{k} {v:.1f} ms = {100 * v / busy_ms:.1f}%" for k, v in parts.items()))
        for name, ms, n in out["profile"]["top"]:
            log(f"[zoo]   {ms:9.3f} ms  x{n:<4d} {name}")
        for e in kernels:  # every conv kernel, whatever its share, to check the parts' name matching
            if "conv" in e.key.lower():
                log(f"[zoo]   conv kernel {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    set_tf32(False)
    del pipe
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_zoo(tmp: str, smi: str) -> dict:
    """The zoo: XLS-R-2B (hd 120, C = 120 channels a pos-conv group) at full
    width cut to 8 layers through ``preprocess_cli speech`` in bf16 and f32,
    cold then warm, then bf16 under SER_TPU_FFN_KERNEL=1 SER_TPU_FRONTEND=3
    (K5 = layers x batches, K2 at depth 3, files within cosine 0.999 of the
    default run); XLS-R-2B at full depth (``profile_xlsr_full_depth``);
    HuBERT-XL (hd 80) at full width cut to 2 layers in f32; ``lora_cli``
    over that HuBERT-XL and over XLS-R-2B (hd 120) at full width cut to 2
    layers (K4 = layers x steps), each with one step's gradients through
    K1 + K4 against the plain path; the wavlm-base-plus shape (group norm,
    post-LN: no K2) whole, in bf16 and f32, then ``lora_cli`` over it for 1
    epoch with ft_lora's defaults."""
    from interspeech_ser_tpu_torch.models.speech import hubert_xlarge, wav2vec2_xlsr_2b

    shape = ZOO_SHAPE
    wav_dir = os.path.join(tmp, "zoo_wavs")
    lengths = write_wavs(wav_dir, shape["n_wavs"], shape["seconds"], SEED + 7, prefix="zoo")
    out = {}
    both = (("bfloat16", "cold"), ("bfloat16", "warm"), ("float32", "cold"), ("float32", "warm"))

    xcfg = dataclasses.replace(wav2vec2_xlsr_2b(), num_layers=shape["xlsr_layers"])
    xdir = os.path.join(tmp, "wav2vec2-xls-r-2b")
    t0 = time.perf_counter()
    write_speech_model(xdir, xcfg, "Wav2Vec2Model")
    log(f"[zoo] wrote seeded random-init XLS-R-2B at full width ({xcfg.num_layers} layers, D={xcfg.hidden_size}, "
        f"H={xcfg.num_heads}, FFN {xcfg.intermediate_size}) in {time.perf_counter() - t0:.1f} s")
    out["xlsr_2b"] = _zoo_cli_runs(tmp, "xlsr_2b", xcfg, xdir, wav_dir, lengths, both, smi, frontend=1)
    save = os.path.join(tmp, "zoo_xlsr_2b_k5")
    stats, delta = _speech_cli(xdir, wav_dir, save, "bfloat16", {"SER_TPU_FFN_KERNEL": "1", "SER_TPU_FRONTEND": "3"})
    nb = stats.n_batches
    want = {"ffn_fused": xcfg.num_layers * nb, "conv_frontend": nb, "conv_frontend_layer": 2 * nb, "pos_conv": nb}
    require({k: delta[k] for k in want} == want, f"xlsr_2b K5 run: launches {delta}, want {want}")
    cos, err = _compare_dirs(save, os.path.join(tmp, "zoo_xlsr_2b_bfloat16_warm"), lengths)
    log(f"[zoo] xlsr_2b bf16 under SER_TPU_FFN_KERNEL=1 SER_TPU_FRONTEND=3: {stats.utts_per_sec:.2f} utt/s "
        f"(default route, bf16 warm: {out['xlsr_2b']['utt_per_sec']['bfloat16_warm']:.2f} utt/s; {smi}), "
        f"launches {delta}; files vs the default bf16 run: min cos {cos:.7f} max_abs {err:.3e}")
    require(cos >= 0.999, f"K5 + K2 depth 3 run: cosine {cos} < 0.999 against the default run")
    out["xlsr_2b"].update(k5_utt_per_sec=stats.utts_per_sec, k5_min_cos=cos)
    shutil.rmtree(xdir)  # 1.6 GB of weights

    out["xlsr_2b_full"] = profile_xlsr_full_depth(tmp, smi)

    hcfg = dataclasses.replace(hubert_xlarge(), num_layers=shape["hubert_layers"])
    hdir = os.path.join(tmp, "hubert-xlarge")
    write_speech_model(hdir, hcfg, "HubertModel")
    out["hubert_xl"] = _zoo_cli_runs(tmp, "hubert_xl", hcfg, hdir, wav_dir, lengths, (("float32", "once"),), smi,
                                     frontend=1)

    # LoRA of HuBERT-XL (hd 80) and XLS-R-2B (hd 120) at full width, 2 layers:
    # lora_cli through K1 + K4, then one step's gradients against the plain path
    label_path = os.path.join(tmp, "lora_labels.csv")
    if not os.path.exists(label_path):
        label_path = write_lora_corpus(tmp)
    x2cfg = dataclasses.replace(wav2vec2_xlsr_2b(), num_layers=shape["hubert_layers"])
    x2dir = os.path.join(tmp, "wav2vec2-xls-r-2b-2layers")
    write_speech_model(x2dir, x2cfg, "Wav2Vec2Model")
    for name, cfg_l, model_dir in (("hubert_xl", hcfg, hdir), ("xlsr_2b", x2cfg, x2dir)):
        out[name]["lora_ckpt"] = fine_tune(tmp, model_dir, label_path, cfg_l.num_layers, f"{name}_lora")
        out[name]["lora_grad_rel_err"] = lora_grad_check(tmp, name, model_dir, cfg_l.num_layers)
    shutil.rmtree(x2dir)

    bcfg = wavlm_base_plus()
    bdir = os.path.join(tmp, "wavlm-base-plus")
    write_speech_model(bdir, bcfg, "WavLMModel", do_normalize=False)
    out["wavlm_base_plus"] = _zoo_cli_runs(tmp, "wavlm_base_plus", bcfg, bdir, wav_dir, lengths,
                                           (("bfloat16", "once"), ("float32", "once")), smi, frontend=0)
    out["wavlm_base_plus"]["lora_ckpt"] = fine_tune(tmp, bdir, label_path, bcfg.num_layers, "wavlm_base_plus")
    return out


# -- phase 10: NS3 prosody and the trimodal trainer (BASELINE config #4) ------------


def _weight_norm_pair(w: torch.Tensor, g: torch.Generator, style: str) -> dict:
    """``weight_norm(dim=0)`` parameters of ``w``: v = w times a seeded
    positive factor per output channel, g = the norm of w over each output
    channel, in the ``weight_g`` or the ``parametrizations`` key style."""
    shape = (w.shape[0],) + (1,) * (w.dim() - 1)
    v = w * (0.5 + 1.5 * torch.rand(shape, generator=g))
    gain = w.flatten(1).norm(dim=1).view(shape)
    names = (("weight_g", "weight_v") if style == "weight_g"
             else ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    return dict(zip(names, (gain, v)))


def facodec_reference_state_dicts(model, g: torch.Generator) -> tuple:
    """A port ``ProsodyExtractor(with_speaker=True)``'s weights in the
    reference's ``.bin`` naming -> (encoder state dict, decoder state dict):
    every encoder conv weight-normed in the ``weight_g`` / ``weight_v``
    style, the VQ's projections in the ``parametrizations`` style, the
    encoder's resampling filters as the reference's buffers, and two
    decoder tensors the extraction does not read."""
    from interspeech_ser_tpu_torch.models.ns3.facodec import RESAMPLE_FILTER, SnakeAct1d

    enc = {}
    for k, v in model.encoder.state_dict().items():
        if k.endswith(".weight"):
            enc.update({f"{k[:-7]}.{n}": t for n, t in _weight_norm_pair(v, g, "weight_g").items()})
        else:
            enc[k] = v.clone()
    filt = torch.from_numpy(RESAMPLE_FILTER).view(1, 1, -1)
    for name, mod in model.encoder.named_modules():
        if isinstance(mod, SnakeAct1d):
            enc[f"{name}.upsample.filter"] = filt.clone()
            enc[f"{name}.downsample.lowpass.filter"] = filt.clone()
    dec = {k: v.clone() for k, v in model.state_dict().items()
           if k.startswith(("melspec_linear.", "melspec_encoder.", "timbre_encoder."))}
    q = "quantizer.0.layers.0"
    for proj in ("in_proj", "out_proj"):
        lin = getattr(model.fvq, proj)
        dec.update({f"{q}.{proj}.{n}": t for n, t in _weight_norm_pair(lin.weight.detach(), g, "param").items()})
        dec[f"{q}.{proj}.bias"] = lin.bias.detach().clone()
    dec[f"{q}._codebook.weight"] = model.fvq.codebook.weight.detach().clone()
    dec["quantizer.1.layers.0._codebook.weight"] = torch.randn(1024, 8, generator=g)
    dec["timbre_linear.weight"] = torch.randn(512, 256, generator=g)
    return enc, dec


def prosody_wave(n: int, rng, f0: float) -> np.ndarray:
    """``n`` samples of a voiced 16-kHz signal with prosody: five harmonics
    of an F0 contour swinging 25% around ``f0``, under a syllable-rate energy
    envelope, in a little noise."""
    t = np.arange(n) / 16000.0
    contour = f0 * (1 + 0.25 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(contour) / 16000.0
    env = np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 2 * np.pi)) ** 2
    return 0.3 * env * sum(np.sin(k * phase) / k for k in range(1, 6)) + 0.02 * rng.standard_normal(n)


def seeded_facodec(seed: int = SEED, spread_codes: int = 128) -> tuple:
    """A seeded random-init full-width ``ProsodyExtractor(with_speaker=True)``
    on the CPU -> (model, the generator to draw more from). The SnakeBeta
    parameters are drawn (the reference's init is 0). Random codebook rows
    leave nearly every frame on one code, so the first ``spread_codes`` rows
    are the VQ's projected latents of frames of seeded prosody waves, picked
    farthest-first on the unit sphere (the distance compares directions);
    the other rows stay random."""
    from interspeech_ser_tpu_torch.models.ns3.facodec import ProsodyExtractor

    torch.manual_seed(seed)
    model = ProsodyExtractor(with_speaker=True).eval()
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(("act.alpha", "act.beta")):
                prm.copy_(0.2 * torch.randn(prm.shape, generator=g))
        waves = [prosody_wave(4 * 16000, rng, rng.uniform(90, 250)).astype(np.float32) for _ in range(6)]
        z = model.fvq.in_proj(torch.cat([model.prosody_latents(torch.from_numpy(w)[None])[0] for w in waves]))
        spread_codebook(model.fvq.codebook.weight, z, spread_codes)
    return model, g


def spread_codebook(codebook: torch.Tensor, z: torch.Tensor, n: int) -> None:
    """Overwrite the first ``n`` rows of ``codebook`` with rows of ``z`` (projected
    latents [N, d]) picked farthest-first on the unit sphere (the VQ's distance
    compares directions), so that frames like ``z``'s take many codes."""
    e = z / z.norm(dim=-1, keepdim=True)
    picked = [0]
    dist = (e - e[0]).norm(dim=-1)
    for _ in range(n - 1):
        picked.append(int(dist.argmax()))
        dist = torch.minimum(dist, (e - e[picked[-1]]).norm(dim=-1))
    codebook[:n] = z[picked]


def vq_top2_gap(latents: torch.Tensor, fvq) -> np.ndarray:
    """Pre-VQ latents [..., T, 256] -> each frame's gap between its two best
    codes' cosine similarities, in float64. Two computations of the same
    latents may pick different codes only where this gap is small. ``fvq``:
    the extractor's ``FactorizedVQ`` or a decoder bank's (``_codebook``)."""
    codebook = fvq.codebook if hasattr(fvq, "codebook") else fvq._codebook
    w, b, cb = (t.detach().double().cpu() for t in (fvq.in_proj.weight, fvq.in_proj.bias, codebook.weight))
    z = latents.detach().double().cpu() @ w.t() + b
    top2 = torch.topk((z / z.norm(dim=-1, keepdim=True)) @ (cb / cb.norm(dim=-1, keepdim=True)).t(), 2).values
    return (top2[..., 0] - top2[..., 1]).numpy()


VQ_MARGIN = 1e-5  # a top-2 gap above this: the code must agree


def write_facodec_checkpoints(out_dir: str, seed: int = SEED) -> tuple:
    """``seeded_facodec``'s weights as full-width FACodec encoder and
    decoder ``.bin`` files in the reference's naming -> (encoder path,
    decoder path)."""
    model, g = seeded_facodec(seed)
    enc, dec = facodec_reference_state_dicts(model, g)
    os.makedirs(out_dir, exist_ok=True)
    paths = (os.path.join(out_dir, "ns3_facodec_encoder_v2.bin"), os.path.join(out_dir, "ns3_facodec_decoder_v2.bin"))
    for sd, path in zip((enc, dec), paths):
        torch.save(sd, path)
    return paths


# phase 10's corpus: phase 6's names, labels and RoBERTa-large features, seeded prosody waves of 2-12 s (the first
# 1 s, under the 96-frame tail window; F0 by class), synthetic Whisper-large features; the speaker-on-8 and --codes
# runs take the first n_speaker wavs; min_codes floors the distinct codes of --codes and the distinct prosody rows;
# the profile a batch of profile_wavs wavs of profile_seconds
NS3_SHAPE = dict(seconds=(2.0, 12.0), first_seconds=1.0, n_speaker=8, min_codes=32, batch_size=16, profile_wavs=16,
                 profile_seconds=10.0, whisper_dim=1280, epochs=2, config={})


def _ns3_cli(main, wav_dir: str, save: str, ckpts: tuple, *extra) -> object:
    stats = main(["--wav_dir", wav_dir, "--save_path", save, "--encoder_ckpt", ckpts[0], "--decoder_ckpt", ckpts[1],
                  "--batch_size", str(NS3_SHAPE["batch_size"]), "--device", DEVICE, *extra])
    sync()
    return stats


def check_ns3_files(save: str, lengths: dict, dim, dtype, what: str) -> None:
    """One ``.pt`` per wav: [T, dim] (``dim`` None: [T]) of ``dtype``, T =
    the padded length / 200 (200 zeros more when already a multiple), finite."""
    for stem, n in lengths.items():
        got = torch.load(os.path.join(save, f"{stem}.pt"), weights_only=True)
        want = ((n + 200 - n % 200) // 200,) + ((dim,) if dim else ())
        require(tuple(got.shape) == want and got.dtype == dtype,
                f"{what} {stem}: {tuple(got.shape)} {got.dtype}, want {want} {dtype}")
        require(bool(torch.isfinite(got.float()).all()), f"{what} {stem}: non-finite values")


def _padded_wav(path: str) -> np.ndarray:
    from interspeech_ser_tpu_torch.utils.audio import load_wav

    y, _ = load_wav(path)
    return np.pad(y, (0, 200 - len(y) % 200))


def check_ns3_latents(model, waves: dict) -> tuple:
    """The batched prosody path's pre-VQ latents (host reflect pads, frame
    mask, ``pe[0]`` on every row) of ``waves`` in one length-sorted batch
    of NS3_SHAPE's rows, against each utterance's batch-1 latents on the
    same device -> (max abs over every valid frame, {stem: batch-1 latents})."""
    from interspeech_ser_tpu_torch.extract.pipeline import NS3_BUCKET, ns3_batch_inputs

    stems = sorted(waves, key=lambda s: len(waves[s]))
    Lb = -(-max(len(w) for w in waves.values()) // NS3_BUCKET) * NS3_BUCKET
    wav = np.zeros((max(NS3_SHAPE["batch_size"], len(stems)), Lb), np.float32)
    for i, s in enumerate(stems):
        wav[i, : len(waves[s])] = waves[s]
    refl, fmask = ns3_batch_inputs(wav, [len(waves[s]) for s in stems])
    dev = next(model.parameters()).device
    with torch.inference_mode():
        batched = model.prosody_latents(torch.from_numpy(refl).to(dev), pre_padded=True,
                                        key_mask=torch.from_numpy(fmask).to(dev), pe_batch1=True)
        singles = {s: model.prosody_latents(torch.from_numpy(waves[s][None]).to(dev))[0] for s in stems}
    err = max(max_abs(batched[i, : len(waves[s]) // 200], singles[s]) for i, s in enumerate(stems))
    return err, singles


def phase_ns3(tmp: str, train_config: str, smi: str) -> dict:
    """NS3 FACodec prosody at full width from seeded reference-named ``.bin``
    files: ``preprocess_cli ns3_prosody`` and ``ns3_prosody_speaker`` over
    the trimodal corpus (cold, warm), ``ns3_prosody_speaker`` and
    ``ns3_prosody --codes`` on its first wavs; shapes, dtypes, finiteness,
    the distinct codes and prosody rows; the batched pre-VQ latents against
    batch-1 on the card; one utterance's batched file against its batch-1
    forward on the card (3e-4) and that against the CPU (1e-4), the prosody
    half on the frames clear of a VQ near-tie; a profile of one warm
    speaker batch. Then the config #4 trimodal config over phase 6's corpus
    with the extracted files as ``lazy_dir3`` -> its path."""
    from interspeech_ser_tpu_torch.models.loader import build_prosody_extractor
    from interspeech_ser_tpu_torch.preprocess_cli import ns3_prosody_main, ns3_prosody_speaker_main
    from interspeech_ser_tpu_torch.utils import labels as L

    shape = NS3_SHAPE
    t0 = time.perf_counter()
    ckpts = write_facodec_checkpoints(os.path.join(tmp, "ns3_ckpt"))
    with open(train_config) as f:
        base = json.load(f)
    rows = L.load_merged(base["label_path"], base["txt_dir"])
    names, classes = L.column(rows, "FileName"), np.argmax(L.matrix(rows), axis=1)
    rng = np.random.default_rng(SEED + 10)
    wav_dir, spk_dir = os.path.join(tmp, "ns3_wavs"), os.path.join(tmp, "ns3_wavs_speaker")
    os.makedirs(wav_dir)
    os.makedirs(spk_dir)
    lengths = {}
    for i, (name, cls) in enumerate(zip(names, classes)):
        n = int((shape["first_seconds"] if i == 0 else rng.uniform(*shape["seconds"])) * 16000)
        write_wav(os.path.join(wav_dir, name), prosody_wave(n, rng, 90.0 + 20.0 * cls))
        lengths[os.path.splitext(name)[0]] = n
        if i < shape["n_speaker"]:
            shutil.copy(os.path.join(wav_dir, name), spk_dir)
    spk = {s: lengths[s] for s in list(lengths)[: shape["n_speaker"]]}
    frames = {s: (n + 200 - n % 200) // 200 for s, n in spk.items()}
    require(min(frames.values()) < 96 <= max(frames.values()), f"speaker frames {frames}: want both sides of 96")
    log(f"[ns3] wrote FACodec checkpoints ({', '.join(os.path.basename(c) for c in ckpts)}) and {len(lengths)} wavs "
        f"of {sum(lengths.values()) / 16000:.1f} s in {time.perf_counter() - t0:.1f} s")

    out = {"utt_per_sec": {}}
    runs = (("prosody", ns3_prosody_main, wav_dir, lengths, 256, ("cold", "warm")),
            ("speaker", ns3_prosody_speaker_main, wav_dir, lengths, 512, ("cold", "warm")),
            ("speaker", ns3_prosody_speaker_main, spk_dir, spk, 512, (f"first{len(spk)}",)))
    for what, main, src, lens, dim, reps in runs:
        for rep in reps:
            save = os.path.join(tmp, f"ns3_{what}_{rep}")
            stats = _ns3_cli(main, src, save, ckpts)
            require(stats.n_utts == len(lens) and stats.n_failed == 0, f"ns3 {what} {rep}: {stats}")
            check_ns3_files(save, lens, dim, torch.float32, f"ns3 {what} {rep}")
            out["utt_per_sec"][f"{what}_{rep}"] = stats.utts_per_sec
            log(f"[ns3] {what} f32 {rep}: {stats.n_utts} utts, {stats.n_batches} batches of "
                f"{shape['batch_size']} rows, {stats.audio_seconds:.1f} audio-s in {stats.wall_seconds:.2f} s = "
                f"{stats.utts_per_sec:.2f} utt/s ({smi})")
    stats = _ns3_cli(ns3_prosody_main, spk_dir, os.path.join(tmp, "ns3_codes"), ckpts, "--codes")
    check_ns3_files(os.path.join(tmp, "ns3_codes"), spk, None, torch.int32, "ns3 codes")
    codes = torch.cat([torch.load(os.path.join(tmp, "ns3_codes", f"{s}.pt"), weights_only=True) for s in spk])
    require(0 <= int(codes.min()) and int(codes.max()) < 1024, "ns3 codes outside the 1024-entry codebook")
    prosody = torch.cat([torch.load(os.path.join(tmp, "ns3_prosody_warm", f"{s}.pt"), weights_only=True)
                         for s in lengths])
    out["distinct"] = {"codes": len(torch.unique(codes)), "codes_of": len(codes),
                       "prosody_rows": len(torch.unique(prosody, dim=0)), "prosody_rows_of": len(prosody)}
    log(f"[ns3] --codes: {stats.n_utts} utts, int32, {out['distinct']['codes']} distinct codes of {len(codes)} "
        f"frames; prosody files: {out['distinct']['prosody_rows']} distinct rows of {len(prosody)}")
    require(out["distinct"]["codes"] >= shape["min_codes"] and out["distinct"]["prosody_rows"] >= shape["min_codes"],
            f"ns3 codes do not spread: {out['distinct']} (floor {shape['min_codes']})")

    # the batched prosody path's pre-VQ latents vs batch-1 on the card, for the first wavs; then one utterance over
    # the tail window: its batched file vs its batch-1 forward on the card, that vs the CPU; the one under it: its
    # prosody half (exact in a batch) vs batch-1, its speaker half reported. The prosody half is compared on the
    # frames whose VQ top-2 gap exceeds VQ_MARGIN (a nearer tie may flip between two summation orders).
    set_tf32(False)
    model = build_prosody_extractor(ckpts[1], ckpts[0], with_speaker=True)
    cpu_model = build_prosody_extractor(ckpts[1], ckpts[0], with_speaker=True)
    model = model.to(DEVICE)
    waves = {s: _padded_wav(os.path.join(spk_dir, f"{s}.wav")) for s in spk}
    err_latents, latents = check_ns3_latents(model, waves)
    long_stem = min((s for s in spk if frames[s] >= 96), key=lambda s: frames[s])
    short_stem = min(spk, key=lambda s: frames[s])
    errs, near = {}, 0
    for stem in (long_stem, short_stem):
        wav = torch.from_numpy(waves[stem])[None]
        clear = torch.from_numpy(vq_top2_gap(latents[stem], model.fvq) > VQ_MARGIN)
        near += int((~clear).sum())
        got = torch.load(os.path.join(tmp, f"ns3_speaker_first{len(spk)}", f"{stem}.pt"), weights_only=True)
        with torch.inference_mode():
            one = model(wav.to(DEVICE))[0].cpu()
        errs[stem] = (max(max_abs(got[clear, :256], one[clear, :256]), max_abs(got[:, 256:], one[:, 256:])),
                      max_abs(got[clear, :256], one[clear, :256]))
        if stem == long_stem:
            with torch.inference_mode():
                ref = cpu_model(wav)[0]
            errs["cpu"] = max(max_abs(one[clear, :256], ref[clear, :256]), max_abs(one[:, 256:], ref[:, 256:]))
    log(f"[ns3] batched pre-VQ latents of {len(spk)} utts vs their batch-1 latents on {DEVICE}: max_abs "
        f"{err_latents:.3e} (bar 1e-4); {near} frame(s) of {frames[long_stem] + frames[short_stem]} within "
        f"{VQ_MARGIN} of a VQ tie, left out of the prosody-half comparisons")
    log(f"[ns3] {long_stem} ({frames[long_stem]} frames) speaker file vs its batch-1 forward on {DEVICE}: max_abs "
        f"{errs[long_stem][0]:.3e} (bar 3e-4); batch-1 on {DEVICE} vs the CPU: {errs['cpu']:.3e} (bar 1e-4); "
        f"{short_stem} ({frames[short_stem]} frames, under the window): prosody half {errs[short_stem][1]:.3e} "
        f"(bar 3e-4), speaker half {errs[short_stem][0]:.3e} (the kept approximation)")
    require(err_latents <= 1e-4, f"ns3 batched latents vs batch-1: {err_latents}")
    require(near <= 2, f"ns3: {near} frames within {VQ_MARGIN} of a VQ tie")
    require(errs[long_stem][0] <= 3e-4, f"ns3 batched vs batch-1: {errs[long_stem][0]}")
    require(errs["cpu"] <= 1e-4, f"ns3 batch-1 card vs CPU: {errs['cpu']}")
    require(errs[short_stem][1] <= 3e-4, f"ns3 short utterance's prosody vs batch-1: {errs[short_stem][1]}")
    out["max_abs"] = {"latents_batched_vs_batch1": err_latents, "batched_vs_batch1": errs[long_stem][0],
                      "card_vs_cpu": errs["cpu"], "short_prosody": errs[short_stem][1],
                      "short_speaker": errs[short_stem][0], "near_tie_frames": near}
    out["profile"] = profile_ns3(tmp, model, smi)
    del model, cpu_model

    # config #4: Whisper-large (1280) + RoBERTa-large (phase 6's 1024-d files) + the extracted NS3 prosody
    whisper_dir = os.path.join(tmp, "trimodal_whisper")
    os.makedirs(whisper_dir)
    means = rng.normal(scale=0.5, size=(8, shape["whisper_dim"])).astype(np.float32)
    for name, cls in zip(names, classes):
        stem = os.path.splitext(name)[0]
        T = min(-(-lengths[stem] // 320), 1500)
        torch.save(torch.from_numpy(rng.standard_normal((T, shape["whisper_dim"]), dtype=np.float32) + means[cls]),
                   os.path.join(whisper_dir, f"{stem}.pt"))
    config4 = "config_cat_trimodal_lazy_lr1e4_whisperlarge_roberta_ns3_focaloss.json"  # BASELINE config #4
    with open(os.path.join(ROOT, "configs", config4)) as f:
        cfg = json.load(f)
    cfg.update(wav_dir=wav_dir, txt_dir=base["txt_dir"], label_path=base["label_path"], lazy_dir1=whisper_dir,
               lazy_dir2=base["lazy_dir2"], lazy_dir3=os.path.join(tmp, "ns3_prosody_warm"),
               feat1_dim=shape["whisper_dim"], feat2_dim=base["feat2_dim"], epochs=shape["epochs"],
               model_path=os.path.join(tmp, "trimodal_experiment"), **shape["config"])
    out["config_path"] = os.path.join(tmp, "trimodal_config.json")
    with open(out["config_path"], "w") as f:
        json.dump(cfg, f)
    out["seconds"] = time.perf_counter() - t0
    log(f"[ns3] extraction and checks: {out['seconds']:.1f} s")
    return out


def profile_ns3(tmp: str, model, smi: str) -> dict:
    """One warm prosody-speaker batch (``ProsodyExtractionPipeline``, wav
    reads and ``.pt`` writes included) of NS3_SHAPE's profile wavs: wall and
    device-busy ms, the idle share, peak device memory, the top device ops."""
    from interspeech_ser_tpu_torch.extract.pipeline import ProsodyExtractionPipeline

    shape = NS3_SHAPE
    wav_dir = os.path.join(tmp, "ns3_profile_wavs")
    write_wavs(wav_dir, shape["profile_wavs"], (shape["profile_seconds"],) * 2, SEED + 11, prefix="p")
    save = os.path.join(tmp, "ns3_profile")
    pipe = ProsodyExtractionPipeline(model, shape["batch_size"], device=DEVICE)
    run = lambda: pipe.run(wav_dir, save)  # noqa: E731
    run()  # cold: cuDNN's algorithm choice for this bucket
    if DEVICE != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = run()
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms, "peak_gb": peak_gb,
           "utt_per_sec": stats.utts_per_sec,
           "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"[ns3] profile of one warm speaker batch of {shape['profile_wavs']} x {shape['profile_seconds']:.0f} s: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle {100 * res['idle_share']:.1f}%), peak device memory "
        f"{peak_gb:.2f} GB ({smi})")
    for name, ms, count in res["top"]:
        log(f"[ns3]   {ms:9.3f} ms  x{count:<4d} {name}")
    return res


def time_trimodal_step(config_path: str, smi: str) -> dict:
    """The trimodal focal-loss trainer's step (batch 64, the first train
    rows), median of 5 host-clock runs."""
    from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
    from interspeech_ser_tpu_torch.train.engine import FusionEngine
    from interspeech_ser_tpu_torch.utils import labels as L
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    cfg = load_fusion_config(config_path, trimodal=True)
    train_rows = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Train")
    ds = LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), cfg.lazy_dirs, cfg.feat_dims)
    batch = ds.collate(list(range(min(cfg.batch_size, len(train_rows)))), cfg.batch_size)
    class_w = torch.from_numpy(L.class_weights(train_rows)).to(DEVICE)
    engine = FusionEngine(cfg, seed=SEED, device=DEVICE, focal_dynamic_alpha=True)
    times = host_times_ms(train_step_fn(engine, batch, class_w))
    out = {"train_step_ms": statistics.median(times), "train_step_ms_runs": times}
    log(f"[trimodal] train step (batch {cfg.batch_size}, feat dims {cfg.feat_dims}, shapes "
        f"{[tuple(f.shape) for f in batch.feats]}, focal loss, TF32 off): median {out['train_step_ms']:.3f} ms of "
        f"runs {[round(t, 3) for t in times]} ({smi})")
    return out


# -- phase 11: the challenge baseline (end-to-end WavLM-large fine-tune) ----------

# the baseline corpus: seeded voiced wavs of 2-12 s (F0 by class) in Train / Development / test3, named as the
# challenge's; benchmark/run_cat.sh's hyperparameters for one epoch (micro-batches of 8 rows); the gradient check
# on a batch of grad_rows rows whose last ones are padding; timings: median of steps runs
BASELINE_SHAPE = dict(n_train=64, n_dev=16, n_test3=8, seconds=(2.0, 12.0), batch_size=32, accumulation_steps=4,
                      lr=1e-5, head_dim=1024, epochs=1, grad_rows=8, grad_live=6, steps=5)
# the trained tensors that only K4's dbias / dgate reach
GATED_BIAS_KEYS = ("rel_attn_embed", "gru_rel_pos_linear", "gru_rel_pos_const")


def write_baseline_corpus(tmp: str) -> str:
    """Seeded voiced wavs (``prosody_wave``, F0 by class), a label CSV with the
    eight emotion columns, ``EmoAct`` / ``EmoDom`` / ``EmoVal`` (by class, in
    [0, 1]) and ``Split_Set``, the test3 wavs beside them, and
    ``config_cat.json`` -> its path."""
    from interspeech_ser_tpu_torch.baseline.podcast import ADV_COLUMNS, CAT_COLUMNS

    shape = BASELINE_SHAPE
    rng = np.random.default_rng(SEED + 12)
    wav_dir = os.path.join(tmp, "baseline_wavs")
    os.makedirs(wav_dir, exist_ok=True)
    label_path = os.path.join(tmp, "baseline_labels.csv")
    n_labelled = shape["n_train"] + shape["n_dev"]
    with open(label_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["FileName"] + CAT_COLUMNS + ADV_COLUMNS + ["Split_Set"])
        for i in range(n_labelled + shape["n_test3"]):
            cls = i % 8
            n = int(rng.uniform(*shape["seconds"]) * 16000)
            name = f"MSP-PODCAST_{i:04d}.wav" if i < n_labelled else f"MSP-PODCAST_test3_{i:04d}.wav"
            write_wav(os.path.join(wav_dir, name), prosody_wave(n, rng, 90.0 + 20.0 * cls))
            if i < n_labelled:
                attrs = np.clip(cls / 8 + rng.uniform(-0.1, 0.2, 3), 0.0, 1.0)
                w.writerow([name] + [float(c == cls) for c in range(8)] + [f"{a:.4f}" for a in attrs]
                           + ["Train" if i < shape["n_train"] else "Development"])
    config_path = os.path.join(tmp, "baseline_config_cat.json")
    with open(config_path, "w") as f:
        json.dump({"wav_dir": wav_dir, "label_path": label_path}, f)
    return config_path


def _baseline_flags(config_path: str, model_dir: str, model_path: str, *extra) -> list:
    return ["--ssl_type", model_dir, "--config_path", config_path, "--model_path", model_path, "--head_dim",
            str(BASELINE_SHAPE["head_dim"]), "--device", DEVICE, *extra]


def _dev_set(config_path: str, task: str, model_path: str):
    """The Development split as eval_main reads it (the training run's norm stats)."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.engine import labelled_split

    with open(config_path) as f:
        paths = json.load(f)
    return labelled_split(task, paths["label_path"], paths["wav_dir"], "dev",
                          *bdata.load_norm_stat(os.path.join(model_path, "train_norm_stat.pkl")))


def phase_baseline(tmp: str, model_dir: str) -> dict:
    """The challenge baseline through its entry points at full width: for
    ``cat`` (f32) and ``dim`` (bf16), ``baseline.cli.train_main`` with
    run_cat.sh's hyperparameters for one epoch, then ``eval_main`` on dev and
    on test3. Checks: K4 launched once a layer per micro-batch; the
    frontend in ``final_ssl.pt`` bit for bit the model directory's, the
    gated-bias tensors changed; the saved files, reloaded in the training
    dtype, reproduce the run's dev outputs within 1e-5; the CSVs' columns
    and rows; ``eval_main`` (f32 for both tasks) started from torch's
    default TF32 flags (cuDNN's on) turns both off. Then, on the reloaded ``cat``
    engine, dev logits of batches of 8 against each utterance's batch-1
    logits (1e-4)."""
    from interspeech_ser_tpu_torch.baseline import cli as bcli
    from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.utils.labels import INDEX_TO_LETTER

    shape = BASELINE_SHAPE
    cfg = speech.wavlm_large()
    config_path = write_baseline_corpus(tmp)
    micro = -(-shape["n_train"] // (shape["batch_size"] // shape["accumulation_steps"]))
    source = torch.load(os.path.join(model_dir, "pytorch_model.bin"), weights_only=True)
    out = {"config_path": config_path, "n_layers": cfg.num_layers, "micro_batches": micro * shape["epochs"],
           "tasks": {}}
    for task, dtype in (("cat", "float32"), ("dim", "bfloat16")):
        model_path = os.path.join(tmp, f"baseline_{task}")
        before = counts()
        t0 = time.perf_counter()
        best = bcli.train_main(task, _baseline_flags(
            config_path, model_dir, model_path, "--batch_size", str(shape["batch_size"]), "--accumulation_steps",
            str(shape["accumulation_steps"]), "--lr", str(shape["lr"]), "--epochs", str(shape["epochs"])))
        sync()
        train_s = time.perf_counter() - t0
        k4 = counts()["attention_btd_bwd"] - before["attention_btd_bwd"]
        require(k4 == cfg.num_layers * micro * shape["epochs"],
                f"baseline {task}: K4 launches {k4} != {cfg.num_layers} layers x {micro} micro-batches")
        require(best["epoch"] == 0 and all(np.isfinite(best["dev_losses"])), f"baseline {task}: {best}")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True  # torch's defaults
        t0 = time.perf_counter()
        dev_csv = bcli.eval_main(task, True, _baseline_flags(config_path, model_dir, model_path))
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        require(tf32 == (False, DEVICE != "cuda"),
                f"baseline {task}: eval_main left TF32 (matmul, cuDNN) at {tf32}")
        set_tf32(False)
        test3_csv = bcli.eval_main(task, False, _baseline_flags(config_path, model_dir, model_path))
        sync()
        eval_s = time.perf_counter() - t0
        header = ["FileName", "EmoClass"] if task == "cat" else ["FileName", "EmoAct", "EmoVal", "EmoDom"]
        tables = {}
        for path, n, word in ((dev_csv, shape["n_dev"], "MSP-PODCAST_"), (test3_csv, shape["n_test3"], "test3")):
            with open(path, newline="") as f:
                table = list(csv.reader(f))
            require(table[0] == header and len(table) == n + 1 and all(word in r[0] for r in table[1:]),
                    f"baseline {task} {os.path.basename(path)}: header {table[0]}, {len(table) - 1} rows")
            tables[os.path.basename(path)] = table
        # the frontend stays bit for bit; the tensors only K4's dbias / dgate reach have moved
        saved = torch.load(os.path.join(model_path, "final_ssl.pt"), weights_only=True)
        frontend = [k for k in source if k.startswith("feature_extractor.")]
        require(frontend and all(torch.equal(saved[k], source[k]) for k in frontend),
                f"baseline {task}: the frozen frontend changed")
        gated = [k for k in source if any(n in k for n in GATED_BIAS_KEYS)]
        moved = {k: float((saved[k] - source[k]).abs().max()) for k in gated}
        require(len(gated) == 1 + 3 * cfg.num_layers and min(moved.values()) > 0,
                f"baseline {task}: gated-bias tensors unchanged: {[k for k, v in moved.items() if v == 0]}")
        # the saved files reproduce the run's dev outputs in its dtype
        engine = BaselineEngine(model_dir, task=task, head_dim=shape["head_dim"], dtype=dtype, device=DEVICE)
        engine.load_checkpoints(model_path)
        dev_set = _dev_set(config_path, task, model_path)
        reloaded = engine.evaluate(dev_set)["preds"]
        reload_err = float(np.abs(reloaded - best["dev_preds"]).max())
        require(reload_err <= 1e-5, f"baseline {task}: reloaded dev outputs differ by {reload_err}")
        res = {"train_s": train_s, "eval_s": eval_s, "dev_losses": best["dev_losses"], "k4_launches": k4,
               "reload_max_abs": reload_err, "rel_attn_embed_moved": moved["encoder.layers.0.attention.rel_attn_embed.weight"]}
        if task == "cat":
            letters = {r[0]: r[1] for r in tables["dev.csv"][1:]}
            require(all(letters[u] == INDEX_TO_LETTER[int(i)] for u, i in zip(dev_set.utts, reloaded.argmax(1))),
                    "baseline cat: dev.csv letters differ from the reloaded engine's arg-max")
            res["batch1"] = check_baseline_batch1(engine, dev_set, cfg)
        out["tasks"][task] = res
        log(f"[baseline] {task} ({dtype}) train_main 1 epoch ({micro} micro-batches of "
            f"{shape['batch_size'] // shape['accumulation_steps']}, {shape['epochs'] * -(-micro // shape['accumulation_steps'])} "
            f"optimizer steps) in {train_s:.2f} s incl. load and dev eval; dev loss {best['dev_losses']}; K4 {k4}; "
            f"eval_main dev + test3 {eval_s:.2f} s; reloaded dev max_abs {reload_err:.3e}; rel_attn_embed moved "
            f"{res['rel_attn_embed_moved']:.3e}")
        del engine
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def check_baseline_batch1(engine, dev_set, cfg) -> dict:
    """(e) dev logits of batches of 8 against each utterance's batch-1 logits
    (1e-4). An utterance within 320 samples below a whole 16,000-sample bucket
    is left out and counted: the pooling's frame count ``(n - 1) // 320 + 1``
    is then one more than the encoder makes of its batch-1 bucket, so its
    batch-1 pooling drops a frame that its batched pooling keeps (the JAX
    package does the same)."""
    from interspeech_ser_tpu_torch.models.speech import feat_extract_output_length

    batched = engine.predict(dev_set)
    single = engine.predict(dev_set, batch_size=1)
    lengths = [len(w) for w in dev_set.wav_list]
    clipped = [(n - 1) // 320 + 1 > feat_extract_output_length(-(-n // 16000) * 16000, cfg) for n in lengths]
    keep = [i for i, c in enumerate(clipped) if not c]
    err = float(np.abs(batched[keep] - single[keep]).max())
    log(f"[baseline] cat dev logits, batches of 8 vs batch-1: max_abs {err:.3e} over {len(keep)} utterances "
        f"({sum(clipped)} left out at a bucket's last 320 samples)")
    require(err <= 1e-4 and len(keep) >= len(lengths) // 2, f"baseline batched vs batch-1 {err} over {len(keep)}")
    return {"max_abs": err, "utterances": len(keep), "left_out": sum(clipped)}


def check_baseline_grads(tmp: str, model_dir: str, config_path: str) -> dict:
    """(d) One micro-step through the kernels (K2 layer 0, K1, K4 with dbias
    and dgate) against ``plain=True`` on the card, on a 2-layer full-width
    copy, head dropout off, a batch whose last rows are padding (attention
    rows with no live key); the frontend gets no gradient. Each K2, K1 and
    K4 call of the kernel route is held against its plain version on the
    same inputs (the step's own wav, activations, masks, gates and shared
    bias): f32 K1 / K4 within 1e-5 relative and K2 within 1e-4 max-abs, bf16
    at cosine 0.999, as phase 3 holds them. ``cat`` in f32: every trained
    tensor's gradient (encoder, pooling, head) within 1e-4 x its largest
    magnitude of the plain path's. ``dim`` in bf16, where rounding moves the
    model gradients of either route far more than the kernels do (the plain
    bf16 route's own sit at cosine 0.66-0.98 of the f32 plain ones): the
    loss within 1e-2 of the plain bf16 route's; every trained tensor's
    gradient within 0.3 relative (L2) of the plain bf16 route's, which a
    lost or doubled ``dbias`` / ``dgate`` contribution fails (1.0); and the
    kernel route's median cosine to the f32 plain gradients no lower than
    the plain bf16 route's minus 0.01."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine
    from interspeech_ser_tpu_torch.models import speech

    shape = BASELINE_SHAPE
    two = os.path.join(tmp, "wavlm-2layers")
    if not os.path.exists(two):
        write_wavlm_layers(model_dir, two, 2)
    real_fwd, real_bwd, real_k2 = k_attn.attention_btd_fwd, k_attn.attention_btd_bwd, speech.conv_frontend
    calls: list = []  # (kernel, output, agreement) of the kernel route's K2 / K1 / K4 calls

    def agreement(got, ref) -> float:
        """f32 steps: relative max-abs (lower is better); bf16 steps: cosine (higher is better)."""
        if dtype == "float32":
            return max_abs(got, ref) / max(float(ref.abs().max()), 1e-30)
        return cosine(got, ref)

    def fwd(q, k, v, num_heads, key_mask=None, scale=None, gate=None, pos_bias=None):
        out, lse = real_fwd(q, k, v, num_heads, key_mask, scale, gate, pos_bias)
        ref = k_attn.attention_btd_plain(q, k, v, num_heads, key_mask, scale, gate, pos_bias)
        calls.append(("K1", "out", agreement(out, ref)))
        return out, lse

    def bwd(q, k, v, g, num_heads, key_mask=None, scale=None, gate=None, pos_bias=None, **kw):
        got = real_bwd(q, k, v, g, num_heads, key_mask, scale, gate, pos_bias, **kw)
        ref = k_attn.attention_btd_bwd_plain(q, k, v, g, num_heads, key_mask, scale, gate, pos_bias)
        calls.extend(("K4", n, agreement(a, b)) for n, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, ref)
                     if a is not None)
        return got

    def k2(wav, layers, dt, approx, eps):
        out = real_k2(wav, layers, dt, approx, eps)
        ref = k_conv.conv_frontend_plain(wav, layers, dt, approx, eps)
        calls.append(("K2", "out", max_abs(out, ref) if dtype == "float32" else cosine(out, ref)))
        return out

    def step(engine, batch, cw, plain: bool) -> tuple:
        for p in engine.trainable():
            p.grad = None
        before = counts()
        loss = engine.loss(batch, cw, plain=plain)
        loss.backward()
        sync()
        launched = {k: counts()[k] - before[k] for k in ("attention_btd_bwd", "conv_frontend")}
        want = dict.fromkeys(launched, 0) if plain else {"attention_btd_bwd": 2, "conv_frontend": 1}
        require(launched == want and np.isfinite(loss.item()), f"baseline {route}: {launched}, loss {loss}")
        require(not any(p.grad is not None for p in engine.ssl.feature_extractor.parameters()),
                "a frontend parameter got a gradient")
        return loss.item(), {n: p.grad.detach().float().clone() for m in ("ssl", "pool", "head")
                             for n, p in getattr(engine, m).named_parameters(prefix=m) if p.requires_grad}

    out = {}
    for task, dtype in (("cat", "float32"), ("dim", "bfloat16")):
        ds = _dev_set(config_path, task, os.path.join(tmp, f"baseline_{task}"))
        batch = bdata.collate_wav(ds, list(range(shape["grad_live"])), shape["grad_rows"])
        cw = torch.linspace(0.5, 2.0, 8, device=DEVICE) if task == "cat" else None
        grads, losses = {}, {}
        for route, dt in ((("kernel", dtype), ("plain", dtype)) if dtype == "float32" else
                          (("kernel", dtype), ("plain", dtype), ("plain", "float32"))):
            engine = BaselineEngine(two, task=task, head_dim=shape["head_dim"], dtype=dt, dropout=0.0, device=DEVICE)
            calls.clear()
            k_attn.attention_btd_fwd, k_attn.attention_btd_bwd, speech.conv_frontend = fwd, bwd, k2
            try:
                losses[route, dt], grads[route, dt] = step(engine, batch, cw, route == "plain")
            finally:
                k_attn.attention_btd_fwd, k_attn.attention_btd_bwd, speech.conv_frontend = real_fwd, real_bwd, real_k2
            if route == "kernel":
                per_call = [c for c in calls if c[0] != "K2"]
                k2_call = [c[2] for c in calls if c[0] == "K2"]
            del engine
        names = [n for n in grads["plain", dtype] if not n.endswith("k_proj.bias")]
        n_k1 = sum(c[0] == "K1" for c in per_call)
        require(len(per_call) - n_k1 == 2 * 5 and (n_k1 == 2 or DEVICE != "cuda") and len(k2_call) == 1,
                f"baseline {task}: {n_k1} K1, {len(per_call) - n_k1} K4 and {len(k2_call)} K2 outputs compared")
        if dtype == "float32":
            errs = {n: max_abs(grads["kernel", dtype][n], grads["plain", dtype][n])
                    / max(float(grads["plain", dtype][n].abs().max()), 1e-30) for n in names}
            which = max(errs, key=errs.get)
            worst_call = max(c[2] for c in per_call)
            log(f"[baseline] cat f32 2 layers full width, one micro-step's gradients through K2 + K1 + K4 vs the plain "
                f"path: worst relative error {errs[which]:.6g} ({which}) over {len(errs)} tensors; K1 / K4 calls vs "
                f"plain on the step's inputs: worst relative error {worst_call:.3g}; K2 max_abs {k2_call[0]:.3g}; "
                f"loss {losses['kernel', dtype]:.6f}")
            require(errs[which] <= 1e-4 and worst_call <= 1e-5 and k2_call[0] <= 1e-4,
                    f"baseline cat gradients: {which} {errs[which]}, calls {worst_call}, K2 {k2_call[0]}")
            out[task] = {"worst": errs[which], "tensor": which, "tensors": len(errs), "calls_worst": worst_call,
                         "k2_max_abs": k2_call[0]}
        else:
            kern, plain, ref = grads["kernel", dtype], grads["plain", dtype], grads["plain", "float32"]
            kernel_f32 = {n: cosine(kern[n], ref[n]) for n in names}
            plain_f32 = {n: cosine(plain[n], ref[n]) for n in names}
            between = {n: float((kern[n] - plain[n]).norm() / plain[n].norm().clamp_min(1e-30)) for n in names}
            which = max(between, key=between.get)
            worst_call = min(c[2] for c in per_call)
            loss_rel = abs(losses["kernel", dtype] - losses["plain", dtype]) / abs(losses["plain", dtype])
            med_kernel, med_plain = statistics.median(kernel_f32.values()), statistics.median(plain_f32.values())
            gated = {n: between[n] for n in names if any(k in n for k in GATED_BIAS_KEYS)}
            log(f"[baseline] dim bf16 2 layers full width, one micro-step: K1 / K4 calls vs plain on the step's inputs "
                f"worst cosine {worst_call:.7f} over {len(per_call)} outputs, K2 {k2_call[0]:.7f}; loss kernel "
                f"{losses['kernel', dtype]:.6f}, plain {losses['plain', dtype]:.6f}, f32 plain "
                f"{losses['plain', 'float32']:.6f}; model gradients over {len(names)} tensors, kernel vs plain bf16: "
                f"worst relative L2 {between[which]:.4f} ({which}), gated-bias tensors' worst "
                f"{max(gated.values()):.4f}; cosine to f32 plain, worst {min(kernel_f32.values()):.4f} kernel, "
                f"{min(plain_f32.values()):.4f} plain; median {med_kernel:.5f} kernel, {med_plain:.5f} plain")
            require(worst_call >= 0.999 and k2_call[0] >= 0.999 and loss_rel <= 1e-2,
                    f"baseline dim bf16: calls {worst_call}, K2 {k2_call[0]}, loss {loss_rel}")
            require(between[which] <= 0.3, f"baseline dim bf16: {which} {between[which]} relative L2 from plain bf16")
            require(med_kernel >= med_plain - 0.01,
                    f"baseline dim bf16: median cosine to f32 {med_kernel} kernel, {med_plain} plain")
            out[task] = {"calls_worst_cosine": worst_call, "k2_cosine": k2_call[0], "loss_rel": loss_rel,
                         "grad_rel_l2_vs_plain_bf16": between[which], "tensor": which,
                         "gated_bias_rel_l2_vs_plain_bf16": max(gated.values()),
                         "grad_cosine_vs_f32_kernel": min(kernel_f32.values()),
                         "grad_cosine_vs_f32_plain": min(plain_f32.values()),
                         "grad_cosine_vs_f32_median_kernel": med_kernel,
                         "grad_cosine_vs_f32_median_plain": med_plain}
        del grads
    return out


def time_baseline_steps(model_dir: str, config_path: str, smi: str) -> dict:
    """Full-width WavLM-large micro-steps (forward + backward, 8 rows of the
    longest bucket: the 8 longest train wavs) in f32 (``cat``) and bf16
    (``dim``): median host-clock ms of BASELINE_SHAPE's runs, each
    synchronised; the AdamW step over every trained tensor; peak device
    memory; a profile of one micro-step in each dtype; the f32 inference
    time per audio second over the dev split (batches of 8)."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine, labelled_split

    shape = BASELINE_SHAPE
    with open(config_path) as f:
        paths = json.load(f)
    out = {}
    for task, dtype in (("cat", "float32"), ("dim", "bfloat16")):
        tag = {"float32": "f32", "bfloat16": "bf16"}[dtype]
        ds = labelled_split(task, paths["label_path"], paths["wav_dir"], "train")
        longest = list(np.argsort([len(w) for w in ds.wav_list], kind="stable")[-8:])
        batch = bdata.collate_wav(ds, longest, 8)
        engine = BaselineEngine(model_dir, task=task, head_dim=shape["head_dim"], dtype=dtype, device=DEVICE)
        params = engine.trainable()
        opt = engine.optimizer(shape["lr"])
        cw = torch.ones(8, device=DEVICE) if task == "cat" else None

        def micro_step():
            for p in params:
                p.grad = None
            loss = engine.loss(batch, cw)
            loss.backward()
            return loss

        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        step_ms = host_times_ms(micro_step, shape["steps"])
        opt_ms = host_times_ms(opt.step, shape["steps"])
        out.update({f"{tag}_micro_step_ms": statistics.median(step_ms), f"{tag}_micro_step_ms_runs": step_ms,
                    f"{tag}_optimizer_step_ms": statistics.median(opt_ms), f"{tag}_optimizer_step_ms_runs": opt_ms,
                    f"{tag}_peak_gb": torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None,
                    "frames": int(batch.wav.shape[1] // 320), "trained_values": sum(p.numel() for p in params)})
        log(f"[baseline] WavLM-large micro-step {tag} (8 rows x {batch.wav.shape[1] / 16000:.0f} s, forward + "
            f"backward): median {out[f'{tag}_micro_step_ms']:.3f} ms of runs {[round(t, 3) for t in step_ms]}; AdamW "
            f"step over {out['trained_values']} trained values {out[f'{tag}_optimizer_step_ms']:.3f} ms; peak "
            f"device memory {out[f'{tag}_peak_gb']} GB ({smi})")
        if task == "cat":
            dev = labelled_split(task, paths["label_path"], paths["wav_dir"], "dev", ds.wav_mean, ds.wav_std)
            engine.predict(dev)  # warm: cuDNN's choices for these buckets
            timing: dict = {}
            engine.predict(dev, timing=timing)
            out["inference_s_per_audio_s"] = timing["inference"] / timing["audio_sec"]
            log(f"[baseline] f32 inference over {len(dev)} dev wavs ({timing['audio_sec']:.1f} audio-s, batches of "
                f"8): {timing['inference']:.3f} s = {out['inference_s_per_audio_s']:.5f} s per audio-s ({smi})")
        if DEVICE == "cuda":
            out[f"{tag}_profile"] = profile_baseline_step(micro_step, tag, smi)
        del engine, opt, params
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def profile_baseline_step(micro_step, tag: str, smi: str) -> dict:
    """One micro-step under the profiler: wall and device-busy ms, the idle
    share, the top device ops, K1's, K4's and K2's shares, and the cuDNN
    convolutions' (the frozen frontend's layers 1-6 and the positional conv
    with its backward, which training runs without K8)."""
    from torch.profiler import ProfilerActivity, profile

    micro_step()
    sync()
    before = counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        micro_step()
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    share = lambda names: sum(e.self_device_time_total for e in kernels if any(n in e.key for n in names)) / 1e3  # noqa: E731
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms, "launches": launched,
           "k1_ms": share(K1_EVENTS), "k4_ms": share(K4_EVENTS), "k2_ms": share(K2_EVENTS),
           "cudnn_conv_ms": share(("convolve", "conv2d", "dgrad", "wgrad")) - share(K2_EVENTS),
           "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"[baseline] profile of one {tag} micro-step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle "
        f"{100 * res['idle_share']:.1f}%); K4 {res['k4_ms']:.1f} ms = {100 * res['k4_ms'] / busy_ms:.1f}%, K1 "
        f"{res['k1_ms']:.1f} ms = {100 * res['k1_ms'] / busy_ms:.1f}%, K2 {res['k2_ms']:.3f} ms, cuDNN convolutions "
        f"{res['cudnn_conv_ms']:.1f} ms of device time; launches in the window {launched} ({smi})")
    for name, ms, n in res["top"]:
        log(f"[baseline]   {ms:9.3f} ms  x{n:<4d} {name}")
    for e in kernels:  # the frontend's device work by name: K2's kernels and every convolution
        if any(n in e.key for n in K2_EVENTS + ("conv", "Conv")):
            log(f"[baseline]   frontend / conv: {e.self_device_time_total / 1e3:.3f} ms x{e.count} {e.key[:90]}")
    return res


# -- phase 12: Whisper transcription ------------------------------------------------

# 16 seeded wavs of 3-30 s (one of 34 s, cut to Whisper's 30-s window) at 16 kHz and
# at rates the native loader resamples; transcribe_cli's defaults (batch 16, 200 new
# tokens); Whisper-large-v3's 50,257 byte-level BPE tokens before its added tokens;
# 82 seeded regular ids suppressed (openai/whisper-large-v3 suppresses 82 regular and
# 6 special ids); the recompute-vs-cached check over 8 new tokens; 8 profiled steps
TRANSCRIBE_SHAPE = dict(n_wavs=16, seconds=(3.0, 30.0), long_index=7, long_seconds=34.0,
                        rates=(16000, 22050, 44100, 8000), batch_size=16, max_new_tokens=200,
                        regular_tokens=50257, n_suppress=82, recompute_tokens=8, profile_steps=8)
# (d): each emitted token's f32 logit, teacher-forced through WhisperDecoderModel, lies
# within TIE_GAP of its step's (suppressed) maximum; the logits are of order 1-10, and
# the cached and teacher-forced f32 routes differ by summation order only
TIE_GAP = 1e-3
# (f): every bf16 step's logits (the cached decoder fed the f32 run's tokens) within
# this cosine of the f32 teacher-forced ones
BF16_STEP_COSINE = 0.99
# (f), the products: every bf16 attention product of one step through _f32_product (the
# card's bmm with an f32 out_dtype) within this relative L2 of the f32 product of the
# upcast operands (both sum exact bf16 x bf16 products in f32; only the order differs);
# the same products rounded to bf16 sit about 1e-3 away and must miss it. The model-level
# bars above are loose: JAX's own bf16 logits sit 1e-2 from its f32 ones
F32_PRODUCT_REL = 2e-6
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th ur hr bg lt la mi "
    "ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be tg sd gu "
    "am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw su yue"
).split()


def whisper_added_tokens() -> list:
    """Whisper-large-v3's added tokens in id order, as (content, special):
    ``<|endoftext|>``, ``<|startoftranscript|>``, the 100 languages, the task
    and control tokens, then the 1,501 timestamps (not special)."""
    special = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in WHISPER_LANGUAGES]
               + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>",
                  "<|notimestamps|>"])
    return [(t, True) for t in special] + [("<|%.2f|>" % (i * 0.02), False) for i in range(1501)]


def write_whisper_tokenizer(model_dir: str, n_regular: int = 50257, seed: int = SEED) -> dict:
    """Synthetic byte-level BPE files in Whisper-large-v3's layout:
    ``tokenizer.json`` (what transformers' fast tokenizer loads),
    ``vocab.json``, ``merges.txt``, ``added_tokens.json``,
    ``special_tokens_map.json`` and ``tokenizer_config.json``. Ids 0-255 are
    GPT-2's byte symbols, then the merges that build seeded words after a
    space (letters, now and then é ü ß 日 本 €, whose UTF-8 bytes are
    separate symbols) up to ``n_regular`` ids, then the added tokens
    (:func:`whisper_added_tokens`) -> {added token: id}."""
    from interspeech_ser_tpu_torch.utils.bpe import bytes_to_unicode

    sym = bytes_to_unicode()
    vocab = {sym[b]: b for b in range(256)}
    merges = []
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz") + list("éüß日本€")
    p = np.array([1.0] * 26 + [0.1] * 6)
    while len(vocab) < n_regular:
        word = " " + "".join(rng.choice(alphabet, int(rng.integers(2, 9)), p=p / p.sum()))
        chars = "".join(sym[b] for b in word.encode("utf-8"))
        prefix = chars[0]
        for ch in chars[1:]:
            if prefix + ch not in vocab and len(vocab) < n_regular:
                merges.append([prefix, ch])
                vocab[prefix + ch] = len(vocab)
            prefix += ch
    added = whisper_added_tokens()
    ids = {t: n_regular + i for i, (t, _) in enumerate(added)}
    entry = lambda t, special: {"id": ids[t], "content": t, "single_word": False, "lstrip": False,  # noqa: E731
                                "rstrip": False, "normalized": False, "special": special}
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    tokenizer = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [entry(t, s) for t, s in added],
        "normalizer": None, "pre_tokenizer": byte_level, "post_processor": None, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    eot = "<|endoftext|>"
    files = {
        "tokenizer.json": tokenizer,
        "vocab.json": vocab,
        "added_tokens.json": ids,
        "special_tokens_map.json": {"bos_token": eot, "eos_token": eot, "unk_token": eot, "pad_token": eot,
                                    "additional_special_tokens": [t for t, s in added if s and t != eot]},
        "tokenizer_config.json": {
            "tokenizer_class": "WhisperTokenizer", "clean_up_tokenization_spaces": True, "add_prefix_space": False,
            "errors": "replace", "model_max_length": 1024, "bos_token": eot, "eos_token": eot, "unk_token": eot,
            "pad_token": eot,
            "added_tokens_decoder": {str(ids[t]): {k: v for k, v in entry(t, s).items() if k != "id"}
                                     for t, s in added},
        },
    }
    os.makedirs(model_dir, exist_ok=True)
    for name, obj in files.items():
        with open(os.path.join(model_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return ids


def whisper_generation_config(ids: dict, n_regular: int, n_suppress: int, seed: int = SEED) -> dict:
    """``generation_config.json`` in Whisper-large-v3's form, with the
    language fixed (English) where the shipped file leaves it to detection
    (``null``): the forced prompt, seeded regular ids and the start / task /
    control ids suppressed, EOT."""
    rng = np.random.default_rng(seed + 1)
    eot = ids["<|endoftext|>"]
    regular = sorted(int(i) for i in rng.choice(np.arange(1, n_regular), n_suppress, replace=False))
    specials = [ids[t] for t in ("<|startoftranscript|>", "<|translate|>", "<|transcribe|>", "<|startoflm|>",
                                 "<|startofprev|>", "<|nospeech|>")]
    return {"decoder_start_token_id": ids["<|startoftranscript|>"], "eos_token_id": eot, "bos_token_id": eot,
            "pad_token_id": eot, "max_length": 448, "begin_suppress_tokens": [220, eot],
            "forced_decoder_ids": [[1, ids["<|en|>"]], [2, ids["<|transcribe|>"]], [3, ids["<|notimestamps|>"]]],
            "suppress_tokens": regular + specials, "no_timestamps_token_id": ids["<|notimestamps|>"]}


def seeded_decoder_state_dict(cfg, seed: int = SEED) -> dict:
    """Seeded decoder weights on the device (HF names): linear weights
    N(0, 4/fan_in), biases N(0, 0.02^2), LayerNorms 1 + N(0, 0.1^2) and
    N(0, 0.1^2), the embeddings N(0, 0.05^2). (With transformers' init,
    0.02 everywhere, or linear weights N(0, 1/fan_in), a random decoder
    repeats one or a few tokens, whatever the audio: the cross-attention's
    average over 1,500 frames varies little, and the tied head then picks
    the same rows.)"""
    from interspeech_ser_tpu_torch.models.whisper_decoder import WhisperDecoderModel

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in WhisperDecoderModel(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        x = torch.randn(shape, generator=g, device=DEVICE)
        if "layer_norm" in k:
            x = (1.0 if k.endswith("weight") else 0.0) + 0.1 * x
        elif "embed" in k:
            x = 0.05 * x
        else:
            x = x * (0.02 if k.endswith("bias") else 2 * shape[1] ** -0.5)
        sd[k] = x
    return sd


def write_whisper_transcriber(model_dir: str, enc_cfg, dec_cfg, n_regular: int, n_suppress: int) -> dict:
    """A seeded random-init Whisper (encoder and decoder) as an HF
    ``WhisperForConditionalGeneration`` directory: ``config.json`` with both
    halves' fields and the token ids, the weights under ``model.encoder.``
    and ``model.decoder.`` in float16 (as openai/whisper-large-v3 ships
    them) in ``pytorch_model.bin``, the synthetic tokenizer files and
    ``generation_config.json`` -> {added token: id}."""
    from interspeech_ser_tpu_torch.models import whisper as mw

    ids = write_whisper_tokenizer(model_dir, n_regular)
    gen = whisper_generation_config(ids, n_regular, n_suppress)
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        encoder = mw.WhisperEncoderModel(enc_cfg)
    sd = {f"model.encoder.{k}": v.half().cpu() for k, v in encoder.state_dict().items()}
    del encoder
    sd.update({f"model.decoder.{k}": v.half().cpu() for k, v in seeded_decoder_state_dict(dec_cfg).items()})
    torch.save(sd, os.path.join(model_dir, "pytorch_model.bin"))
    eot = ids["<|endoftext|>"]
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**enc_cfg.to_hf(), **dec_cfg.to_hf(), "architectures": ["WhisperForConditionalGeneration"],
                   "decoder_start_token_id": gen["decoder_start_token_id"], "eos_token_id": eot,
                   "bos_token_id": eot, "pad_token_id": eot, "torch_dtype": "float16"}, f, indent=1)
    with open(os.path.join(model_dir, "generation_config.json"), "w") as f:
        json.dump(gen, f, indent=1)
    return ids


def write_transcribe_wavs(wav_dir: str, seed: int) -> dict:
    """TRANSCRIBE_SHAPE's seeded wavs ``tr00.wav``...: tones with a few
    harmonics in noise, the rates taken in turn, one (``long_index``) of
    ``long_seconds`` ->
    {name: (seconds, rate)}."""
    shape = TRANSCRIBE_SHAPE
    rng = np.random.default_rng(seed)
    os.makedirs(wav_dir, exist_ok=True)
    out = {}
    for i in range(shape["n_wavs"]):
        sr = shape["rates"][i % len(shape["rates"])]
        sec = shape["long_seconds"] if i == shape["long_index"] else float(rng.uniform(*shape["seconds"]))
        t = np.arange(int(sec * sr)) / sr
        f0 = rng.uniform(100, 300)
        x = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3)) + 0.05 * rng.standard_normal(len(t))
        name = f"tr{i:02d}.wav"
        write_wav(os.path.join(wav_dir, name), x, sr)
        out[name] = (sec, sr)
    return out


def run_transcription(tmp: str, smi: str) -> dict:
    """Phase 12's main path: the model directory and wavs, then
    ``transcribe_cli.main`` in bf16 and in f32 at TRANSCRIBE_SHAPE's batch and
    token count: (a) one CSV row per wav in sorted order, the CSV's format;
    (c) every wav read by the native loader. The launch counts (b) are read
    by the caller."""
    from interspeech_ser_tpu_torch import transcribe_cli
    from interspeech_ser_tpu_torch.models import whisper as mw
    from interspeech_ser_tpu_torch.models import whisper_decoder as wd
    from interspeech_ser_tpu_torch.utils import audio, native_audio

    shape = TRANSCRIBE_SHAPE
    enc_cfg, dec_cfg = mw.whisper_large_v3(), wd.whisper_large_v3_decoder()
    model_dir = os.path.join(tmp, "whisper-large-v3-full")
    t0 = time.perf_counter()
    ids = write_whisper_transcriber(model_dir, enc_cfg, dec_cfg, shape["regular_tokens"], shape["n_suppress"])
    write_s = time.perf_counter() - t0
    log(f"[transcribe] wrote seeded random-init Whisper-large-v3 ({enc_cfg.encoder_layers} + {dec_cfg.decoder_layers}"
        f" layers, D={dec_cfg.d_model}, vocab {dec_cfg.vocab_size}, float16 weights, synthetic tokenizer) to "
        f"{model_dir} in {write_s:.1f} s")
    wav_dir = os.path.join(tmp, "transcribe_wavs")
    wavs = write_transcribe_wavs(wav_dir, SEED + 12)
    names = sorted(os.listdir(wav_dir))
    runs = {}
    for dtype in ("bfloat16", "float32"):
        out_csv = os.path.join(tmp, f"transcript_{dtype}.csv")
        loads = dict(audio.LOADS)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = transcribe_cli.main(["--model", model_dir, "--wav_dir", wav_dir, "--out_csv", out_csv,
                                     "--batch_size", str(shape["batch_size"]), "--max_new_tokens",
                                     str(shape["max_new_tokens"]), "--dtype", dtype, "--device", DEVICE])
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else float("nan")
        native = audio.LOADS["native"] - loads["native"]
        require(native == len(names) and audio.LOADS["python"] == loads["python"] and native_audio.available(),
                f"(c) transcribe {dtype}: {native} of {len(names)} wavs through the native loader, "
                f"{audio.LOADS['python'] - loads['python']} through python ({native_audio.BUILD_ERROR})")
        with open(out_csv, "rb") as f:
            raw = f.read()
        with open(out_csv, newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        require(rows[0] == ["FileName", "transcription"] and [r[0] for r in rows[1:]] == names
                and rows[1:] == stats.rows and raw.endswith(b"\n") and b"\r" not in raw,
                f"(a) transcribe {dtype}: CSV rows {[r[0] for r in rows[1:]]} vs wavs {names}")
        require(stats.n_batches == -(-len(names) // shape["batch_size"]), f"transcribe {dtype}: {stats.n_batches}")
        runs[dtype] = {"stats": stats, "cli_s": cli_s, "peak_gb": peak, "csv": out_csv}
        log(f"[transcribe] transcribe_cli {dtype}: {stats.n_utts} wavs, {stats.n_batches} batch(es) of "
            f"{shape['batch_size']} x {shape['max_new_tokens']} new tokens: batches {stats.wall_seconds:.2f} s = "
            f"{stats.utts_per_sec:.2f} utt/s, encoder {stats.encoder_seconds:.3f} s, decode "
            f"{stats.decode_seconds:.2f} s = {stats.tokens_per_sec:.1f} emitted tokens/s ({stats.emitted_tokens} tokens; "
            f"{stats.slots_per_sec:.1f} token slots/s); whole CLI {cli_s:.1f} s; peak device memory {peak:.2f} GB; "
            f"row 0 {rows[1][1][:60]!r} ({smi})")
    # the host's cost of one wav read by each loader, the first wav of each rate, one thread
    load_s = {}
    for name, (sec, sr) in wavs.items():
        if sr not in load_s:
            path = os.path.join(wav_dir, name)
            t0 = time.perf_counter()
            native_audio.load_wav_native(path)
            t1 = time.perf_counter()
            audio.load_wav_python(path)
            load_s[sr] = {"audio_s": sec, "native_s": t1 - t0, "python_s": time.perf_counter() - t1}
    log("[transcribe] one wav read on one thread, native vs python (utils/audio.load_wav_python): " + "; ".join(
        f"{sr} Hz {v['audio_s']:.2f} audio-s: {v['native_s']:.4f} s vs {v['python_s']:.4f} s" for sr, v in load_s.items()))
    return {"dir": model_dir, "wav_dir": wav_dir, "wavs": wavs, "names": names, "ids": ids, "runs": runs,
            "write_s": write_s, "enc_cfg": enc_cfg, "dec_cfg": dec_cfg, "load_s": load_s}


def _ms(fn, reps: int = 3) -> float:
    """Median ms of ``fn()``: CUDA events on the card, the host clock here."""
    if DEVICE == "cuda":
        return median_ms(fn, reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def decode_step_bound(enc_cfg, dec_cfg, B: int, idx: int, dtype: torch.dtype) -> tuple:
    """(ms, "bytes" / "operations") of one cached step at position ``idx``:
    the layer weights it reads in the compute dtype (self q/k/v/o, cross q/o,
    fc1 / fc2), the cross K/V, the self caches up to ``idx``, the f32 LM head
    and the token and position rows; the multiply-adds of those products."""
    D, L, F, V = dec_cfg.d_model, dec_cfg.decoder_layers, dec_cfg.decoder_ffn_dim, dec_cfg.vocab_size
    S = enc_cfg.max_source_positions
    e = torch.empty((), dtype=dtype).element_size()
    per_layer = 6 * D * D + 2 * D * F + 9 * D + F  # weights and biases a step reads
    nbytes = (L * per_layer * e + L * 2 * B * S * D * e + L * 2 * B * (idx + 1) * D * e + V * D * 4
              + 2 * B * D * 4)
    flops = 2 * B * (L * (6 * D * D + 2 * D * F) + L * 2 * (S + idx + 1) * D) + 2 * B * V * D
    return roofline_ms(nbytes, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)


def check_transcription(tr: dict, smi: str) -> dict:
    """Phase 12's checks and times on the card, over the first batch: (d)
    the f32 run's tokens teacher-forced through ``WhisperDecoderModel``
    (each emitted token within TIE_GAP of its step's maximum, near-ties
    counted); (e) ``greedy_decode`` = ``greedy_decode_cached`` in f32 over
    TRANSCRIBE_SHAPE's recompute tokens; (f) the bf16 cached decoder fed the
    f32 tokens, each step's logits against the f32 teacher-forced ones at
    BF16_STEP_COSINE; then per dtype the encoder ms per batch, the cross-K/V
    projection ms, the decode step's median ms beside its bound, and the
    device's idle share over profiled decode steps."""
    from interspeech_ser_tpu_torch import transcribe_cli
    from interspeech_ser_tpu_torch.models import whisper as mw
    from interspeech_ser_tpu_torch.models import whisper_decoder as wd
    from interspeech_ser_tpu_torch.models.loader import (build_whisper_decoder, build_whisper_encoder,
                                                         load_hf_state_dict, read_whisper_config)
    from interspeech_ser_tpu_torch.ops.mel import whisper_log_mel
    from interspeech_ser_tpu_torch.preprocess_cli import set_precision

    shape = TRANSCRIBE_SHAPE
    set_precision("float32")
    sd = load_hf_state_dict(tr["dir"])
    enc32, enc_cfg = build_whisper_encoder(tr["dir"], state_dict=sd)
    dec32, dec_cfg = build_whisper_decoder(tr["dir"], state_dict=sd)
    del sd
    enc32, dec32 = enc32.to(DEVICE), dec32.to(DEVICE)
    with torch.device("meta"):  # bf16 twins sharing the f32 weights
        enc16 = mw.WhisperEncoderModel(dataclasses.replace(enc_cfg, dtype="bfloat16"))
        dec16 = wd.WhisperDecoderModel(dataclasses.replace(dec_cfg, dtype="bfloat16"))
    enc16.load_state_dict(enc32.state_dict(), assign=True)
    dec16.load_state_dict(dec32.state_dict(), assign=True)
    stats32 = tr["runs"]["float32"]["stats"]
    prompt, eot, P, N = stats32.prompt_ids, stats32.eot_id, len(stats32.prompt_ids), shape["max_new_tokens"]
    _, suppress, _ = transcribe_cli.generation_setup(tr["dir"], read_whisper_config(tr["dir"]))
    B = shape["batch_size"]
    wavs = transcribe_cli.load_batch(tr["wav_dir"], tr["names"][:B], B)
    res = {"prompt": prompt, "eot": eot}
    with torch.inference_mode():
        mel = whisper_log_mel(torch.from_numpy(wavs).to(DEVICE), num_mels=enc_cfg.num_mel_bins)
        out32 = enc32(mel, keep=(-1,))["last_hidden_state"]
        out16 = enc16(mel, keep=(-1,))["last_hidden_state"]
        tokens = torch.from_numpy(stats32.tokens[0]).to(DEVICE)  # [B, P + N]
        sup = torch.tensor(suppress, device=DEVICE)

        # (d) the f32 run's tokens teacher-forced on the card
        logits = dec32(tokens[:, :-1], out32)[:, P - 1:]  # [B, N, V]: the logits that picked tokens P..
        chosen = logits.index_fill(-1, sup, wd.NEG_INF)
        emitted = tokens[:, P:]
        live = torch.ones_like(emitted, dtype=torch.bool)  # up to and including a row's first EOT
        live[:, 1:] = (emitted[:, :-1] != eot).cumprod(dim=1).bool()
        top2 = chosen.topk(2, dim=-1).values
        gap = (top2[..., 0] - chosen.gather(-1, emitted[..., None])[..., 0])[live]
        margin = (top2[..., 0] - top2[..., 1])[live]
        res["d"] = {"max_gap": float(gap.max()), "not_argmax": int((gap > 0).sum()),
                    "near_ties": int((margin < TIE_GAP).sum()), "steps": int(live.sum()),
                    "logit_absmax": float(logits.abs().max()), "distinct_tokens": int(emitted.unique().numel()),
                    "finished_rows": int((emitted == eot).any(dim=1).sum())}
        log(f"[transcribe] (d) f32 tokens teacher-forced through WhisperDecoderModel: {res['d']['steps']} emitted "
            f"tokens, largest gap to the step's maximum {res['d']['max_gap']:.3e} (bar {TIE_GAP}), "
            f"{res['d']['not_argmax']} not the teacher-forced argmax, {res['d']['near_ties']} steps with a top-2 "
            f"gap under {TIE_GAP}; logits up to {res['d']['logit_absmax']:.2f}, {res['d']['distinct_tokens']} "
            f"distinct tokens, {res['d']['finished_rows']} rows ended by EOT")
        require(res["d"]["max_gap"] <= TIE_GAP, f"(d) an emitted token lies {res['d']['max_gap']} below its step's max")

        # (e) recompute vs cached greedy, f32
        n8 = shape["recompute_tokens"]
        slow = wd.greedy_decode(dec32, out32, prompt, eot, n8, suppress)
        fast = wd.greedy_decode_cached(dec32, out32, prompt, eot, n8, suppress)
        res["e"] = {"equal": bool(torch.equal(slow, fast)), "same_as_cli": bool(torch.equal(fast, tokens[:, :P + n8]))}
        log(f"[transcribe] (e) greedy_decode vs greedy_decode_cached, f32, {n8} new tokens x {B} rows: "
            f"equal {res['e']['equal']}; the CLI's first {n8} tokens too: {res['e']['same_as_cli']}")
        require(res["e"]["equal"], f"(e) recompute {slow.tolist()} != cached {fast.tolist()}")

        # (f) bf16 cached steps, fed the f32 tokens, against the f32 teacher-forced logits; the
        # same run times the bf16 steps
        state16 = wd.CachedDecoder(dec16, out16, P + N)
        cos = []
        steps16 = step_through(state16, tokens, P, lambda t, step: cos.append(torch.nn.functional.cosine_similarity(
            step.double(), logits[:, t - P + 1].double(), dim=-1)))
        cos = torch.cat(cos)
        res["f"] = {"min_cos": float(cos.min()), "median_cos": float(cos.median()), "n": int(cos.numel())}
        log(f"[transcribe] (f) bf16 cached step logits vs f32 teacher-forced, {res['f']['n']} row-steps: cosine min "
            f"{res['f']['min_cos']:.6f}, median {res['f']['median_cos']:.6f} (bar {BF16_STEP_COSINE})")
        require(res["f"]["min_cos"] >= BF16_STEP_COSINE, f"(f) bf16 step cosine {res['f']['min_cos']}")
        res["f_products"] = check_f32_products(state16, tokens, P + N // 2)
        del logits, chosen

        # times, per dtype, at the CLI's batch
        for dtype, enc, dec, out in (("bfloat16", enc16, dec16, out16), ("float32", enc32, dec32, out32)):
            t = {"encoder_ms": _ms(lambda: enc(mel, keep=(-1,)))}
            if dtype == "bfloat16":
                state, step_ms = state16, steps16
            else:
                state = wd.CachedDecoder(dec, out, P + N)
                step_ms = step_through(state, tokens, P)
            t["cross_kv_ms"] = _ms(lambda: state.project_cross_kv(dec, out))
            t["step_ms"], t["step_ms_min"] = statistics.median(step_ms), min(step_ms)
            mid = P + N // 2
            t["bound_ms"], t["bound_by"] = decode_step_bound(enc_cfg, dec_cfg, B, mid, dec.config.compute_dtype)
            t.update(profile_decode(state, tokens, P, shape["profile_steps"], dtype, smi))
            run = tr["runs"][dtype]
            t.update({"cli_tokens_per_sec": run["stats"].tokens_per_sec, "cli_slots_per_sec": run["stats"].slots_per_sec,
                      "cli_emitted_tokens": run["stats"].emitted_tokens, "cli_utt_per_sec": run["stats"].utts_per_sec,
                      "cli_decode_s": run["stats"].decode_seconds, "cli_encoder_s": run["stats"].encoder_seconds,
                      "cli_batches_s": run["stats"].wall_seconds, "cli_s": run["cli_s"], "peak_gb": run["peak_gb"]})
            res[dtype] = t
            log(f"[transcribe] {dtype} B={B}: encoder {t['encoder_ms']:.2f} ms a batch, cross-K/V projection "
                f"{t['cross_kv_ms']:.2f} ms, decode step median {t['step_ms']:.3f} ms (min {t['step_ms_min']:.3f}) vs "
                f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}, step {mid}); CLI {t['cli_tokens_per_sec']:.1f} "
                f"emitted tokens/s ({t['cli_slots_per_sec']:.1f} slots/s), {t['cli_utt_per_sec']:.2f} utt/s; decode idle {100 * t['idle_share']:.1f}%; peak "
                f"{t['peak_gb']:.2f} GB ({smi})")
            del state
        del state16
    return res


def check_f32_products(state, tokens: torch.Tensor, idx: int) -> dict:
    """(f), the products: one bf16 step at position ``idx`` (its caches
    already filled, so the step rewrites them with the same values), each
    product it sends through ``_f32_product`` (every layer's self and cross
    scores and weighted sums) held to ``torch.matmul`` of the operands upcast
    to f32: the relative L2 of ``_f32_product``'s result within
    F32_PRODUCT_REL, and that of the same result rounded to bf16 beyond it."""
    from interspeech_ser_tpu_torch.models import whisper_decoder as wd

    product, errs, rounded = wd._f32_product, [], []

    def recording(a, b):
        out = product(a, b)
        ref = torch.matmul(a.float(), b.float()).double()
        scale = ref.norm()
        errs.append(float((out.double() - ref).norm() / scale))
        rounded.append(float((out.to(a.dtype).double() - ref).norm() / scale))
        return out

    wd._f32_product = recording
    try:
        state.step(tokens[:, idx], idx)
    finally:
        wd._f32_product = product
    res = {"n": len(errs), "dtype": str(state.cfg.compute_dtype), "max_rel": max(errs),
           "rounded_min_rel": min(rounded), "rounded_max_rel": max(rounded)}
    log(f"[transcribe] (f) _f32_product on {res['n']} bf16 products of step {idx} vs the f32 product of the upcast "
        f"operands: relative L2 max {res['max_rel']:.3e} (bar {F32_PRODUCT_REL}); rounded to bf16 it would read "
        f"{res['rounded_min_rel']:.3e}-{res['rounded_max_rel']:.3e}")
    require(state.cfg.compute_dtype == torch.bfloat16 and res["n"] == 4 * state.cfg.decoder_layers,
            f"(f) products: {res['n']} products of a {state.cfg.compute_dtype} step")
    require(res["max_rel"] <= F32_PRODUCT_REL, f"(f) _f32_product lies {res['max_rel']} from the f32 product")
    require(res["rounded_min_rel"] > F32_PRODUCT_REL,
            f"(f) a bf16-rounded product reads {res['rounded_min_rel']}: the bar cannot tell f32 from bf16")
    return res


def step_through(state, tokens: torch.Tensor, P: int, each=None) -> list:
    """Every position of ``tokens`` [B, P + N] through ``state.step`` (the
    prompt's only fill the caches) -> the ms of each emitting step: CUDA
    events around the step on the card (a host-bound step reads its host
    time), the host clock here. ``each(t, logits)`` sees each emitting
    step's logits, outside the timed window."""
    times = []
    for t in range(tokens.shape[1] - 1):
        emit = t >= P - 1
        if DEVICE == "cuda":
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            logits = state.step(tokens[:, t], t, logits=emit)
            e.record()
        else:
            h0 = time.perf_counter()
            logits = state.step(tokens[:, t], t, logits=emit)
            s, e = (time.perf_counter() - h0) * 1e3, None
        if emit:
            times.append((s, e))
            if each is not None:
                each(t, logits)
    sync()
    return [s.elapsed_time(e) if e is not None else s for s, e in times]


def profile_decode(state, tokens: torch.Tensor, P: int, n: int, dtype: str, smi: str) -> dict:
    """``n`` decode steps from position P under the profiler (the caches
    already filled by a run): wall and device-busy ms, the idle share, the
    kernels launched a step and the top device ops."""
    if DEVICE != "cuda":
        return {"idle_share": float("nan")}
    from torch.profiler import ProfilerActivity, profile

    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(P, P + n):
            state.step(tokens[:, i], i)
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"profile_wall_ms": wall_ms, "profile_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
           "kernels_per_step": sum(e.count for e in kernels) / n,
           "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"[transcribe] profile of {n} {dtype} decode steps: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * res['idle_share']:.1f}%), {res['kernels_per_step']:.0f} kernels a step ({smi})")
    for name, ms, count in res["top"]:
        log(f"[transcribe]   {ms:9.3f} ms  x{count:<5d} {name}")
    return res


# -- phase 13: the legacy fusion surface (bin/old through cli.LEGACY) -------------------

# one epoch a run over phase 6's corpus; the runs, in order: (bin/old stem, extra flags);
# the scoring runs read the checkpoint of the train run before them
LEGACY_RUNS = (
    ("train_cat_bimodal_lazy_moe", ()), ("eval_cat_bimodal_lazy_moe", ()),
    ("train_cat_bimodal_lazy_grlgender", ("gender",)), ("train_cat_bimodal_lazy_gender_svm", ("gender",)),
    ("train_cat_bimodal_lazy_fiona", ()), ("eval_cat_bimodal_lazy_fiona", ()),
    ("train_dim_bimodal_lazy_cka", ()), ("eval_dim_bimodal_lazy", ()), ("test_dim_bimodal_lazy", ("test_df",)),
    ("train_dim_bimodal_lazy_fromcat", ()), ("train_cat_wavlm_lazy", ()),
)
# the runs that share a model path (and so a checkpoint) with the train run named
LEGACY_MODEL_OF = {"eval_cat_bimodal_lazy_moe": "train_cat_bimodal_lazy_moe",
                   "eval_cat_bimodal_lazy_fiona": "train_cat_bimodal_lazy_fiona",
                   "eval_dim_bimodal_lazy": "train_dim_bimodal_lazy_cka",
                   "test_dim_bimodal_lazy": "train_dim_bimodal_lazy_cka"}
LEGACY_GRAD_CHECKS = ("train_cat_bimodal_lazy_moe", "train_cat_bimodal_lazy_grlgender", "train_dim_bimodal_lazy_cka")


def write_legacy_corpus(tmp: str, train_config: str) -> dict:
    """Phase 6's corpus with seeded EmoAct / EmoDom / EmoVal columns, a seeded
    FileName,Gender CSV and a test CSV of the dev names; one config a train
    run (one epoch, phase 6's cat checkpoint as ``pretrained_path``)."""
    with open(train_config) as f:
        base = json.load(f)
    rows = list(csv.reader(open(base["label_path"], newline="")))
    rng = np.random.default_rng(SEED + 13)
    attrs = np.round(rng.uniform(1.0, 7.0, (len(rows) - 1, 3)), 3)
    label_csv, gender_csv = os.path.join(tmp, "legacy_labels.csv"), os.path.join(tmp, "legacy_gender.csv")
    with open(label_csv, "w", newline="") as f:
        csv.writer(f).writerows([rows[0][:-1] + ["EmoAct", "EmoDom", "EmoVal", rows[0][-1]]]
                                + [r[:-1] + [str(v) for v in a] + [r[-1]] for r, a in zip(rows[1:], attrs)])
    with open(gender_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "Gender"]]
                                + [[r[0], ("Female", "Male")[int(rng.integers(2))]] for r in rows[1:]])
    test_csv = os.path.join(tmp, "legacy_test.csv")
    dev = [r[0] for r in rows[1:] if r[-1] == "Development"]
    with open(test_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName"]] + [[n] for n in dev])
    configs = {}
    for stem, _ in LEGACY_RUNS:
        if stem in LEGACY_MODEL_OF:
            configs[stem] = configs[LEGACY_MODEL_OF[stem]]
            continue
        cfg = dict(base, label_path=label_csv, epochs=1, model_path=os.path.join(tmp, f"legacy_{stem}"),
                   pretrained_path=os.path.join(base["model_path"], "multimodal_ser.pt"))
        configs[stem] = os.path.join(tmp, f"legacy_{stem}.json")
        with open(configs[stem], "w") as f:
            json.dump(cfg, f)
    return {"configs": configs, "gender_csv": gender_csv, "test_csv": test_csv, "n_dev": len(dev),
            "n_train": len(rows) - 1 - len(dev)}


def _legacy_experts(overrides: dict) -> int:
    """BiGRU stacks a forward runs per modality: the MoE's experts, 0 for the
    single-modality model, else 1."""
    variant = overrides.get("model_variant", "fusion")
    return {"moe": 4, "single": 0}.get(variant, 1)


def phase_legacy(tmp: str, train_config: str) -> dict:
    """Phase 13: each LEGACY_RUNS entry through ``cli.main([runner, '--legacy',
    stem, ...])``: finite logged losses, K3 = experts x modalities x (train
    steps + scored batches) and K3b = experts x modalities x train steps per
    run (0 for the single-modality model) and no other kernel, the CSVs'
    headers, rows and 4-decimal values, the MoE and gender checkpoints' flat
    flax keys and strict reloads, and the ``fromcat`` warm start (every name
    + shape match of phase 6's cat checkpoint loaded, its 8-way head skipped)."""
    from interspeech_ser_tpu_torch import cli
    from interspeech_ser_tpu_torch.models.convert import is_flax_flat
    from interspeech_ser_tpu_torch.train.engine import EngineOptions, FusionEngine
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config
    from interspeech_ser_tpu_torch.utils.labels import CLASSES

    corpus = write_legacy_corpus(tmp, train_config)
    four = re.compile(r"^-?\d+\.\d{4}$")
    runs = {}
    for stem, extra in LEGACY_RUNS:
        runner, overrides = cli.LEGACY[stem]
        config_path = corpus["configs"][stem]
        cfg = load_fusion_config(config_path)
        argv = [runner, "--legacy", stem, "--config_path", config_path, "--device", DEVICE]
        argv += ["--gender_labels_csv", corpus["gender_csv"]] * ("gender" in extra)
        argv += ["--test_df", corpus["test_csv"]] * ("test_df" in extra)
        before = counts()
        t0 = time.perf_counter()
        cli.main(argv)
        sync()
        seconds = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in counts().items()}
        n_mod, experts = len(cfg.feat_dims), _legacy_experts(overrides)
        scored = -(-corpus["n_dev"] // cfg.batch_size)  # the dev split, or the test CSV of its names
        steps = -(-corpus["n_train"] // cfg.batch_size) if runner == "train" else 0
        want = {"gru_bidir": experts * n_mod * (steps + scored), "gru_bidir_bwd": experts * n_mod * steps}
        require(delta["gru_bidir"] == want["gru_bidir"] and delta["gru_bidir_bwd"] == want["gru_bidir_bwd"],
                f"{stem}: K3 / K3b launches {delta['gru_bidir']} / {delta['gru_bidir_bwd']} != "
                f"{want['gru_bidir']} / {want['gru_bidir_bwd']} ({experts} experts x {n_mod} modalities x "
                f"({steps} steps + {scored} scored batches))")
        moved = {k: v for k, v in delta.items() if k not in want and v}
        require(not moved, f"{stem}: kernels other than K3 / K3b launched: {moved}")
        run = {"runner": runner, "seconds": seconds, "launches": delta}
        if runner == "train":
            text = ""
            for log_file in sorted(f for f in os.listdir(cfg.model_path) if f.startswith("loggingtxt-")):
                with open(os.path.join(cfg.model_path, log_file)) as f:
                    text += f.read()
            logged = [float(v) for v in re.findall(r"(?:eval_loss|: loss) = (\S+)", text)]
            require(logged and all(np.isfinite(logged)), f"{stem}: logged losses {logged}")
            ckpt = torch.load(os.path.join(cfg.model_path, "multimodal_ser.pt"), weights_only=True)
            flat = overrides.get("model_variant", "fusion") != "fusion" or "gender_mode" in overrides
            require(is_flax_flat(ckpt) == flat, f"{stem}: checkpoint keys {sorted(ckpt)[:4]}...")
            engine = FusionEngine(cfg, seed=SEED, device=DEVICE, options=EngineOptions(**overrides))
            engine.load_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"), strict=True)
            run.update(logged=logged, flat_keys=flat, n_keys=len(ckpt))
            if overrides.get("init_from_pretrained"):
                kept, skipped = engine.load_torch_checkpoint_filtered(cfg.raw["pretrained_path"])
                own = engine.model.state_dict()
                require(sorted(skipped) == ["classifier.3.bias", "classifier.3.weight"]
                        and set(kept) == set(own) - set(skipped), f"fromcat: kept {len(kept)}, skipped {skipped}")
                require(f"skipped {['classifier.3.weight', 'classifier.3.bias']}" in text,
                        "fromcat: the warm start is not in the run's log")
                run.update(warm_start_kept=len(kept), warm_start_skipped=skipped)
        else:
            out_csv = os.path.join(cfg.model_path, "results", "test.csv" if runner.startswith("test") else "dev.csv")
            with open(out_csv, newline="") as f:
                table = list(csv.reader(f))
            dim = runner.endswith("_dim")
            header = ([("FileName" if runner.startswith("test") else "Filename"), "EmoAct", "EmoDom", "EmoVal"]
                      if dim else ["Filename", "Prediction"] + [f"class_{i}_prob" for i in range(len(CLASSES))])
            require(table[0] == header, f"{stem}: header {table[0]}")
            require(len(table) == 1 + corpus["n_dev"], f"{stem}: {len(table) - 1} rows")
            require(all(four.match(v) for r in table[1:] for v in r[1 if dim else 2:]),
                    f"{stem}: values not 4-decimal")
            run["rows"] = len(table) - 1
        runs[stem] = run
        log(f"[legacy] {runner} --legacy {stem}: {seconds:.2f} s, K3 {delta['gru_bidir']}, K3b "
            f"{delta['gru_bidir_bwd']}" + (f", logged {run['logged']}" if "logged" in run else "")
            + (f", {run['rows']} CSV rows" if "rows" in run else ""))
    return {"runs": runs, **corpus}


def legacy_batch(corpus: dict, stem: str):
    """(engine options, config, the first batch of 64 train rows with the task's
    labels and gender targets, the train class weights or None)."""
    from interspeech_ser_tpu_torch import cli
    from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
    from interspeech_ser_tpu_torch.train.engine import DIM_COLUMNS, EngineOptions
    from interspeech_ser_tpu_torch.utils import labels as L
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    options = EngineOptions(**cli.LEGACY[stem][1])
    cfg = load_fusion_config(corpus["configs"][stem])
    rows = L.split(L.load_merged(cfg.label_path, cfg.txt_dir), "Train")
    aux = None
    if options.gender_mode is not None:
        rows = L.merge_gender(rows, corpus["gender_csv"])
        aux = np.asarray([int(r["target_gender"]) for r in rows], np.int64)
    dim = options.task == "dim"
    ds = LazyFeatureDataset(L.column(rows, "FileName"), L.matrix(rows, DIM_COLUMNS if dim else L.CLASSES),
                            cfg.lazy_dirs, cfg.feat_dims, aux_labels=aux)
    class_w = None if dim else torch.from_numpy(L.class_weights(rows)).to(DEVICE)
    return options, cfg, ds.collate(list(range(cfg.batch_size)), cfg.batch_size), class_w


def check_legacy_steps(corpus: dict, smi: str) -> dict:
    """One train step's gradients of the MoE, the GRL gender head and the dim +
    CKA trainer through K3 + K3b against the plain path (``BiGRU.forward_scan``)
    on the card, phase 6's bar (1e-4 of each parameter's largest gradient, with
    its floor); then the median of 5 train steps of the MoE and of the dim
    trainer at batch 64 and the MoE's scoring forward of that batch."""
    from interspeech_ser_tpu_torch.ops.gru import BiGRU
    from interspeech_ser_tpu_torch.train.engine import FusionEngine

    out = {}
    for stem in LEGACY_GRAD_CHECKS:
        options, cfg, batch, class_w = legacy_batch(corpus, stem)
        grads = {}
        for route in ("kernel", "plain"):
            engine = FusionEngine(cfg, seed=SEED, device=DEVICE, options=options)
            kernel_forward = BiGRU.forward
            if route == "plain":
                BiGRU.forward = BiGRU.forward_scan
            try:
                loss, _ = engine.accumulate_gradients(batch, class_w)
            finally:
                BiGRU.forward = kernel_forward
            require(bool(torch.isfinite(loss)), f"{stem} {route} train-step loss {loss}")
            grads[route] = {n: p.grad.detach().clone() for n, p in engine.model.named_parameters()
                            if p.grad is not None}
        require(set(grads["kernel"]) == set(grads["plain"]), f"{stem}: the routes reach other parameters")
        top = max(float(g.abs().max()) for g in grads["plain"].values())
        errs = {n: max_abs(grads["kernel"][n], gp) / max(float(gp.abs().max()), 1e-3 * top)
                for n, gp in grads["plain"].items()}
        worst = max(errs, key=errs.get)
        gru = max(v for n, v in errs.items() if "_gru." in n)
        log(f"[legacy] {stem}: one step's gradients, kernel path vs plain path on {DEVICE} ({len(errs)} "
            f"parameters): worst {worst} {errs[worst]:.3e}, worst GRU weight {gru:.3e} (bar 1e-4)")
        require(errs[worst] <= 1e-4, f"{stem} train-step gradient {worst}: {errs[worst]} > 1e-4")
        out[stem] = {"grad_rel_err": errs[worst], "worst": worst}
    for stem in ("train_cat_bimodal_lazy_moe", "train_dim_bimodal_lazy_cka"):
        options, cfg, batch, class_w = legacy_batch(corpus, stem)
        engine = FusionEngine(cfg, seed=SEED, device=DEVICE, options=options)
        times = host_times_ms(train_step_fn(engine, batch, class_w))
        out[stem].update(train_step_ms=statistics.median(times), train_step_ms_runs=times)
        log(f"[legacy] {stem} train step (batch {cfg.batch_size}, kernels, TF32 off): median "
            f"{out[stem]['train_step_ms']:.3f} ms of runs {[round(t, 3) for t in times]} ({smi})")
        if options.model_variant == "moe":
            out[stem]["score"] = time_scoring_forward(engine, batch)
    return out


# -- phase 14: the joint RoBERTa + WavLM trainers (joint_cli, the bin/old train_cat_roberta* stems) ------------

# phase 11's corpus and hyperparameters (batch 32 in micro-batches of 8, one epoch) with seeded transcripts of
# phase 8's words; the conv / transformer heads at the reference's 512; the gradient check on a batch of grad_rows
# rows whose last ones are padding; timings: median of steps micro-steps of the 8 longest train wavs
JOINT_SHAPE = dict(batch_size=32, accum_step=4, epochs=1, lr=1e-5, head_dim=512, words=(0, 60), grad_rows=4,
                   grad_live=3, steps=5)
# the stems joint_cli.main runs, in order (the text-only trainer last)
JOINT_RUNS = ("train_cat_roberta_wavlm", "train_cat_roberta_wavlm_ftall", "train_cat_roberta_wavlm_large",
              "train_cat_roberta_wavlm_large_cka", "train_cat_roberta")
JOINT_TIMED = ("train_cat_roberta_wavlm_ftall", "train_cat_roberta_wavlm_large", "train_cat_roberta_wavlm_large_cka")


def roberta_base(dtype: str = "float32"):
    """RoBERTa-base's width and depth: D = 768, 12 layers, 12 heads, FFN 3072."""
    from interspeech_ser_tpu_torch.models import text

    return text.RobertaConfig(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, dtype=dtype)


def write_text_layers(src_dir: str, model_dir: str, layers: int) -> None:
    """The first ``layers`` layers of an HF RoBERTa directory, at its width, with its BPE files."""
    with open(os.path.join(src_dir, "config.json")) as f:
        cfg = json.load(f)
    sd = torch.load(os.path.join(src_dir, "pytorch_model.bin"), weights_only=True)
    keep = {k: v for k, v in sd.items() if not k.startswith("encoder.layer.") or int(k.split(".")[2]) < layers}
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg, "num_hidden_layers": layers}, f, indent=1)
    torch.save(keep, os.path.join(model_dir, "pytorch_model.bin"))
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(os.path.join(src_dir, name), os.path.join(model_dir, name))


def write_joint_corpus(tmp: str, baseline_config: str, wavlm_dir: str, roberta_large_dir: str) -> dict:
    """Phase 11's corpus with a ``FileName,transcription`` CSV (seeded texts of
    phase 8's words, one row empty, one missing), a seeded RoBERTa-base-width
    directory beside phase 8's RoBERTa-large (its BPE files copied), and one
    config a stem: phase 11's paths, JOINT_SHAPE's hyperparameters, ``text_type``
    as the JAX CLI defaults it (RoBERTa-base for ``base``, ``ftall`` and the
    text-only trainer, RoBERTa-large otherwise) and ``tokenizer_path``."""
    from interspeech_ser_tpu_torch import joint_cli
    from interspeech_ser_tpu_torch.models import text
    from interspeech_ser_tpu_torch.utils import labels as L

    shape = JOINT_SHAPE
    with open(baseline_config) as f:
        paths = json.load(f)
    rows = L.read_csv(paths["label_path"])
    words = synthetic_words(SEED + 6)
    rng = np.random.default_rng(SEED + 13)
    txt_path = os.path.join(tmp, "joint_transcripts.csv")
    with open(txt_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FileName", "transcription"])
        for i, r in enumerate(rows):
            if i != 3:  # a labelled row with no transcript row: the empty text, as pandas' left merge gives it
                n = 0 if i == 1 else int(rng.integers(*shape["words"]))
                w.writerow([r["FileName"], " ".join(words[int(j)] for j in rng.integers(0, len(words), n))])
    base_dir = os.path.join(tmp, "roberta-base")
    write_text_model(base_dir, text.RobertaModel, roberta_base(), "RobertaModel")
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(os.path.join(roberta_large_dir, name), os.path.join(base_dir, name))
    configs = {}
    for stem in JOINT_RUNS:
        variant = joint_cli.STEMS[stem]
        cfg = {**paths, "txt_dir": txt_path, "ssl_type": wavlm_dir, "batch_size": shape["batch_size"],
               "accum_step": shape["accum_step"], "epochs": shape["epochs"], "lr": shape["lr"],
               "head_dim": shape["head_dim"], "model_path": os.path.join(tmp, f"joint_{stem}"),
               "text_type": base_dir if variant in (None, "base", "ftall") else roberta_large_dir,
               "tokenizer_path": roberta_large_dir, "pooling_type": "none", "weight_decay": 1e-6,
               "dropout_head": 0.5, "use_timbre_perturb": False, "tp_prob": 0.0}
        configs[stem] = os.path.join(tmp, f"joint_{stem}.json")
        with open(configs[stem], "w") as f:
            json.dump(cfg, f)
    n_train = sum(r["Split_Set"] == "Train" for r in rows)
    n_dev = sum(r["Split_Set"] == "Development" for r in rows)
    return {"configs": configs, "txt_path": txt_path, "base_dir": base_dir, "tokenizer_path": roberta_large_dir,
            "n_train": n_train, "n_dev": n_dev, "label_path": paths["label_path"], "wav_dir": paths["wav_dir"]}


def predict_joint_launches(variant, speech_layers: int, text_layers: int, n_micro: int, dev_batches: int,
                           text_dev_batches: int) -> dict:
    """The launches one run of a stem makes: the frozen variants run K1, K2's
    layer 0, K8 and K7 on every train micro-batch and dev batch; ``ftall`` K1
    on all of them, K4 on each micro-batch's backward and K7 on the dev
    batches (RoBERTa trains on the plain attention, the frontend and the
    positional conv on cuDNN); the text-only trainer K7 on its dev batches of
    16; nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    if variant is None:
        want["attention_bhtd"] = text_layers * text_dev_batches
        return want
    batches = n_micro + dev_batches
    want["attention_btd"] = speech_layers * batches
    if variant == "ftall":
        want["attention_btd_bwd"] = speech_layers * n_micro
        want["attention_bhtd"] = text_layers * dev_batches
    else:
        want.update(attention_bhtd=text_layers * batches, conv_frontend=batches, pos_conv=batches)
    return want


def phase_joint(tmp: str, baseline_config: str, wavlm_dir: str, roberta_large_dir: str) -> dict:
    """Phase 14: ``joint_cli.main`` for each JOINT_RUNS stem, one epoch, f32,
    TF32 off: finite train and dev losses, the files each writes (and their
    keys: the reference's head names, HF names for ``ftall``'s encoders,
    ``roberta.*`` / ``classifier.*`` for the text-only trainer), and each
    run's launches against ``predict_joint_launches`` (logged side by side)."""
    from interspeech_ser_tpu_torch import joint_cli
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.models.loader import read_config

    shape = JOINT_SHAPE
    corpus = write_joint_corpus(tmp, baseline_config, wavlm_dir, roberta_large_dir)
    speech_layers = speech.wavlm_large().num_layers
    micro = shape["batch_size"] // shape["accum_step"]
    n_micro = -(-corpus["n_train"] // micro) * shape["epochs"]
    dev_batches = -(-corpus["n_dev"] // 8) * shape["epochs"]
    text_dev_batches = -(-corpus["n_dev"] // 16) * shape["epochs"]
    runs = {}
    for stem in JOINT_RUNS:
        variant = joint_cli.STEMS[stem]
        with open(corpus["configs"][stem]) as f:
            cfg = json.load(f)
        text_layers = read_config(cfg["text_type"])["num_hidden_layers"]
        want = predict_joint_launches(variant, speech_layers, text_layers, n_micro, dev_batches, text_dev_batches)
        log(f"[joint] {stem}: predicted launches {{{', '.join(f'{k}: {v}' for k, v in want.items() if v)}}}")
        before = counts()
        t0 = time.perf_counter()
        best = joint_cli.main([stem, "--config_path", corpus["configs"][stem], "--device", DEVICE])
        sync()
        seconds = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counts().items()}
        log(f"[joint] {stem}: measured launches {{{', '.join(f'{k}: {v}' for k, v in got.items() if v)}}}")
        require(got == want, f"{stem}: launches {got} != predicted {want}")
        losses = best["dev_losses"] + best.get("train_losses", [])
        require(best["epoch"] == 0 and losses and all(np.isfinite(losses)), f"{stem}: {best}")
        files = (["text_ser.pt"] if variant is None else
                 ["final_ser.pt"] + (["final_text_model.pt", "final_ssl.pt"] if variant == "ftall" else []))
        keys = {}
        for name in files:
            sd = torch.load(os.path.join(cfg["model_path"], name), weights_only=True)
            keys[name] = len(sd)
            if name == "final_ser.pt":
                head = "wav_conv1.weight" if variant in ("base", "ftall") else "wav_transformer.layers.1.linear2.weight"
                require(head in sd and ("wav_gate.0.weight" in sd) == (variant == "cka"), f"{stem}: {sorted(sd)[:6]}")
            elif name == "final_ssl.pt":
                require("encoder.pos_conv_embed.conv.parametrizations.weight.original0" in sd, f"{stem}: final_ssl.pt")
            elif name == "text_ser.pt":
                require("roberta.embeddings.word_embeddings.weight" in sd and "classifier.out_proj.weight" in sd,
                        f"{stem}: text_ser.pt keys")
        runs[stem] = {"variant": variant, "seconds": seconds, "launches": got, "predicted": want,
                      "dev_losses": best["dev_losses"], "train_losses": best.get("train_losses"),
                      "dev_logits": best["dev_logits"], "files": keys, "model_path": cfg["model_path"],
                      "ssl_type": cfg["ssl_type"], "text_type": cfg["text_type"]}
        log(f"[joint] {stem} ({variant or 'text only'}): {seconds:.2f} s incl. loading; dev loss "
            f"{best['dev_losses']}, train loss {best.get('train_losses')}; files {keys}")
    return {"runs": runs, **corpus, "n_micro": n_micro, "dev_batches": dev_batches}


def _joint_engine(run: dict, tokenize):
    """The run's engine rebuilt from the model directories, its saved files loaded strictly."""
    from interspeech_ser_tpu_torch.models.loader import speech_state_dict_from_hf
    from interspeech_ser_tpu_torch.train.joint_engine import VARIANTS, JointEngine, TextOnlyEngine

    load = lambda name: torch.load(os.path.join(run["model_path"], name), weights_only=True)  # noqa: E731
    if run["variant"] is None:
        engine = TextOnlyEngine(run["text_type"], tokenize, device=DEVICE)
        sd = load("text_ser.pt")
        engine.txt.load_state_dict({k[len("roberta."):]: v for k, v in sd.items() if k.startswith("roberta.")})
        engine.cls_head.load_state_dict({k[len("classifier."):]: v for k, v in sd.items()
                                         if k.startswith("classifier.")})
        return engine
    engine = JointEngine(run["ssl_type"], run["text_type"], tokenize, VARIANTS[run["variant"]],
                         head_dim=JOINT_SHAPE["head_dim"], device=DEVICE)
    if run["variant"] == "ftall":  # the trained encoders
        engine.ssl.load_state_dict(speech_state_dict_from_hf(load("final_ssl.pt")), strict=True)
        engine.txt.load_state_dict(load("final_text_model.pt"), strict=True)
    engine.load_head(run["model_path"])
    return engine


def _joint_split(corpus: dict, split: str, tokenize, model_path: str):
    """A split's wavs (normalised with the run's train stats) and transcripts, as fit reads them."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.podcast import SPLIT_MAP, load_cat_emo_label
    from interspeech_ser_tpu_torch.utils import labels as L

    rows = L.split(L.load_merged(corpus["label_path"], corpus["txt_path"]), SPLIT_MAP[split])
    utts, labs = load_cat_emo_label(corpus["label_path"], split)
    mean, std = bdata.load_norm_stat(os.path.join(model_path, "train_norm_stat.pkl"))
    return (bdata.WavDataset(bdata.load_audio(corpus["wav_dir"], utts), labs, utts, mean, std),
            bdata.TxtDataset(L.transcripts(rows), tokenize))


def check_joint_runs(joint: dict, smi: str) -> dict:
    """Each run's saved files, reloaded strictly into a rebuilt engine,
    reproduce its dev logits (1e-5); dev batches of 8 (16 for the text-only
    trainer) against batch-1 (1e-4); then on the reloaded ``ftall``, ``large``
    and ``cka`` engines the median of JOINT_SHAPE's micro-steps (forward +
    backward, head dropout on, 8 rows of the longest train wavs) and the
    peak device memory of those steps."""
    from interspeech_ser_tpu_torch import joint_cli

    from interspeech_ser_tpu_torch.utils import labels as L

    tokenize = joint_cli.make_bpe_tokenize(joint["tokenizer_path"])
    out = {}
    for stem, run in joint["runs"].items():
        engine = _joint_engine(run, tokenize)
        if run["variant"] is None:
            rows = L.split(L.load_merged(joint["label_path"], joint["txt_path"]), "Development")
            toks = tokenize(L.transcripts(rows))
            logits = engine.predict(toks["input_ids"], toks["attention_mask"])
            single = engine.predict(toks["input_ids"], toks["attention_mask"], batch_size=1)
        else:
            wav_set, txt_set = _joint_split(joint, "dev", tokenize, run["model_path"])
            logits = engine.predict(wav_set, txt_set)[0]
            single = engine.predict(wav_set, txt_set, batch_size=1)[0]
        reload_err = float(np.abs(logits - run["dev_logits"]).max())
        batch1_err = float(np.abs(logits - single).max())
        log(f"[joint] {stem}: reloaded dev logits vs the run's max_abs {reload_err:.3e} (bar 1e-5); batched vs "
            f"batch-1 max_abs {batch1_err:.3e} (bar 1e-4) over {len(logits)} dev rows")
        require(reload_err <= 1e-5 and batch1_err <= 1e-4, f"{stem}: reload {reload_err}, batch-1 {batch1_err}")
        res = {"reload_max_abs": reload_err, "batch1_max_abs": batch1_err}
        if stem in JOINT_TIMED:
            res.update(time_joint_step(engine, joint, run, tokenize, smi, stem))
        out[stem] = res
        del engine
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def time_joint_step(engine, joint: dict, run: dict, tokenize, smi: str, stem: str) -> dict:
    """Host-clock ms of JOINT_SHAPE's micro-steps of the 8 longest train wavs
    with their transcripts (each synchronised, after a warm-up) and the peak
    device memory over them."""
    from interspeech_ser_tpu_torch.baseline import data as bdata

    wav_set, txt_set = _joint_split(joint, "train", tokenize, run["model_path"])
    longest = list(np.argsort([len(w) for w in wav_set.wav_list], kind="stable")[-8:])
    wb, ids, tmask = bdata.collate_txt_wav(wav_set, txt_set, longest, 8)
    params = list(engine.head.parameters()) + (engine.encoder_params() if run["variant"] == "ftall" else [])
    cw = torch.ones(8, device=DEVICE)

    def micro_step():
        for p in params:
            p.grad = None
        total, _, _ = engine.loss(wb, ids, tmask, cw)
        total.backward()

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = host_times_ms(micro_step, JOINT_SHAPE["steps"])
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None
    log(f"[joint] {stem} micro-step (8 rows x {wb.wav.shape[1] / 16000:.0f} s + 128 tokens, forward + backward, "
        f"{'both encoders trained' if run['variant'] == 'ftall' else 'encoders frozen'}): median "
        f"{statistics.median(times):.3f} ms of runs {[round(t, 3) for t in times]}; peak device memory {peak} GB "
        f"({smi})")
    return {"step_ms": statistics.median(times), "step_ms_runs": times, "peak_gb": peak,
            "trained_values": sum(p.numel() for p in params)}


def check_joint_grads(tmp: str, wavlm_dir: str, joint: dict) -> dict:
    """One ``ftall`` micro-step (head dropout off, a batch whose last rows are
    padding) on a 2-layer full-width copy (WavLM-large and RoBERTa-base, 2
    layers each) through K1 + K4 against ``plain=True`` on the card: every
    trained tensor's f32 gradient within 1e-4 of its largest magnitude (of
    1e-4 of the step's largest gradient where the tensor's is smaller); the
    key biases, whose gradient a softmax zeroes but for rounding, below 1e-4
    of the step's largest on both routes."""
    from interspeech_ser_tpu_torch import joint_cli
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.train.joint_engine import VARIANTS, JointEngine

    shape = JOINT_SHAPE
    two_wavlm, two_text = os.path.join(tmp, "wavlm-2layers"), os.path.join(tmp, "roberta-base-2layers")
    if not os.path.exists(two_wavlm):
        write_wavlm_layers(wavlm_dir, two_wavlm, 2)
    write_text_layers(joint["base_dir"], two_text, 2)
    tokenize = joint_cli.make_bpe_tokenize(two_text)
    engine = JointEngine(two_wavlm, two_text, tokenize, VARIANTS["ftall"], head_dim=shape["head_dim"], device=DEVICE)
    run = joint["runs"]["train_cat_roberta_wavlm_ftall"]
    wav_set, txt_set = _joint_split(joint, "train", tokenize, run["model_path"])
    wb, ids, tmask = bdata.collate_txt_wav(wav_set, txt_set, list(range(shape["grad_live"])), shape["grad_rows"])
    named = [(f"{m}.{n}", p) for m in ("ssl", "txt", "head") for n, p in getattr(engine, m).named_parameters()]
    cw = torch.linspace(0.5, 2.0, 8, device=DEVICE)
    grads, launched = {}, {}
    for route in ("kernel", "plain"):
        for _, p in named:
            p.grad = None
        before = counts()
        total, _, _ = engine.loss(wb, ids, tmask, cw, deterministic=True, plain=route == "plain")
        total.backward()
        sync()
        launched[route] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        require(bool(torch.isfinite(total)), f"ftall {route} loss {total}")
        grads[route] = {n: p.grad.detach().clone() for n, p in named}
    require(launched["plain"] == {} and launched["kernel"] == {"attention_btd": 2, "attention_btd_bwd": 2},
            f"ftall gradient check launches {launched}")
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    key_bias = [n for n in grads["plain"] if n.endswith(("k_proj.bias", "attention.self.key.bias"))]
    errs = {n: max_abs(grads["kernel"][n], g) / max(float(g.abs().max()), 1e-4 * top)
            for n, g in grads["plain"].items() if n not in key_bias}
    worst = max(errs, key=errs.get)
    key_max = max(float(grads[r][n].abs().max()) for r in grads for n in key_bias) / top
    log(f"[joint] ftall 2 layers full width, one micro-step's gradients through K1 + K4 vs the plain path "
        f"({len(errs)} tensors): worst {worst} {errs[worst]:.3e} (bar 1e-4); key biases at most {key_max:.3e} of "
        f"the largest gradient; launches {launched['kernel']}")
    require(errs[worst] <= 1e-4 and key_max <= 1e-4, f"ftall gradients: {worst} {errs[worst]}, key biases {key_max}")
    return {"worst": errs[worst], "tensor": worst, "tensors": len(errs), "key_bias_max": key_max}


# -- phase 15: the information-encoder path (the proto-angular trainers, the timbre perturbation, the legacy
# baselinelike trainers with the x-vector engine) ------------------------------------------------------------------

# the melspec corpus: voiced wavs of 1-3 s, 12 train / 8 dev a class (the melspec stems' C x U = 80 and 64 need 10
# and 32 rows a class or gender); two epochs of each proto stem, the CE stem's dev batches of ce_batch;
# ProtoAngularEngine at C x U = 8 x 4 for one epoch; timings: median of steps steps
INFO_SHAPE = dict(n_train=96, n_dev=64, seconds=(1.0, 3.0), proto_epochs=2, angular_utter=4, steps=5, tp_prob=0.5,
                  grad_rows=64, ce_batch=32)
PROTO_RUNS = ("train_cat_wavlm_lazy_protoangularloss_only", "train_cat_wavlm_lazy_protoangularloss",
              "train_cat_melspec_lazy_protoangularloss_only", "train_cat_melspec_lazy_protoangularloss_only_gender",
              "train_cat_wavlmlarge_lazy_protoangularloss_only_gender")


def write_gender_csv(path: str, label_csv: str) -> str:
    """``FileName,Gender`` for a label CSV's rows: Female / Male by blocks of 8 rows, so each gender holds every class."""
    from interspeech_ser_tpu_torch.utils import labels as L

    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "Gender"]] + [[r["FileName"], ("Female", "Male")[(i // 8) % 2]]
                                                            for i, r in enumerate(L.read_csv(label_csv))])
    return path


def write_info_corpus(tmp: str, train_config: str) -> dict:
    """The melspec stems' seeded voiced wavs (F0 by class) with a label CSV,
    gender CSVs for both corpora (phase 6's features and these wavs), and one
    config a proto stem (phase 6's ``.pt`` dir for the wavlm stems, ``hidden_dim``
    1024 = WavLM-large's width, dev batches of 32 for the CE stem)."""
    from interspeech_ser_tpu_torch.train.proto_engine import STEMS, _PROTO_VARIANTS
    from interspeech_ser_tpu_torch.utils.labels import CLASSES

    shape = INFO_SHAPE
    with open(train_config) as f:
        base = json.load(f)
    rng = np.random.default_rng(SEED + 15)
    wav_dir = os.path.join(tmp, "info_wavs")
    os.makedirs(wav_dir)
    rows = []
    for i in range(shape["n_train"] + shape["n_dev"]):
        cls, name = i % 8, f"info_{i:03d}.wav"
        write_wav(os.path.join(wav_dir, name), prosody_wave(int(rng.uniform(*shape["seconds"]) * 16000), rng,
                                                            90.0 + 20.0 * cls))
        rows.append([name] + [float(c == cls) for c in range(8)]
                    + ["Train" if i < shape["n_train"] else "Development"])
    label_csv = os.path.join(tmp, "info_labels.csv")
    with open(label_csv, "w", newline="") as f:
        csv.writer(f).writerows([["FileName"] + CLASSES + ["Split_Set"]] + rows)
    configs, genders = {}, {}
    for stem in PROTO_RUNS:
        spec = _PROTO_VARIANTS[STEMS[stem]]
        melspec = spec["data"] == "melspec"
        labels = label_csv if melspec else base["label_path"]
        genders[stem] = write_gender_csv(os.path.join(tmp, f"info_gender_{'wav' if melspec else 'pt'}.csv"), labels)
        cfg = {"label_path": labels, "audio_lazy_dir": wav_dir if melspec else base["lazy_dir1"], "wav_dir": wav_dir,
               "epochs": shape["proto_epochs"], "lr": 1e-4, "model_path": os.path.join(tmp, f"info_{stem}"),
               "feat1_dim": base["feat1_dim"], "hidden_dim": base["feat1_dim"], "batch_size": shape["ce_batch"]}
        configs[stem] = os.path.join(tmp, f"info_{stem}.json")
        with open(configs[stem], "w") as f:
            json.dump(cfg, f)
    return {"configs": configs, "genders": genders, "label_csv": label_csv, "wav_dir": wav_dir}


def proto_split(cfg: dict, variant: str, split: str, gender_csv: str, seed: int = SEED):
    """A proto stem's split as ``proto_main`` builds it (the same seeds)."""
    from interspeech_ser_tpu_torch.train import proto_engine as pe

    spec = pe._PROTO_VARIANTS[variant]
    part = [r for r in pe.proto_rows(cfg["label_path"], spec["target"], gender_csv) if r["Split_Set"] == split]
    names, y = [r["FileName"] for r in part], np.asarray([r["target"] for r in part], np.int64)
    if spec["data"] == "melspec":
        return pe.MelspecProtoDataset(names, y, cfg["audio_lazy_dir"], mel_sample_rate=spec.get("mel_sr", 16000),
                                      perturb_prob=spec.get("perturb", 0.0),
                                      seed=seed + (split == "Development"))
    return pe.LazyProtoDataset(names, y, cfg["audio_lazy_dir"])


def proto_batches(labels: np.ndarray, C: int, per_class: int) -> int:
    """Batches a drop_last ``PerfectBatchSampler`` yields: the scarcest class's rows // per_class."""
    return min(int((np.asarray(labels) == c).sum()) // per_class for c in range(C))


class PerturbLog:
    """``fixed_timbre_perturb`` wrapped: calls and how many changed their wav."""

    def __init__(self):
        from interspeech_ser_tpu_torch.train import information_encoder

        self.module, self.real = information_encoder, information_encoder.fixed_timbre_perturb
        self.calls = self.changed = 0

    def __enter__(self):
        def perturb(wav, *args, **kw):
            out = self.real(wav, *args, **kw)
            self.calls += 1
            self.changed += bool(np.abs(np.asarray(out) - np.asarray(wav)).max() > 1e-4)
            return out

        self.module.fixed_timbre_perturb = perturb
        return self

    def __exit__(self, *exc):
        self.module.fixed_timbre_perturb = self.real


def phase_info(tmp: str, train_config: str, baseline_config: str, wavlm_dir: str, joint: dict) -> dict:
    """Phase 15: the five proto stems through ``proto_engine.main`` (two epochs
    each), ``ProtoAngularEngine`` over phase 6's features (one epoch, then
    ``embed``), ``baseline.cli`` ``train_cat_baselinelike_focalloss`` with the
    timbre perturbation and ``train_cat_baselinelike_xvector`` over phase 11's
    corpus and WavLM-large, and one ``joint_cli`` ``large`` epoch with the
    perturbation over phase 14's corpus. Per run: the launches against the
    prediction (K3 once a forward and K3b once a train step of a BiGRU net, no
    kernel for ``ProtoSERNet`` or the x-vector; phase 11's K1 / K4 / K2 for the
    baseline run, phase 14's for the joint one), finite losses, the files, and
    the perturbation changed wavs it drew."""
    from interspeech_ser_tpu_torch import joint_cli
    from interspeech_ser_tpu_torch.baseline import cli as bcli
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.train import proto_engine as pe
    from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
    from interspeech_ser_tpu_torch.utils import labels as L

    shape = INFO_SHAPE
    corpus = write_info_corpus(tmp, train_config)
    runs = {}

    def run(name: str, fn, want: dict) -> dict:
        before = counts()
        t0 = time.perf_counter()
        with PerturbLog() as perturbed:
            out = fn()
        sync()
        seconds = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counts().items()}
        want = {**dict.fromkeys(KERNELS, 0), **want}
        log(f"[info] {name}: {seconds:.2f} s, launches {{{', '.join(f'{k}: {v}' for k, v in got.items() if v)}}} "
            f"(predicted {{{', '.join(f'{k}: {v}' for k, v in want.items() if v)}}}); perturbed {perturbed.changed} "
            f"changed of {perturbed.calls} drawn")
        require(got == want, f"{name}: launches {got} != predicted {want}")
        runs[name] = {"seconds": seconds, "launches": got, "perturbed": perturbed.changed,
                      "perturb_calls": perturbed.calls, "result": out}
        return out

    for stem in PROTO_RUNS:
        variant = pe.STEMS[stem]
        spec = pe._PROTO_VARIANTS[variant]
        with open(corpus["configs"][stem]) as f:
            cfg = json.load(f)
        train = proto_split(cfg, variant, "Train", corpus["genders"][stem])
        val = proto_split(cfg, variant, "Development", corpus["genders"][stem])
        steps = proto_batches(train.labels, spec["C"], spec["U"])
        val_batches = (len(val) // cfg["batch_size"] if spec.get("ce") else proto_batches(val.labels, spec["C"],
                                                                                          spec["U_val"]))
        gru = isinstance(spec["net"](cfg), pe.BidirectionalReferenceEncoder)
        epochs = cfg["epochs"]
        want = {"gru_bidir": epochs * (steps + val_batches), "gru_bidir_bwd": epochs * steps} if gru else {}
        require(steps > 0 and val_batches > 0, f"{stem}: {steps} steps, {val_batches} val batches an epoch")
        best = run(stem, lambda: pe.main([stem, "--config_path", corpus["configs"][stem], "--gender_labels_csv",
                                          corpus["genders"][stem], "--device", DEVICE]), want)
        require(np.isfinite(best["val_angle"]) and best["epoch"] >= 0, f"{stem}: {best}")
        ckpt = os.path.join(cfg["model_path"], "ser.pt" if spec.get("ce") else "angle_ser.pt")
        runs[stem].update(variant=variant, steps=epochs * steps, val_batches=epochs * val_batches, ckpt=ckpt,
                          config=corpus["configs"][stem], gender_csv=corpus["genders"][stem], best=best,
                          keys=len(torch.load(ckpt, weights_only=True)))
        if spec.get("perturb"):
            require(runs[stem]["perturbed"] > 0, f"{stem}: the perturbation changed no wav")

    # ProtoAngularEngine over phase 6's WavLM-large-width features, H = 256 (K3 on a ragged mask)
    with open(train_config) as f:
        tcfg = json.load(f)
    rows = L.read_csv(tcfg["label_path"])
    train_rows = L.split(rows, "Train")
    ds = LazyFeatureDataset(L.column(train_rows, "FileName"), L.matrix(train_rows), [tcfg["lazy_dir1"]],
                            [tcfg["feat1_dim"]])
    class_ids = np.argmax(ds.labels, axis=1)
    angular = pe.ProtoAngularEngine(tcfg["feat1_dim"], utter_per_class=shape["angular_utter"], seed=SEED,
                                    device=DEVICE)
    a_steps = proto_batches(class_ids, 8, shape["angular_utter"])
    a_embed = -(-len(ds) // 16)
    res = run("ProtoAngularEngine", lambda: {"fit": angular.fit(ds, class_ids, epochs=1, lr=1e-4, log=log),
                                             "emb": angular.embed(ds, batch_size=16)},
              {"gru_bidir": a_steps + a_embed, "gru_bidir_bwd": a_steps})
    require(np.isfinite(res["fit"]["loss"]) and res["emb"].shape == (len(ds), 256) and np.isfinite(res["emb"]).all(),
            f"ProtoAngularEngine: {res['fit']}, embeddings {res['emb'].shape}")
    runs["ProtoAngularEngine"].update(steps=a_steps, embed_batches=a_embed, result=res["fit"])

    # the legacy baselinelike trainers over phase 11's corpus and WavLM-large
    with open(baseline_config) as f:
        paths = json.load(f)
    bshape = BASELINE_SHAPE
    n_layers = speech.wavlm_large().num_layers
    micro = -(-bshape["n_train"] // (bshape["batch_size"] // bshape["accumulation_steps"]))
    dev_batches = -(-bshape["n_dev"] // 8)
    legacy = {}
    for stem, extra in (("train_cat_baselinelike_focalloss", {"use_timbre_perturb": True,
                                                                "tp_prob": shape["tp_prob"]}),
                        ("train_cat_baselinelike_xvector", {})):
        cfg = {**paths, "ssl_type": wavlm_dir, "batch_size": bshape["batch_size"],
               "accum_step": bshape["accumulation_steps"], "epochs": 1, "lr": bshape["lr"],
               "model_path": os.path.join(tmp, f"info_{stem}"), "head_dim": bshape["head_dim"],
               "pooling_type": "AttentiveStatisticsPooling", "weight_decay": 1e-2, "dropout_head": 0.5,
               "use_timbre_perturb": False, "tp_prob": 0.0, **extra}
        legacy[stem] = os.path.join(tmp, f"info_{stem}.json")
        with open(legacy[stem], "w") as f:
            json.dump(cfg, f)
        # the baseline's forward: K1 a layer and K2's layer 0 once (train micro-batches and dev batches of 8),
        # K4 a layer per micro-batch's backward; the x-vector launches nothing
        want = ({"attention_btd": n_layers * (micro + dev_batches), "attention_btd_bwd": n_layers * micro,
                 "conv_frontend": micro + dev_batches} if stem.endswith("focalloss") else {})
        best = run(stem, lambda: bcli.main([stem, "--config_path", legacy[stem], "--device", DEVICE]), want)
        require(best["epoch"] == 0 and all(np.isfinite(best["dev_losses"])), f"{stem}: {best}")
        files = ["final_ser.pt", "train_norm_stat.pkl"] + (["final_xvector.pt"] if stem.endswith("xvector")
                                                            else ["final_pool.pt", "final_ssl.pt"])
        require(all(os.path.exists(os.path.join(cfg["model_path"], n)) for n in files), f"{stem}: files {files}")
        runs[stem].update(config=legacy[stem], model_path=cfg["model_path"], best=best)
    require(runs["train_cat_baselinelike_focalloss"]["perturbed"] > 0, "focalloss: the perturbation changed no wav")

    # one joint_cli large epoch with the perturbation over phase 14's corpus
    stem = "train_cat_roberta_wavlm_large"
    with open(joint["configs"][stem]) as f:
        jcfg = {**json.load(f), "use_timbre_perturb": True, "tp_prob": shape["tp_prob"],
                "model_path": os.path.join(tmp, "info_joint_large")}
    jpath = os.path.join(tmp, "info_joint_large.json")
    with open(jpath, "w") as f:
        json.dump(jcfg, f)
    best = run("joint large + timbre", lambda: joint_cli.main([stem, "--config_path", jpath, "--device", DEVICE]),
               joint["runs"][stem]["predicted"])
    require(best["epoch"] == 0 and all(np.isfinite(best["dev_losses"])), f"joint large + timbre: {best}")
    require(runs["joint large + timbre"]["perturbed"] > 0, "joint large: the perturbation changed no wav")
    return {"runs": runs, **corpus}


def check_info_reloads(info: dict) -> dict:
    """Each proto stem's ``angle_ser.pt`` / ``ser.pt`` loaded strictly into a
    fresh net gives the run's best val loss again (1e-5; the perturbed melspec
    stem's val set is read once per earlier epoch first, so that its seeded
    draws reach the best epoch's), and the x-vector run's ``final_ser.pt`` +
    ``final_xvector.pt`` its dev loss (1e-5)."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.engine import labelled_split
    from interspeech_ser_tpu_torch.baseline.xvector_engine import XVectorEngine
    from interspeech_ser_tpu_torch.train import proto_engine as pe
    from interspeech_ser_tpu_torch.utils.labels import CLASSES

    out = {}
    for stem in PROTO_RUNS:
        run = info["runs"][stem]
        spec = pe._PROTO_VARIANTS[run["variant"]]
        with open(run["config"]) as f:
            cfg = json.load(f)
        net = spec["net"](cfg)
        net.load_state_dict(torch.load(run["ckpt"], weights_only=True), strict=True)
        engine = pe.ProtoOnlyEngine(net, spec["C"], spec["U"], spec["U_val"], ce_mode=spec.get("ce", False),
                                    val_batch_size=cfg["batch_size"], device=DEVICE)
        val = proto_split(cfg, run["variant"], "Development", run["gender_csv"])
        score = (lambda: engine.eval_ce(val)[0]) if spec.get("ce") else (lambda: engine.val_angle(val))
        for _ in range(run["best"]["epoch"] if spec.get("perturb") else 0):
            score()  # the perturbation draws of the epochs before the best one
        out[stem] = abs(score() - run["best"]["val_angle"])
    run = info["runs"]["train_cat_baselinelike_xvector"]
    with open(run["config"]) as f:
        cfg = json.load(f)
    engine = XVectorEngine(head_dim=cfg["head_dim"], device=DEVICE)
    engine.load_checkpoints(run["model_path"])
    mean, std = bdata.load_norm_stat(os.path.join(run["model_path"], "train_norm_stat.pkl"))
    train_labs = labelled_split("cat", cfg["label_path"], cfg["wav_dir"], "train").labels
    freq = np.asarray(train_labs).sum(axis=0)
    cw = np.where(freq != 0, len(train_labs) / (len(CLASSES) * np.maximum(freq, 1)), 0.0)
    dev = labelled_split("cat", cfg["label_path"], cfg["wav_dir"], "dev", mean, std)
    out["train_cat_baselinelike_xvector"] = abs(engine.evaluate(dev, cw)["loss"] - run["best"]["loss"])
    log(f"[info] reloaded checkpoints vs the runs' best val / dev losses (bar 1e-5): "
        f"{ {k: float(f'{v:.3e}') for k, v in out.items()} }")
    require(max(out.values()) <= 1e-5, f"reloads: {out}")
    return out


def check_info_steps(info: dict, smi: str) -> dict:
    """One ``BidirectionalReferenceEncoder`` train step at batch 64 (the gender
    stem's C x U, its first train batch) through K3 + K3b against the plain
    path (``BiGRU.forward_scan``) on the card: each gradient within 1e-4 of its
    tensor's largest magnitude (of 1e-3 of the step's largest where smaller);
    then the median train step (forward, backward, optimizer) of each net at
    its run's batch: ``ProtoSERNet`` 1024 -> 512 at C x U = 80, the reference
    encoder at 64, ``StyleEmbeddingNet`` at 32, and the x-vector micro-step
    (8 rows of the longest train wavs)."""
    from interspeech_ser_tpu_torch.baseline import data as bdata
    from interspeech_ser_tpu_torch.baseline.engine import labelled_split
    from interspeech_ser_tpu_torch.baseline.xvector_engine import XVectorEngine
    from interspeech_ser_tpu_torch.ops.gru import BiGRU
    from interspeech_ser_tpu_torch.train import proto_engine as pe
    from interspeech_ser_tpu_torch.train.samplers import PerfectBatchSampler

    out = {}

    def proto_engine_and_batch(stem):
        run = info["runs"][stem]
        spec = pe._PROTO_VARIANTS[run["variant"]]
        with open(run["config"]) as f:
            cfg = json.load(f)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            engine = pe.ProtoOnlyEngine(spec["net"](cfg), spec["C"], spec["U"], spec["U_val"], device=DEVICE)
        train = proto_split(cfg, run["variant"], "Train", run["gender_csv"])
        idxs = next(iter(PerfectBatchSampler(train.labels, range(spec["C"]), spec["C"] * spec["U"], shuffle=False,
                                             drop_last=True)))
        return engine, engine.collate(train, list(idxs))

    engine, (feats, y) = proto_engine_and_batch("train_cat_melspec_lazy_protoangularloss_only_gender")
    require(len(y) == INFO_SHAPE["grad_rows"], f"reference-encoder batch {len(y)}")
    grads, launched = {}, {}
    state = {k: v.clone() for k, v in engine.net.state_dict().items()}
    for route in ("kernel", "plain"):
        engine.net.load_state_dict(state)  # the same running statistics on both routes
        engine.net.zero_grad(set_to_none=True)
        kernel_forward = BiGRU.forward
        if route == "plain":
            BiGRU.forward = BiGRU.forward_scan
        before = counts()
        try:
            engine.train_loss(feats, y).backward()
        finally:
            BiGRU.forward = kernel_forward
        sync()
        launched[route] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        grads[route] = {n: p.grad.detach().clone() for n, p in engine.net.named_parameters()}
    require(launched == {"kernel": {"gru_bidir": 1, "gru_bidir_bwd": 1}, "plain": {}},
            f"reference-encoder gradient check launches {launched}")
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    # a conv bias under a training-mode BatchNorm has a true gradient of 0 (the batch mean takes it out)
    zero = [n for n in grads["plain"] if n.startswith("convs.") and n.endswith(".bias")]
    errs = {n: max_abs(grads["kernel"][n], g) / max(float(g.abs().max()), 1e-3 * top)
            for n, g in grads["plain"].items() if n not in zero}
    worst = max(errs, key=errs.get)
    gru = max(v for n, v in errs.items() if n.startswith("recurrence."))
    zero_max = max(float(grads[r][n].abs().max()) for r in grads for n in zero) / top
    log(f"[info] reference encoder (batch {len(y)}, mel [{feats.shape[1]}, 80], H = 128) one step's gradients, "
        f"K3 + K3b vs the plain path ({len(errs)} tensors): worst {worst} {errs[worst]:.3e}, worst GRU tensor "
        f"{gru:.3e} (bar 1e-4); conv biases at most {zero_max:.3e} of the largest gradient")
    require(errs[worst] <= 1e-4 and zero_max <= 1e-4, f"reference-encoder gradients: {worst} {errs[worst]}, "
                                                      f"conv biases {zero_max}")
    out["grad_rel_err"], out["grad_worst"] = errs[worst], worst

    def timed(name, step):
        times = host_times_ms(step, INFO_SHAPE["steps"])
        out[f"{name}_step_ms"], out[f"{name}_step_ms_runs"] = statistics.median(times), times
        log(f"[info] {name} train step (forward, backward, optimizer; TF32 off): median {statistics.median(times):.3f} "
            f"ms of runs {[round(t, 3) for t in times]} ({smi})")

    def proto_step(engine, feats, y):
        opt = torch.optim.RAdam(engine.net.parameters(), lr=1e-4)

        def step():
            opt.zero_grad(set_to_none=True)
            engine.train_loss(feats, y).backward()
            opt.step()
        return step

    timed("reference_encoder", proto_step(engine, feats, y))
    engine, (feats, y) = proto_engine_and_batch("train_cat_wavlm_lazy_protoangularloss_only")
    timed("proto_ser_net", proto_step(engine, feats, y))
    out["proto_ser_net_frames"] = feats.shape[1]

    # StyleEmbeddingNet: ProtoAngularEngine's step on its first batch
    from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
    from interspeech_ser_tpu_torch.utils import labels as L

    with open(info["configs"]["train_cat_wavlm_lazy_protoangularloss_only"]) as f:
        cfg = json.load(f)
    rows = L.split(L.read_csv(cfg["label_path"]), "Train")
    ds = LazyFeatureDataset(L.column(rows, "FileName"), L.matrix(rows), [cfg["audio_lazy_dir"]], [cfg["feat1_dim"]])
    angular = pe.ProtoAngularEngine(cfg["feat1_dim"], utter_per_class=INFO_SHAPE["angular_utter"], device=DEVICE)
    C, U = angular.num_classes, angular.utter_per_class
    idxs = next(iter(PerfectBatchSampler(np.argmax(ds.labels, 1), range(C), C * U, shuffle=False, drop_last=True)))
    b = ds.collate(list(idxs), C * U)
    f_d, m_d = torch.from_numpy(b.feats[0]).to(DEVICE), torch.from_numpy(b.masks[0]).to(DEVICE)
    y_d = torch.from_numpy(np.argmax(b.labels, 1)).to(DEVICE)
    wb = [torch.nn.Parameter(torch.tensor(10.0, device=DEVICE)), torch.nn.Parameter(torch.tensor(-5.0, device=DEVICE))]
    opts = [torch.optim.AdamW(angular.model.parameters(), lr=1e-4, weight_decay=1e-6),
            torch.optim.AdamW(wb, lr=1e-4, weight_decay=1e-4)]

    def angular_step():
        for o in opts:
            o.zero_grad(set_to_none=True)
        angular.step_loss(f_d, m_d, y_d, wb)[0].backward()
        for o in opts:
            o.step()

    timed("style_embedding", angular_step)

    # the x-vector micro-step: 8 rows of the longest train wavs
    run = info["runs"]["train_cat_baselinelike_xvector"]
    with open(run["config"]) as f:
        cfg = json.load(f)
    xv = XVectorEngine(head_dim=cfg["head_dim"], device=DEVICE)
    train = labelled_split("cat", cfg["label_path"], cfg["wav_dir"], "train")
    longest = list(np.argsort([len(w) for w in train.wav_list], kind="stable")[-8:])
    wb8 = bdata.collate_wav(train, longest, 8)
    opt = torch.optim.AdamW(xv.parameters(), lr=1e-4, weight_decay=1e-2)
    cw = torch.ones(8, device=DEVICE)

    def xvector_step():
        opt.zero_grad(set_to_none=True)
        xv.batch_loss(wb8, cw).backward()
        opt.step()

    timed("xvector", xvector_step)
    out["xvector_seconds"] = wb8.wav.shape[1] / 16000
    return out


T0 = time.perf_counter()


# -- phase 16: the FACodec full decoder and redecoder, and the adapter fine-tune methods --------------------------

# (a) ``n_wavs`` seeded voiced wavs of ``seconds`` through the full decoder and the redecoder; the card against the
# CPU on one clip of ``cpu_seconds``; one train-mode autoencode over ``train_rows`` x ``train_seconds`` at quantizer
# dropout ``quantizer_dropout``; ``spread_codes`` codebook rows of the content and residual banks spread over encoder
# latents; ``decoder`` / ``redecoder``: the modules' constructor arguments (none at full width)
DECODE_SHAPE = dict(n_wavs=8, seconds=10.0, cpu_seconds=2.0, train_rows=4, train_seconds=4.0, quantizer_dropout=0.5,
                    spread_codes=128, decoder={}, redecoder={})
WAV_BAR = 1e-3  # a wav on the card against the CPU's from the same codes, max abs (f32, TF32 off)
# (b) each run: ``rows`` seeded voiced wavs of ``seconds`` (and as many for the dev batch), ``steps`` AdamW steps
# at ``lr`` over the tuned tensors and the head, ``classes`` classes; the gradient check on ``grad_layers``-layer
# full-width copies
ADAPTER_SHAPE = dict(rows=8, seconds=(3.0, 6.0), steps=3, lr=1e-3, classes=4, grad_layers=2)
ADAPTER_RUNS = (("wavlm-base-plus", "adapter"), ("wavlm-base-plus", "adapter_l"),
                ("wavlm-base-plus", "embedding_prompt"), ("wavlm-base-plus", "combined"),
                ("wavlm-large", "adapter"), ("wavlm-large", "combined"))


def facodec_reference_layout(sd: dict, g: torch.Generator, wn) -> dict:
    """A port FACodec decoder or redecoder state dict in the reference's
    ``.bin`` naming: each ``.weight`` that ``wn`` accepts weight-normed
    (``_weight_norm_pair``; g over every dim but 0, a transposed conv's
    input channel), the VQ projections in the ``parametrizations`` key
    style, the convs in the ``weight_g`` one."""
    out = {}
    for k, w in sd.items():
        if k.endswith(".weight") and wn(k):
            style = "param" if k.startswith("quantizer.") else "weight_g"
            out.update({f"{k[:-7]}.{n}": t for n, t in _weight_norm_pair(w, g, style).items()})
        else:
            out[k] = w.clone()
    return out


def seeded_decoders(facodec, g: torch.Generator, seed: int = SEED) -> tuple:
    """A seeded random-init ``FACodecDecoderFull`` and ``FACodecRedecoder``
    (DECODE_SHAPE's widths) on the CPU, beside ``seeded_facodec``'s extractor:
    its prosody VQ is the decoder's prosody bank and its timbre encoder the
    decoder's (one decoder file feeds both, as the reference's does); the
    SnakeBeta parameters drawn; the content and residual banks' first
    codebooks spread over the encoder's latents of seeded waves
    (``spread_codebook``); the redecoder's code embeddings drawn at unit
    scale, a trained model's, not a fresh one's 1e-5 (under which the codes
    would barely move its output)."""
    from interspeech_ser_tpu_torch.models.ns3.facodec_decoder import FACodecDecoderFull, FACodecRedecoder

    torch.manual_seed(seed + 16)
    dec = FACodecDecoderFull(**DECODE_SHAPE["decoder"]).eval()
    red = FACodecRedecoder(**DECODE_SHAPE["redecoder"]).eval()
    rng = np.random.default_rng(seed + 16)
    with torch.no_grad():
        for model in (dec, red):
            for name, prm in model.named_parameters():
                if name.endswith(("act.alpha", "act.beta")):
                    prm.copy_(0.2 * torch.randn(prm.shape, generator=g))
        for emb in (*red.prosody_embs, *red.content_embs, *red.residual_embs):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=g))
        vq = dec.quantizer[0].layers[0]
        vq.in_proj.load_state_dict(facodec.fvq.in_proj.state_dict())
        vq.out_proj.load_state_dict(facodec.fvq.out_proj.state_dict())
        vq._codebook.weight.copy_(facodec.fvq.codebook.weight)
        dec.timbre_encoder.load_state_dict(facodec.timbre_encoder.state_dict())
        waves = [prosody_wave(2 * 16000, rng, rng.uniform(90, 250)).astype(np.float32) for _ in range(2)]
        z = torch.cat([facodec.encoder(torch.from_numpy(w)[None])[0] for w in waves])
        for bank in dec.quantizer[1:]:
            layer = bank.layers[0]
            spread_codebook(layer._codebook.weight, layer.in_proj(z), DECODE_SHAPE["spread_codes"])
    return dec, red


def write_facodec_decoder_checkpoints(out_dir: str, seed: int = SEED) -> tuple:
    """``seeded_facodec``'s encoder, and ``seeded_decoders``' decoder and
    redecoder, as reference-named ``.bin`` files -> (encoder, decoder,
    redecoder paths). The decoder file carries phase 10's prosody subset
    (``melspec_*``, ``quantizer.0.*``, ``timbre_encoder.*``) and every key
    the full loader reads: the three VQ banks with weight-normed
    projections, ``timbre_linear``, the HiFiGAN ``model.*`` with
    weight-normed convs; the redecoder's ``model.*`` likewise."""
    facodec, g = seeded_facodec(seed)
    enc, _ = facodec_reference_state_dicts(facodec, g)
    dec, red = seeded_decoders(facodec, g, seed)
    full = {k: v.clone() for k, v in facodec.state_dict().items()
            if k.startswith(("melspec_linear.", "melspec_encoder."))}
    full.update(facodec_reference_layout(
        dec.state_dict(), g, lambda k: k.startswith("model.") or k.startswith("quantizer.") and "_proj." in k))
    red_sd = facodec_reference_layout(red.state_dict(), g, lambda k: k.startswith("model."))
    os.makedirs(out_dir, exist_ok=True)
    paths = tuple(os.path.join(out_dir, n) for n in
                  ("ns3_facodec_encoder_v2.bin", "ns3_facodec_decoder_v2_full.bin", "ns3_facodec_redecoder.bin"))
    for sd, path in zip((enc, full, red_sd), paths):
        torch.save(sd, path)
    return paths


def bank_clear_frames(dec, content: torch.Tensor, prosody: torch.Tensor) -> np.ndarray:
    """[6, B, T]: where each quantizer's code is clear of a near tie
    (``vq_top2_gap`` > VQ_MARGIN on that stage's own input) at its stage and
    at every stage its input depends on (the earlier stages of its bank; for
    the residual bank, all of the prosody and content banks')."""
    inputs = (prosody, content)
    clear, bank_ok, quantized = [], [], []
    with torch.inference_mode():
        for b, bank in enumerate(dec.quantizer):
            r = inputs[b] if b < 2 else content - (quantized[0] + quantized[1])
            run = np.ones(r.shape[:2], bool) if b < 2 else bank_ok[0] & bank_ok[1]
            q_sum = torch.zeros_like(r)
            for layer in bank.layers:
                run = run & (vq_top2_gap(r, layer) > VQ_MARGIN)
                clear.append(run)
                q, _, _ = layer(r)
                r, q_sum = r - q, q_sum + q
            bank_ok.append(run)
            quantized.append(q_sum)
    return np.stack(clear)


def phase_decoder(tmp: str, smi: str) -> dict:
    """(a) The FACodec full decoder and redecoder at full width, f32, TF32 off,
    from seeded reference-named ``.bin`` files through the loaders: content
    latents from the encoder, prosody latents from the extractor,
    ``quantize_v2`` -> codes -> ``codes_to_wav``; decoding the quantized
    latents equals decoding the codes (1e-5); wavs [B, L] within [-1, 1];
    the redecoder under the rolled speaker embeddings differs from under the
    batch's own, ``use_residual`` changes both outputs; one clip's codes on
    the card equal the CPU's where clear of a near tie and its wavs from the
    CPU's codes within WAV_BAR; one train-mode autoencode with quantizer
    dropout drawn from a CPU generator: a finite gradient on every parameter,
    its VQ losses within 1e-5 relative of the CPU's. Decode and redecode ms a
    batch, utt/s, peak memory, a profile."""
    from interspeech_ser_tpu_torch.models.loader import (build_facodec_decoder, build_facodec_redecoder,
                                                         build_prosody_extractor)

    shape = DECODE_SHAPE
    set_tf32(False)
    t0 = time.perf_counter()
    paths = write_facodec_decoder_checkpoints(os.path.join(tmp, "facodec_full"))
    extractor = build_prosody_extractor(paths[1], paths[0], with_speaker=True)
    dec = build_facodec_decoder(paths[1], **shape["decoder"])
    red = build_facodec_redecoder(paths[2], **shape["redecoder"])
    out = {"write_s": time.perf_counter() - t0,
           "file_mb": {os.path.basename(p): os.path.getsize(p) / 1e6 for p in paths}}
    cpu_extractor, cpu_dec, cpu_red = (copy.deepcopy(m) for m in (extractor, dec, red))
    extractor, dec, red = (m.to(DEVICE) for m in (extractor, dec, red))
    rng = np.random.default_rng(SEED + 16)
    n = int(shape["seconds"] * 16000)
    waves = np.stack([prosody_wave(n, rng, rng.uniform(90, 250)) for _ in range(shape["n_wavs"])]).astype(np.float32)
    wav = torch.from_numpy(waves).to(DEVICE)
    with torch.inference_mode():
        content = extractor.encoder(wav)
        prosody = extractor.prosody_latents(wav)
        quantized, codes, _ = dec.quantize_v2(content, prosody)
        spk = dec.speaker_embedding(content)
        wav_q = dec.decode(quantized, spk)
        wav_c = dec.codes_to_wav(codes, spk)
        wav_nores = dec.codes_to_wav(codes, spk, use_residual=False)
        red_own = red(codes, spk)
        red_roll = red(codes, spk.roll(1, dims=0))
        red_res = red(codes, spk, use_residual=True)
    sync()
    B = shape["n_wavs"]
    for name, w in (("decode", wav_c), ("redecode", red_own)):
        require(tuple(w.shape) == (B, n), f"{name}: shape {tuple(w.shape)}, want {(B, n)}")
        require(bool(torch.isfinite(w).all()) and float(w.abs().max()) <= 1.0, f"{name}: values outside [-1, 1]")
    out["max_abs"] = {"quantized_vs_codes": max_abs(wav_q, wav_c), "decode_residual": max_abs(wav_c, wav_nores),
                      "redecode_rolled_speaker": max_abs(red_own, red_roll),
                      "redecode_residual": max_abs(red_own, red_res)}
    out["distinct_codes"] = [len(torch.unique(c)) for c in codes]
    out["wav_rms"] = float(wav_c.square().mean().sqrt())
    log(f"[decoder] {B} x {shape['seconds']:g} s: codes {tuple(codes.shape)} (distinct per quantizer "
        f"{out['distinct_codes']}), wav {tuple(wav_c.shape)} rms {out['wav_rms']:.4f}; decode from the quantized "
        f"latents vs from the codes: max_abs {out['max_abs']['quantized_vs_codes']:.3e} (bar 1e-5); use_residual "
        f"off changes the decode by {out['max_abs']['decode_residual']:.3e}, on changes the redecode by "
        f"{out['max_abs']['redecode_residual']:.3e}; the rolled speakers change the redecode by "
        f"{out['max_abs']['redecode_rolled_speaker']:.3e}")
    require(out["max_abs"]["quantized_vs_codes"] <= 1e-5, f"decode(quantized) vs codes_to_wav: {out['max_abs']}")
    for key in ("decode_residual", "redecode_rolled_speaker", "redecode_residual"):
        require(out["max_abs"][key] > 1e-4, f"{key}: the outputs do not differ ({out['max_abs'][key]})")
    del wav_q, wav_nores, red_roll, red_res

    def decode():
        with torch.inference_mode():
            dec.codes_to_wav(codes, spk)

    def redecode():
        with torch.inference_mode():
            red(codes, spk)

    out["decode_ms_runs"], out["redecode_ms_runs"] = host_times_ms(decode, 3), host_times_ms(redecode, 3)
    out["decode_ms"], out["redecode_ms"] = (statistics.median(out[f"{k}_ms_runs"]) for k in ("decode", "redecode"))
    out["decode_utt_per_sec"] = B / out["decode_ms"] * 1e3
    out["redecode_utt_per_sec"] = B / out["redecode_ms"] * 1e3
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for name, fn in (("decode", decode), ("redecode", redecode)):
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
            out[f"{name}_profile"] = {
                "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"[decoder] codes_to_wav of {B} x {shape['seconds']:g} s: median {out['decode_ms']:.1f} ms "
        f"({out['decode_utt_per_sec']:.2f} utt/s), redecoder {out['redecode_ms']:.1f} ms "
        f"({out['redecode_utt_per_sec']:.2f} utt/s), runs {[round(t, 1) for t in out['decode_ms_runs']]} / "
        f"{[round(t, 1) for t in out['redecode_ms_runs']]} ({smi})")
    for name in ("decode", "redecode"):
        prof = out.get(f"{name}_profile")
        if prof:
            log(f"[decoder] {name} profile: device busy {prof['device_busy_ms']:.1f} ms, peak device memory "
                f"{prof['peak_gb']:.2f} GB")
            for op, ms, count in prof["top"]:
                log(f"[decoder]   {ms:9.3f} ms  x{count:<4d} {op}")

    # one clip on the card and on the CPU, the same weights
    m = int(shape["cpu_seconds"] * 16000)
    clip = torch.from_numpy(waves[:1, :m])
    runs = {}
    for where, (ex, de) in (("card", (extractor, dec)), ("cpu", (cpu_extractor, cpu_dec))):
        x = clip.to(DEVICE if where == "card" else "cpu")
        with torch.inference_mode():
            c, p = ex.encoder(x), ex.prosody_latents(x)
            _, cd, _ = de.quantize_v2(c, p)
            runs[where] = (c.cpu(), p.cpu(), cd.cpu(), de.speaker_embedding(c).cpu())
    c_cpu, p_cpu, codes_cpu, spk_cpu = runs["cpu"]
    clear = torch.from_numpy(bank_clear_frames(cpu_dec, c_cpu, p_cpu))
    agree = bool((runs["card"][2] == codes_cpu)[clear].all())
    with torch.inference_mode():
        w_card = dec.codes_to_wav(codes_cpu.to(DEVICE), spk_cpu.to(DEVICE)).cpu()
        r_card = red(codes_cpu.to(DEVICE), spk_cpu.to(DEVICE)).cpu()
        w_cpu, r_cpu = cpu_dec.codes_to_wav(codes_cpu, spk_cpu), cpu_red(codes_cpu, spk_cpu)
    out["cpu"] = {"latents_max_abs": max(max_abs(runs["card"][0], c_cpu), max_abs(runs["card"][1], p_cpu)),
                  "speaker_max_abs": max_abs(runs["card"][3], spk_cpu), "near_tie_codes": int((~clear).sum()),
                  "codes_differing": int((runs["card"][2] != codes_cpu).sum()), "codes": codes_cpu.numel(),
                  "decode_max_abs": max_abs(w_card, w_cpu), "redecode_max_abs": max_abs(r_card, r_cpu)}
    log(f"[decoder] one {shape['cpu_seconds']:g}-s clip, {DEVICE} vs the CPU: latents max_abs "
        f"{out['cpu']['latents_max_abs']:.3e}, speaker embedding {out['cpu']['speaker_max_abs']:.3e}; codes "
        f"differing {out['cpu']['codes_differing']} of {out['cpu']['codes']} ({out['cpu']['near_tie_codes']} within "
        f"{VQ_MARGIN} of a tie, left out); from the CPU's codes: decode max_abs {out['cpu']['decode_max_abs']:.3e}, "
        f"redecode {out['cpu']['redecode_max_abs']:.3e} (bar {WAV_BAR})")
    require(agree, f"decoder codes on the card differ from the CPU's away from a near tie: {out['cpu']}")
    require(out["cpu"]["decode_max_abs"] <= WAV_BAR and out["cpu"]["redecode_max_abs"] <= WAV_BAR,
            f"decoder wavs card vs CPU: {out['cpu']}")

    # one train-mode autoencode, quantizer dropout drawn from a CPU generator
    rows, mt = shape["train_rows"], int(shape["train_seconds"] * 16000)
    for model in (dec, cpu_dec):
        for bank in model.quantizer:
            bank.quantizer_dropout = shape["quantizer_dropout"]
    with torch.no_grad():
        x = extractor.encoder(torch.from_numpy(waves[:rows, :mt]).to(DEVICE))
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    wav_t, _, losses = dec(x, train=True, generator=torch.Generator().manual_seed(SEED))
    (wav_t.square().mean() + losses.sum()).backward()
    sync()
    train_ms = (time.perf_counter() - t1) * 1e3
    bad = [n for n, p in dec.named_parameters() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    with torch.no_grad():
        _, _, cpu_losses = cpu_dec.quantize(x.cpu(), train=True, generator=torch.Generator().manual_seed(SEED))
    rel = float(((losses.detach().cpu() - cpu_losses).abs() / cpu_losses.abs().clamp_min(1e-30)).max())
    out["train"] = {"ms": train_ms, "vq_losses": losses.detach().cpu().tolist(), "vq_loss_rel_err": rel,
                    "params": sum(1 for _ in dec.parameters()), "without_finite_grad": bad,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None}
    log(f"[decoder] train-mode autoencode of {rows} x {shape['train_seconds']:g} s, quantizer dropout "
        f"{shape['quantizer_dropout']}: forward + backward {train_ms:.1f} ms, peak {out['train']['peak_gb']} GB; "
        f"{out['train']['params'] - len(bad)} of {out['train']['params']} parameters with a finite gradient; VQ "
        f"losses {[round(v, 6) for v in out['train']['vq_losses']]} vs the CPU's: worst relative {rel:.3e} (bar 1e-5)")
    require(not bad, f"decoder parameters without a finite gradient: {bad[:5]}")
    require(rel <= 1e-5, f"train-mode VQ losses card vs CPU: {rel}")
    out["phase_s"] = time.perf_counter() - t0
    return out


def adapter_corpus(seed: int) -> tuple:
    """ADAPTER_SHAPE's seeded voiced waves (F0 by class) -> (waves, labels)."""
    shape = ADAPTER_SHAPE
    rng = np.random.default_rng(seed)
    labels = np.arange(shape["rows"]) % shape["classes"]
    waves = [prosody_wave(int(rng.uniform(*shape["seconds"]) * 16000), rng, 90.0 + 30.0 * c).astype(np.float32)
             for c in labels]
    return waves, labels


def adapter_batch(waves, labels, do_normalize: bool) -> tuple:
    """(wav, mask, y) on the device, padded as the LoRA engine pads."""
    from interspeech_ser_tpu_torch.train.lora_engine import pad_batch
    from interspeech_ser_tpu_torch.utils.audio import normalize_waveform

    wav, mask = pad_batch([normalize_waveform(w, do_normalize) for w in waves], len(waves))
    return (torch.from_numpy(wav).to(DEVICE), torch.from_numpy(mask).to(DEVICE),
            torch.from_numpy(np.asarray(labels)).long().to(DEVICE))


def predict_adapter_launches(method: str, layers: int, layer_norm_frontend: bool, steps: int) -> dict:
    """One run's launches: K1 once a layer a forward (the steps', the dev
    batch's and, for ``adapter`` / ``adapter_l``, the identity check's two);
    K4 once a step on each layer whose attention input needs a gradient:
    every layer under prompts, all but layer 0 (whose input is the frozen
    features) under adapters alone; K2 once a forward of a layer-norm
    frontend; nothing else (training leaves K8's ``inference_kernels`` off)."""
    forwards = steps + 1 + (2 if method in ("adapter", "adapter_l") else 0)
    k4_layers = layers if method in ("embedding_prompt", "combined") else layers - 1
    return {"attention_btd": layers * forwards, "attention_btd_bwd": steps * k4_layers,
            "conv_frontend": forwards if layer_norm_frontend else 0}


def phase_adapters(tmp: str, smi: str) -> tuple:
    """(b) ``lora_model.build_wavlm_wrapper`` over phase 9's wavlm-base-plus
    (post-LN, group-norm frontend) with each non-LoRA method and over phase
    4's WavLM-large (pre-LN, K2) with ``adapter`` and ``combined``, f32:
    fresh ``adapter`` / ``adapter_l`` against the base encoder's hidden states
    (1e-5), ADAPTER_SHAPE's AdamW steps over the tuned tensors and the head
    (the base weights bit for bit unchanged, every tuned tensor moved), a dev
    batch through ``EvalMetric``, each run's launches against
    ``predict_adapter_launches`` -> (results, the trained embedding_prompt
    wrapper and its batch)."""
    from interspeech_ser_tpu_torch.lora_evaluation import EvalMetric
    from interspeech_ser_tpu_torch.lora_model import build_wavlm_wrapper
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder

    shape = ADAPTER_SHAPE
    set_tf32(False)
    train, dev = adapter_corpus(SEED + 17), adapter_corpus(SEED + 18)
    out, kept = {"runs": {}}, None
    for model_name in dict.fromkeys(d for d, _ in ADAPTER_RUNS):
        model_dir, base = os.path.join(tmp, model_name), None
        for method in (m for d, m in ADAPTER_RUNS if d == model_name):
            before = counts()
            t0 = time.perf_counter()
            w = build_wavlm_wrapper(model_dir, method, seed=SEED, device=DEVICE)
            cfg = w.encoder.config
            wav, mask, y = adapter_batch(*train, w.do_normalize)
            run = {"build_s": time.perf_counter() - t0, "layers": cfg.num_layers, "tuned": len(w.finetune),
                   "lora": len(w.lora)}
            if method in ("adapter", "adapter_l"):
                if base is None:
                    base = build_speech_encoder(model_dir)[0].to(DEVICE)
                with torch.inference_mode():
                    got, ref = w.hidden_states(wav, mask)["hidden_states"], base(wav, mask)["hidden_states"]
                run["identity_max_abs"] = max(max_abs(a, b) for a, b in zip(got, ref))
                del got, ref
                require(run["identity_max_abs"] <= 1e-5, f"{model_name} {method} at init vs the base encoder: "
                                                         f"{run['identity_max_abs']}")
            frozen = {n: p.detach().clone() for n, p in w.encoder.named_parameters() if not p.requires_grad}
            tuned = [t.detach().clone() for t in w.trainable()]
            opt = torch.optim.AdamW(w.trainable(), lr=shape["lr"])
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            w.head.train()
            run["step_ms_runs"], run["losses"] = [], []
            for _ in range(shape["steps"]):
                t1 = time.perf_counter()
                opt.zero_grad(set_to_none=True)
                loss = torch.nn.functional.cross_entropy(w.forward(wav, mask, gen), y)
                loss.backward()
                opt.step()
                sync()
                run["step_ms_runs"].append((time.perf_counter() - t1) * 1e3)
                run["losses"].append(loss.item())
            run["step_ms"] = statistics.median(run["step_ms_runs"])
            w.head.eval()
            dwav, dmask, dy = adapter_batch(*dev, w.do_normalize)
            with torch.inference_mode():
                logits = w.forward(dwav, dmask)
                dev_loss = torch.nn.functional.cross_entropy(logits, dy).item()
            metric = EvalMetric(shape["classes"])
            metric.append_classification_results(dy.cpu().numpy(), logits.argmax(1).cpu().numpy(), dev_loss)
            summary = metric.classification_summary()
            run["dev"] = {"acc": summary["acc"], "uar": summary["uar"], "loss": summary["loss"],
                          "conf": summary["conf"].tolist()}
            run["launches"] = {k: v - before[k] for k, v in counts().items()}
            run["predicted"] = predict_adapter_launches(method, cfg.num_layers, cfg.feat_extract_norm == "layer",
                                                        shape["steps"])
            run["base_unchanged"] = all(torch.equal(p, frozen[n]) for n, p in w.encoder.named_parameters()
                                        if not p.requires_grad)
            run["tuned_moved"] = sum(not torch.equal(a, b) for a, b in zip(w.trainable(), tuned))
            run["trainable"] = len(tuned)
            run["seconds"] = time.perf_counter() - t0
            log(f"[adapters] {model_name} {method}: {run['tuned']} adapter / prompt tensors, {run['lora']} LoRA "
                f"pairs; step median {run['step_ms']:.1f} ms of {[round(t, 1) for t in run['step_ms_runs']]} "
                f"({shape['rows']} rows of {shape['seconds'][0]:g}-{shape['seconds'][1]:g} s, f32; {smi}); "
                f"losses {[round(v, 4) for v in run['losses']]}; dev acc {run['dev']['acc']:.3f} uar "
                f"{run['dev']['uar']:.3f} loss {run['dev']['loss']:.4f}; launches {run['launches']} (predicted "
                f"{run['predicted']}); identity at init {run.get('identity_max_abs', 'n/a')}; {run['seconds']:.1f} s")
            require(all(np.isfinite(run["losses"])), f"{model_name} {method}: losses {run['losses']}")
            require(run["base_unchanged"], f"{model_name} {method}: a base weight changed")
            require(run["tuned_moved"] == run["trainable"],
                    f"{model_name} {method}: {run['tuned_moved']} of {run['trainable']} tuned tensors moved")
            require(all(run["launches"][k] == run["predicted"].get(k, 0) for k in KERNELS),
                    f"{model_name} {method}: launches {run['launches']} != predicted {run['predicted']}")
            out["runs"][f"{model_name}/{method}"] = run
            if method == "embedding_prompt":
                kept = (w, (wav, mask))
            del w, frozen, tuned, opt
        del base
    return out, kept


def check_adapter_grads(tmp: str) -> dict:
    """``combined`` (LoRA on the FFN, ``adapter_l`` and prompts) on
    ADAPTER_SHAPE's ``grad_layers``-layer full-width copies of WavLM-large and
    wavlm-base-plus, the adapters' ``up`` and the LoRA B drawn non-zero: one
    step's gradients of every tuned tensor through K1 + K4 (K4 once a layer)
    against the plain path (none). The loss is a smooth probe of the hidden
    states (each state's masked time-mean against a seeded vector), not the
    head's cross entropy: a ReLU whose input lies within the routes' ~3e-6
    of 0 takes another branch on each route, and the head's frame-level
    ReLUs (rows x frames x 256 units) hold enough such units to move every
    upstream gradient by 1e-3. An adapter's own ReLU can flip too: its
    ``down`` tensors are held to the bar only where no unit flipped (the
    flips are counted and reported). Bar: per tensor max|g_kernel -
    g_plain| <= 1e-4 x max|g_plain| -> the worst ratio per model."""
    from interspeech_ser_tpu_torch.lora_model import build_wavlm_wrapper
    from interspeech_ser_tpu_torch.models.speech import Adapter

    layers = ADAPTER_SHAPE["grad_layers"]
    wavs, labels = adapter_corpus(SEED + 17)
    out = {}
    for name in ("wavlm-large", "wavlm-base-plus"):
        copy_dir = os.path.join(tmp, f"{name}-{layers}layers-adapters")
        write_wavlm_layers(os.path.join(tmp, name), copy_dir, layers)
        w = build_wavlm_wrapper(copy_dir, "combined", seed=SEED, device=DEVICE)
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for n, p in w.finetune.items():
                if ".up." in n:
                    p.copy_(0.01 * torch.randn(p.shape, generator=gen))
            for pair in w.lora.values():
                pair["lora_B"].copy_(0.01 * torch.randn(pair["lora_B"].shape, generator=gen))
        probe = torch.randn(layers + 1, w.encoder.config.hidden_size, generator=gen).to(DEVICE)
        names = [f"{k}.{leaf}" for k, pair in w.lora.items() for leaf in pair] + list(w.finetune)
        tuned = [t for pair in w.lora.values() for t in pair.values()] + list(w.finetune.values())
        wav, mask, _ = adapter_batch(wavs, labels, w.do_normalize)
        signs = {}
        hooks = [mod.down.register_forward_hook(
            lambda m, i, o, key=key: signs.setdefault(key, []).append(o.detach() > 0))
            for key, mod in w.encoder.named_modules() if isinstance(mod, Adapter)]
        grads = {}
        for route in ("kernel", "plain"):
            before = counts()["attention_btd_bwd"]
            hs = w.hidden_states(wav, mask, plain=route == "plain")
            m = hs["frame_mask"]
            loss = sum(((h.float() * m[:, :, None]).sum(1) / m.sum(1, keepdim=True) @ r).sum()
                       for h, r in zip(hs["hidden_states"], probe))
            grads[route] = torch.autograd.grad(loss, tuned)
            sync()
            launched = counts()["attention_btd_bwd"] - before
            require(launched == (layers if route == "kernel" else 0), f"{name} {route}: {launched} K4 launches")
        for h in hooks:
            h.remove()
        flips = {key: int((a[0] != a[1]).sum()) for key, a in signs.items()}
        errs = {n: max_abs(a, b) / max(float(b.abs().max()), 1e-30)
                for n, a, b in zip(names, grads["kernel"], grads["plain"])}
        flipped = {n for n in errs if any(n.startswith(f"{key}.down.") for key, f in flips.items() if f)}
        held = {n: e for n, e in errs.items() if n not in flipped}
        out[name] = {"worst": max(held.values()), "tensors": len(held), "relu_flips": flips,
                     "flipped_down_errs": {n: errs[n] for n in flipped}}
        log(f"[adapters] {name} {layers} layers full width, combined: one step's gradients through K1 + K4 vs the "
            f"plain path: worst {out[name]['worst']:.3e} over {len(held)} tensors (bar 1e-4); adapter ReLU units "
            f"on the other branch {flips} of {sum(a[0].numel() for a in signs.values())}, their down tensors "
            f"{ {n: f'{e:.2e}' for n, e in out[name]['flipped_down_errs'].items()} }")
        require(out[name]["worst"] <= 1e-4, f"{name} adapter gradients: relative error {out[name]} > 1e-4")
        require(sum(flips.values()) <= 1e-4 * sum(a[0].numel() for a in signs.values()),
                f"{name}: {flips} adapter ReLU units flipped between the routes")
        del w, grads
    return out


def check_prompt_batch1(tmp: str, kept) -> dict:
    """``embedding_prompt``: each row of a padded batch against its batch-1
    forward, last hidden state over the valid frames (bar 1e-4). On the
    ``grad_layers``-layer copy of WavLM-large (layer-norm frontend) the rows
    run unpadded; on the trained wavlm-base-plus wrapper each row runs padded
    alone to the batch's length, as its GroupNorm frontend normalises over the
    padded sequence (in both packages, as in HF's base models)."""
    from interspeech_ser_tpu_torch.lora_model import build_wavlm_wrapper

    layers = ADAPTER_SHAPE["grad_layers"]
    wavs, labels = adapter_corpus(SEED + 17)
    w_large = build_wavlm_wrapper(os.path.join(tmp, f"wavlm-large-{layers}layers-adapters"), "embedding_prompt",
                                  seed=SEED, device=DEVICE)
    out = {}
    for name, w, (wav, mask), unpadded in (
            ("wavlm-large", w_large, adapter_batch(wavs, labels, w_large.do_normalize)[:2], True),
            ("wavlm-base-plus", kept[0], kept[1], False)):
        errs = []
        with torch.inference_mode():
            batched = w.hidden_states(wav, mask)
            for i in range(wav.shape[0]):
                n = int(mask[i].sum())
                one = w.hidden_states(wav[i:i + 1, :n]) if unpadded else w.hidden_states(wav[i:i + 1], mask[i:i + 1])
                t = int(one["frame_mask"][0].sum())
                errs.append(max_abs(batched["last_hidden_state"][i, :t], one["last_hidden_state"][0, :t]))
        out[name] = max(errs)
        log(f"[adapters] {name} embedding_prompt: padded batch of {wav.shape[0]} vs batch-1 "
            f"({'unpadded' if unpadded else 'each row padded alone'}): max_abs {out[name]:.3e} (bar 1e-4)")
        require(out[name] <= 1e-4, f"{name} embedding_prompt batch vs batch-1: {out[name]}")
    return out


# -- phase 17: the multi-device surface ------------------------------------------

# a world of 2 ranks (gloo on one shared card, NCCL one card a rank where there
# are 2), extraction batches at a 24-s token budget (several batches for the
# data-parallel leg), 8 of phase 7's wavs at batch 4 (2 LoRA steps)
PARALLEL_SHAPE = dict(world=2, budget_seconds=24, lora_rows=8, lora_batch=4, lora_dev=2)
LAUNCHING = True  # phase 17 holds the ranks' launch counts to their predictions (on the card)


def predict_parallel_launches(what: str, rank: int, world: int, **n) -> dict:
    """The kernel launches one rank of a ``world``-rank data axis makes (the
    model axis's ranks all run every batch): ``fusion`` (``n_mod``,
    ``train_batches``, ``dev_batches``: every rank runs its rows of every
    batch, so its counts are the one-process counts), ``dp_extract`` (whole
    batches ``rank``, ``rank + world``, ... of ``batches``, ``layers``),
    ``tp_extract`` (every batch on every model rank), ``lora`` (``layers``,
    ``steps``, ``dev_batches``). K2 runs its layer-0 kernel once a forward."""
    if what == "fusion":
        return {"gru_bidir": n["n_mod"] * (n["train_batches"] + n["dev_batches"]),
                "gru_bidir_bwd": n["n_mod"] * n["train_batches"]}
    if what in ("dp_extract", "tp_extract"):
        mine = len(range(rank, n["batches"], world)) if what == "dp_extract" else n["batches"]
        return {"attention_btd": n["layers"] * mine, "conv_frontend": mine, "pos_conv": mine}
    if what == "lora":
        forwards = n["steps"] + n["dev_batches"]
        return {"attention_btd": n["layers"] * forwards, "attention_btd_bwd": n["layers"] * n["steps"],
                "conv_frontend": forwards}
    raise ValueError(what)


def expected_audit(what: str, **n) -> dict:
    """{op: (count, elements)} of one rank's run (``None``: any; an op not
    listed: none): a data-parallel trainer all-reduces its trainable
    elements once a step (``steps``, ``trainable``), gathers the outputs its
    loss reads and broadcasts rank 0's parameters when it starts;
    data-parallel extraction sums its 4 stats once; tensor parallelism
    all-reduces twice a layer a batch (``layers``, ``batches``); one rank
    issues nothing."""
    if what == "one_rank":
        return {}
    if what == "train":
        return {"all-reduce": (n["steps"], n["steps"] * n["trainable"]), "all-gather": (None, None),
                "broadcast": (None, None)}
    if what == "dp_extract":
        return {"all-reduce": (1, 4)}
    if what == "tp_extract":
        return {"all-reduce": (2 * n["layers"] * n["batches"], None)}
    raise ValueError(what)


def check_audit(rec: dict, want: dict, what: str) -> None:
    line = audit.audit_line(rec)
    for op, r in rec.items():
        count, elements = want.get(op, (0, 0))
        require((count is None or r["count"] == count) and (elements is None or r["elements"] == elements),
                f"{what}: {line}, want {op} {count} x {elements} elems")
    if not want:
        require(line == "collectives: NONE", f"{what}: {line}")


def parallel_runs(job: dict, rank_heads: bool = False) -> dict:
    """Phase 17's runs on this process's mesh (a rank of the spawned world,
    or the one process): (a) one fusion epoch, (b) WavLM-large extraction
    through ``speech_main`` at the default budget (bf16, f32) and through the
    pipeline at the 24-s budget (f32), (c) with ``rank_heads`` the TP=2 f32
    extraction, (d) 2 LoRA steps -> each run's result, launch counts, audit
    and seconds."""
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models import speech
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder
    from interspeech_ser_tpu_torch.preprocess_cli import speech_main
    from interspeech_ser_tpu_torch.train import engine as E
    from interspeech_ser_tpu_torch.train.lora_engine import LoRAFTEngine
    from interspeech_ser_tpu_torch.utils import labels as L
    from interspeech_ser_tpu_torch.utils.audio import load_wav
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    dev, tag = job["device"], job["tag"]
    out = {}

    def run(name, fn):
        zero_counts()
        t0 = time.perf_counter()
        with audit.collective_audit() as rec:
            res = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[name] = {**res, "launches": counts(), "audit": rec, "seconds": time.perf_counter() - t0}

    def fusion():
        cfg = dataclasses.replace(load_fusion_config(job["config_path"]), epochs=1,
                                  model_path=os.path.join(job["tmp"], f"parallel_fusion_{tag}"))
        rows = L.load_merged(cfg.label_path, cfg.txt_dir)
        eng = E.FusionEngine(cfg, seed=SEED, device=dev)
        f1s, losses, ends = [], [], []
        evaluate, accumulate, apply = eng.evaluate, eng.accumulate_gradients, eng.apply_gradients
        eng.evaluate = lambda *a, **kw: (lambda r: f1s.append(r["macro_f1"]) or r)(evaluate(*a, **kw))
        eng.accumulate_gradients = lambda *a, **kw: (lambda r: losses.append(float(r[0])) or r)(accumulate(*a, **kw))

        def timed_apply(*a, **kw):
            apply(*a, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            ends.append(time.perf_counter())
        eng.apply_gradients = timed_apply
        t0 = time.perf_counter()
        eng.fit(L.split(rows, "Train"), L.split(rows, "Development"))
        steps_ms = [1e3 * (b - a) for a, b in zip([t0] + ends[:-1], ends)]
        return {"f1": f1s, "losses": losses, "step_ms": steps_ms, "trainable": audit.param_elements(eng.model),
                "params": {k: v.detach().cpu() for k, v in eng.model.state_dict().items()},
                "train_batches": len(losses), "dev_batches": -(-len(L.split(rows, "Development")) // cfg.batch_size),
                "n_mod": len(cfg.feat_dims)}

    def cli_extract(dtype):
        def fn():
            save = os.path.join(job["tmp"], f"parallel_{dtype}_{tag}")
            stats = speech_main(["--ssl_type", job["model_dir"], "--wav_dir", job["wav_dir"], "--save_path", save,
                                 "--dtype", dtype, "--device", dev])
            return {"save": save, "stats": dataclasses.asdict(stats)}
        return fn

    def pipeline_extract(model_parallel):
        def fn():
            heads = []
            real = speech.dot_product_attention_btd
            speech.dot_product_attention_btd = lambda q, k, v, H, **kw: (heads.append(H), real(q, k, v, H, **kw))[1]
            try:
                model, cfg, do_norm = build_speech_encoder(job["model_dir"], dtype="float32")
                budget = None if model_parallel > 1 else 16000 * PARALLEL_SHAPE["budget_seconds"]
                pipe = SpeechExtractionPipeline(model, cfg, do_normalize=do_norm, token_budget=budget, device=dev,
                                                model_parallel=model_parallel)
                save = os.path.join(job["tmp"], f"parallel_{'tp' if model_parallel > 1 else 'dp'}_{tag}")
                stats = pipe.run(job["wav_dir"], save)
            finally:
                speech.dot_product_attention_btd = real
            return {"save": save, "stats": dataclasses.asdict(stats), "heads": sorted(set(heads)),
                    "layers": cfg.num_layers, "num_heads": cfg.num_heads, "mesh": pipe.mesh.shape}
        return fn

    def lora():
        shape = PARALLEL_SHAPE
        names = [f"ft{i}.wav" for i in range(shape["lora_rows"] + shape["lora_dev"])]
        wavs = [load_wav(os.path.join(job["lora_wav_dir"], n))[0] for n in names]
        y = np.arange(len(names)) % 8
        eng = LoRAFTEngine(job["model_dir"], rank=8, num_emotions=8, seed=SEED, device=dev)
        res = eng.train_epochs(wavs[: shape["lora_rows"]], y[: shape["lora_rows"]], wavs[shape["lora_rows"]:],
                               y[shape["lora_rows"]:], epochs=1, batch_size=shape["lora_batch"], log=lambda *_: None)
        from interspeech_ser_tpu_torch.models import lora as lora_lib

        trained = {**lora_lib.lora_state_dict(eng.lora),
                   **{f"head.{k}": v.detach().cpu() for k, v in eng.head.state_dict().items()}}
        return {"losses": res["losses"], "trained": {k: v.detach().cpu() for k, v in trained.items()},
                "trainable": audit.param_elements(eng.trainable()), "layers": eng.cfg.num_layers,
                "steps": len(res["losses"]), "dev_batches": -(-shape["lora_dev"] // shape["lora_batch"])}

    run("fusion", fusion)
    run("cli_bf16", cli_extract("bfloat16"))
    run("cli_f32", cli_extract("float32"))
    run("dp", pipeline_extract(1))
    if rank_heads:
        run("tp", pipeline_extract(2))
    run("lora", lora)
    return out


def parallel_rank(rank: int, world: int, init: str, job: dict, out_dir: str) -> None:
    """One rank of phase 17's spawned world: join the group (the backend the
    cards allow, printed), run ``parallel_runs``, save its results."""
    os.environ["LOCAL_RANK"] = str(rank)
    from interspeech_ser_tpu_torch.utils.device import init_distributed, teardown

    init_distributed(job["device"], init_method=init, rank=rank, world_size=world)
    try:
        torch.save(parallel_runs(job, rank_heads=True), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        teardown()


def nccl_world(rank: int, world: int, init: str, out_dir: str) -> None:
    """A world of one NCCL rank on card 0: init, then all-reduce, all-gather
    and broadcast on the card, checked and timed."""
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = "0"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=init, rank=rank, world_size=world)
    try:
        x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        dist.broadcast(x, src=0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        ok = bool(torch.equal(parts[0], x)) and float(x[-1]) == float((1 << 20) - 1)
        torch.save({"ok": ok, "ms": ms, "backend": dist.get_backend()}, os.path.join(out_dir, "nccl.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple, out_dir: str) -> None:
    """``fn(rank, world, init, *args)`` on ``world`` spawned processes
    (``file://`` init under ``out_dir``); a rank that fails raises here."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "init")
    mp.spawn(fn, args=(world, init) + args, nprocs=world, join=True)


def _files_max_abs(got_dir: str, want_dir: str) -> tuple:
    """(max abs diff, min cosine, files) over the ``.pt`` files of ``want_dir``."""
    worst, cos_min, names = 0.0, 1.0, sorted(f for f in os.listdir(want_dir) if f.endswith(".pt"))
    require(sorted(f for f in os.listdir(got_dir) if f.endswith(".pt")) == names, f"{got_dir}: files differ")
    for name in names:
        a = torch.load(os.path.join(got_dir, name), weights_only=True)
        b = torch.load(os.path.join(want_dir, name), weights_only=True)
        require(a.shape == b.shape, f"{got_dir}/{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        worst, cos_min = max(worst, max_abs(a, b)), min(cos_min, cosine(a, b))
    return worst, cos_min, len(names)


def phase_parallel(tmp: str, config_path: str, smi: str) -> dict:
    """Phase 17: phase 4's WavLM-large and wavs, phase 6's features and
    phase 7's LoRA wavs through the multi-device surface: the one-process
    runs here, then 2 spawned ranks (gloo sharing the card, or NCCL one card
    a rank), then a 1-rank NCCL world; each rank's results against the one
    process's and phase 4's files, its launches against
    ``predict_parallel_launches``, its audit against ``expected_audit``."""
    global LAUNCHING
    LAUNCHING = DEVICE == "cuda"  # spawned CPU ranks run the plain versions, which count nothing
    t0 = time.perf_counter()
    world = PARALLEL_SHAPE["world"]
    job = {"device": DEVICE, "tmp": tmp, "config_path": config_path, "model_dir": os.path.join(tmp, "wavlm-large"),
           "wav_dir": os.path.join(tmp, "wavs"), "lora_wav_dir": os.path.join(tmp, "lora_wavs")}
    one = parallel_runs({**job, "tag": "one"})
    out_dir = os.path.join(tmp, "parallel_ranks")
    spawn_ranks(parallel_rank, world, ({**job, "tag": "ranks"}, out_dir), out_dir)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    nccl = None
    if DEVICE == "cuda":
        spawn_ranks(nccl_world, 1, (out_dir,), out_dir + "_nccl")
        nccl = torch.load(os.path.join(out_dir, "nccl.pt"), weights_only=False)
        require(nccl["ok"] and nccl["backend"] == "nccl", f"NCCL world of one: {nccl}")
    report = {"card": smi, "world": world, "nccl_world_1": nccl}

    # (a) fusion: the one process's trajectory, one optimizer step a batch
    a1 = one["fusion"]
    with open(config_path) as f:
        lr = json.load(f)["lr"]
    bar = 2 * lr * a1["train_batches"] + 1e-5  # Adam's steps on elements at the rounding floor
    for r, res in enumerate(ranks):
        a = res["fusion"]
        require(a["f1"] == a1["f1"], f"(a) rank {r}: dev macro-F1 {a['f1']} != one process's {a1['f1']}")
        loss_err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a["losses"], a1["losses"]))
        param_err = max(max_abs(a["params"][k], a1["params"][k]) for k in a1["params"])
        require(len(a["losses"]) == len(a1["losses"]) and loss_err <= 1e-5, f"(a) rank {r}: losses rel {loss_err}")
        require(param_err <= bar, f"(a) rank {r}: params max abs {param_err} > {bar}")
        want = predict_parallel_launches("fusion", r, world, **{k: a1[k] for k in ("n_mod", "train_batches",
                                                                                   "dev_batches")})
        got = {k: a["launches"][k] for k in want}
        require(not LAUNCHING or got == want == {k: a1["launches"][k] for k in want},
                f"(a) rank {r}: K3 / K3b {got} != {want}")
        check_audit(a["audit"], expected_audit("train", steps=a1["train_batches"], trainable=a1["trainable"]),
                    f"(a) rank {r}")
        report.setdefault("fusion", {})[f"rank{r}"] = {"loss_rel_err": loss_err, "param_max_abs": param_err,
                                                       "step_ms": a["step_ms"], "launches": got,
                                                       "audit": audit.audit_line(a["audit"])}
    check_audit(a1["audit"], expected_audit("one_rank"), "(a) one process")
    report["fusion"]["one"] = {"step_ms": a1["step_ms"], "f1": a1["f1"], "param_bar": bar}

    # (b) data-parallel extraction: phase 4's files at the default budget, the one process's at 24 s
    report["extract"] = {}
    for name, ref, bar in (("cli_bf16", os.path.join(tmp, "feats_bfloat16"), 1e-2),
                           ("cli_f32", os.path.join(tmp, "feats_float32"), 1e-5),
                           ("dp", one["dp"]["save"], 1e-5)):
        worst, cos_min, n = _files_max_abs(ranks[0][name]["save"], ref)  # the ranks share the save dir
        require(worst <= bar, f"(b) {name}: max abs {worst} > {bar} against {ref}")
        st = ranks[0][name]["stats"]
        report["extract"][name] = {"max_abs": worst, "cos_min": cos_min, "files": n, "bar": bar,
                                   "utt_per_sec": st["n_utts"] / st["wall_seconds"],
                                   "one_utt_per_sec": one[name]["stats"]["n_utts"] / one[name]["stats"]["wall_seconds"]}
        check_audit(one[name]["audit"], expected_audit("one_rank"), f"(b) one process {name}")
        for r, res in enumerate(ranks):
            check_audit(res[name]["audit"], expected_audit("dp_extract"), f"(b) rank {r} {name}")
            report["extract"][name][f"audit_rank{r}"] = audit.audit_line(res[name]["audit"])
    require(one["dp"]["stats"]["n_batches"] >= world, f"(b) {one['dp']['stats']['n_batches']} batches at 24 s")
    for r, res in enumerate(ranks):
        want = predict_parallel_launches("dp_extract", r, world, batches=one["dp"]["stats"]["n_batches"],
                                         layers=one["dp"]["layers"])
        got = {k: res["dp"]["launches"][k] for k in want}
        require(not LAUNCHING or got == want, f"(b) rank {r}: launches {got} != {want}")
        report["extract"]["dp"][f"launches_rank{r}"] = got

    # (c) tensor parallelism: phase 4's f32 files, K1 at H / 2 heads a rank
    worst, cos_min, n = _files_max_abs(ranks[0]["tp"]["save"], os.path.join(tmp, "feats_float32"))
    require(cos_min >= 0.99999, f"(c) TP={world} cosine {cos_min} < 0.99999 (max abs {worst})")
    report["tp"] = {"max_abs": worst, "cos_min": cos_min, "files": n}
    for r, res in enumerate(ranks):
        c = res["tp"]
        require(c["heads"] == [c["num_heads"] // world] and c["mesh"] == {"data": 1, "model": world},
                f"(c) rank {r}: heads {c['heads']}, mesh {c['mesh']}")
        want = predict_parallel_launches("tp_extract", r, world, batches=c["stats"]["n_batches"], layers=c["layers"])
        got = {k: c["launches"][k] for k in want}
        require(not LAUNCHING or got == want, f"(c) rank {r}: launches {got} != {want}")
        check_audit(c["audit"], expected_audit("tp_extract", layers=c["layers"], batches=c["stats"]["n_batches"]),
                    f"(c) rank {r}")
        report["tp"][f"rank{r}"] = {"heads": c["heads"], "launches": got, "audit": audit.audit_line(c["audit"]),
                                    "utt_per_sec": c["stats"]["n_utts"] / c["stats"]["wall_seconds"]}

    # (d) LoRA: the trained factors and head against the one process's
    d1 = one["lora"]
    lbar = 2 * 5e-4 * d1["steps"] + 1e-5
    for r, res in enumerate(ranks):
        d = res["lora"]
        worst = max(max_abs(d["trained"][k], d1["trained"][k]) for k in d1["trained"])
        loss_err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(d["losses"], d1["losses"]))
        require(worst <= lbar and loss_err <= 1e-4, f"(d) rank {r}: trained max abs {worst} (bar {lbar}), "
                                                    f"losses rel {loss_err}")
        want = predict_parallel_launches("lora", r, world, layers=d1["layers"], steps=d1["steps"],
                                         dev_batches=d1["dev_batches"])
        got = {k: d["launches"][k] for k in want}
        require(not LAUNCHING or got == want == {k: d1["launches"][k] for k in want},
                f"(d) rank {r}: launches {got} != {want}")
        check_audit(d["audit"], expected_audit("train", steps=d1["steps"], trainable=d1["trainable"]), f"(d) rank {r}")
        report.setdefault("lora", {})[f"rank{r}"] = {"max_abs": worst, "loss_rel_err": loss_err,
                                                     "audit": audit.audit_line(d["audit"]), "seconds": d["seconds"]}
    check_audit(d1["audit"], expected_audit("one_rank"), "(d) one process")
    report["lora"]["one"] = {"seconds": d1["seconds"], "bar": lbar, "trainable": d1["trainable"]}
    report["one_audit"] = audit.audit_line(one["fusion"]["audit"])
    runs = list(one.values()) + [run for res in ranks for run in res.values()]
    report["launches"] = {k: sum(run["launches"][k] for run in runs) for k in KERNELS}
    report["phase_s"] = time.perf_counter() - t0
    return report


# -- phase 18: profiling ---------------------------------------------------------

# (a) WavLM-large B=32 x 10 s and (b) Whisper-large-v3 B=8 x 30 s traced in bf16; (c) fusion train steps timed
PROFILING_SHAPE = dict(wavlm_steps=2, batch=32, seconds=10.0, whisper_steps=1, train_steps=5)
# the kernel each wrapper counts as its launch, as the profiler names it: K1; K2's layer 0 without the
# one-off fill of its bf16 GELU table; K8 without its per-call weight layout
LAUNCH_EVENTS = {"K1": K1_EVENTS, "K2": ("conv_frontend_kernel", "conv_frontend_mma_kernel"),
                 "K8": ("pos_conv_f32_kernel", "pos_conv_wgmma_kernel")}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # where a trace keeps the host's launch calls


def kernels_by_span(events: list, spans, route=None) -> tuple:
    """Attribute each device kernel of a Chrome trace to the host span (a
    ``user_annotation`` named in ``spans``) that holds its launch call, the
    two joined by the correlation id -> (route, {span: [kernel events]}).
    Where no kernel's launch call is in the trace, a kernel belongs to the
    ``gpu_user_annotation`` range of a span's name that holds it on the
    device (route ``gpu_user_annotation``); ``route`` asks for one."""
    xs = [e for e in events if e.get("ph") == "X"]
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    out = {name: [] for name in spans}
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    if route != "gpu_user_annotation" and any(k.get("args", {}).get("correlation") in launches for k in kernels):
        ranges = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] in out]
        for k in kernels:
            launch = launches.get(k.get("args", {}).get("correlation"))
            held = launch and [r for r in ranges if r["pid"] == launch["pid"]
                               and r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]]
            if held:
                out[held[0]["name"]].append(k)
        return "correlation", out
    ranges = [e for e in xs if e.get("cat") == "gpu_user_annotation" and e["name"] in out]
    for k in kernels:
        held = [r for r in ranges if r["ts"] <= k["ts"] and k["ts"] + k["dur"] <= r["ts"] + r["dur"]]
        if held:
            out[held[0]["name"]].append(k)
    return "gpu_user_annotation", out


def count_events(kernels: list, names) -> int:
    return sum(any(n in k["name"] for n in names) for k in kernels)


def launch_calls(events: list, kernels: list) -> dict:
    """{launch call's name: kernels of ``kernels`` it launched} (``cudaLaunchKernel``, ...)."""
    names = {e["args"]["correlation"]: e["name"] for e in events
             if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    out = {}
    for k in kernels:
        name = names.get(k.get("args", {}).get("correlation"), "none")
        out[name] = out.get(name, 0) + 1
    return out


def clock_margins(events: list) -> tuple:
    """The least room, in us, between a launch call (CUPTI's clock) and the
    host op it was made in (the profiler's clock), at the op's start and at its
    end, over the launch calls that name their op's External id: negative
    where the two clocks disagree by more than the op's own margin."""
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    pairs = [(e, ops[e["args"]["External id"]]) for e in events
             if e.get("cat") in LAUNCH_CATS and e.get("args", {}).get("External id") in ops]
    if not pairs:
        return None, None
    return (min(c["ts"] - o["ts"] for c, o in pairs),
            min(o["ts"] + o["dur"] - c["ts"] - c["dur"] for c, o in pairs))


def read_trace(run, want: dict, what: str, smi: str) -> dict:
    """A ``profile_trace`` run's Chrome trace: every step span present and,
    on the card, each step's kernels attributed to its span, ``want``
    ({K1 / K2 / K8: launches a step}) of each; per step the span's host ms,
    the attributed kernels' device ms and K1's share of it."""
    require(run.path is not None and os.path.exists(run.path), f"{what}: no trace file")
    size = os.path.getsize(run.path)
    with open(run.path) as f:
        events = json.load(f)["traceEvents"]
    host_ms = {e["name"]: e["dur"] / 1e3 for e in events if e.get("cat") == "user_annotation"
               and e.get("name") in run.spans}
    require(sorted(host_ms) == sorted(run.spans), f"{what}: spans {sorted(host_ms)} != {run.spans}")
    res = {"trace_bytes": size, "spans": {}, "step_s": [run.timer.totals[s] for s in run.spans]}
    if DEVICE == "cuda":
        res["route"], attributed = kernels_by_span(events, run.spans)
        _, on_device = kernels_by_span(events, run.spans, "gpu_user_annotation")
        res["clock_margins_us"] = clock_margins(events)
        spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") in run.spans}
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    for name in run.spans:
        step = {"host_ms": host_ms[name], "readback_ms": run.timer.totals[name] * 1e3}
        if DEVICE == "cuda":
            ks = attributed[name]
            step["launches"] = {k: count_events(ks, names) for k, names in LAUNCH_EVENTS.items()}
            step["device_ms"] = sum(k["dur"] for k in ks) / 1e3
            step["k1_ms"] = sum(k["dur"] for k in ks if any(n in k["name"] for n in K1_EVENTS)) / 1e3
            step["kernels"] = len(ks)
            step["launch_calls"] = launch_calls(events, ks)
            step["gpu_user_annotation"] = {k: count_events(on_device[name], names) for k, names in LAUNCH_EVENTS.items()}
            if not all(step["launches"][k] == n for k, n in want.items()):
                # each kernel of the wanted kinds with its launch call's time from each span's start and end
                where = [(k["name"][:48], k["args"].get("correlation"),
                          {s: (round(launched[k["args"]["correlation"]] - a, 3), round(launched[k["args"]["correlation"]] - b, 3))
                           for s, (a, b) in spans.items()} if k.get("args", {}).get("correlation") in launched else None)
                         for k in events if k.get("cat") == "kernel"
                         and any(n in k["name"] for w in want for n in LAUNCH_EVENTS[w] if w != "K1")]
                require(False, f"{what} {name}: attributed launches {step['launches']} != {want} (route "
                               f"{res['route']}; by the device ranges {step['gpu_user_annotation']}; clock margins "
                               f"{res['clock_margins_us']} us; K2 / K8 kernels (name, correlation, launch - span "
                               f"start / end us): {where})")
            log(f"[profiling] {what} {name}: span {step['host_ms']:.3f} host ms, {step['kernels']} kernels attributed "
                f"({res['route']}) = {step['device_ms']:.3f} device ms, K1 {step['k1_ms']:.3f} ms = "
                f"{100 * step['k1_ms'] / step['device_ms']:.1f}%; to readback {step['readback_ms']:.3f} ms; "
                f"launches {step['launches']} through {step['launch_calls']} (by the device ranges "
                f"{step['gpu_user_annotation']}); launch calls in their host ops with {res['clock_margins_us']} us to "
                f"spare at start / end; trace {size / 2 ** 20:.2f} MiB ({smi})")
        res["spans"][name] = step
    return res


def time_train_steps(tmp: str, config_path: str, n: int, smi: str) -> tuple:
    """(c) ``n`` fusion train steps (the first train batch, as
    ``check_train_step`` times) in ``StepTimer.span("train_step")`` with the
    loss as its result, CUDA events around each step on the same stream; then
    ``n`` more in spans with no result (the launch-only time, a record); then
    one step traced, K3's cluster launch and K3b's attributed to its span.
    -> (the record, the step)."""
    from interspeech_ser_tpu_torch.train.engine import FusionEngine
    from interspeech_ser_tpu_torch.utils.profiling import StepTimer, annotate, trace

    cfg, batch, class_w = first_train_batch(config_path)
    engine = FusionEngine(cfg, seed=SEED, device=DEVICE)
    step = train_step_fn(engine, batch, class_w)
    step()
    sync()
    before = counts()
    timer, launch_only, event_ms, box = StepTimer(), StepTimer(), [], {}
    for _ in range(n):
        sync()
        if DEVICE == "cuda":
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
        with timer.span("train_step", result_getter=lambda: box["loss"]):
            box["loss"] = step()
            if DEVICE == "cuda":
                e.record()
        if DEVICE == "cuda":
            e.synchronize()
            event_ms.append(s.elapsed_time(e))
    for _ in range(n):
        sync()
        with launch_only.span("train_step"):
            step()
    sync()
    delta = {k: v - before[k] for k, v in counts().items()}
    n_mod = len(cfg.feat_dims)
    require(delta["gru_bidir"] == delta["gru_bidir_bwd"] == n_mod * 2 * n,
            f"(c) K3 / K3b launches {delta['gru_bidir']} / {delta['gru_bidir_bwd']} != {n_mod} modalities x {2 * n} steps")
    require(bool(torch.isfinite(box["loss"])), f"(c) train-step loss {box['loss']}")
    res = {"timer_s": timer.totals["train_step"], "launch_only_s": launch_only.totals["train_step"],
           "report": timer.report(), "launches": delta, "batch": cfg.batch_size}
    if DEVICE == "cuda":
        res["event_s"] = sum(event_ms) / 1e3
        res["ratio"] = res["timer_s"] / res["event_s"]
        require(res["ratio"] >= 0.98, f"(c) StepTimer {res['timer_s']:.6f} s < 0.98 x CUDA events {res['event_s']:.6f} s")
    log(f"[profiling] (c) {n} fusion train steps (batch {cfg.batch_size}) under StepTimer with a readback: "
        f"{res['timer_s'] * 1e3:.3f} ms"
        + (f" against {res['event_s'] * 1e3:.3f} ms of CUDA events (ratio {res['ratio']:.4f})" if "event_s" in res
           else "")
        + f"; {n} more with no result (launch-only, a record): {res['launch_only_s'] * 1e3:.3f} ms; K3 / K3b "
          f"{delta['gru_bidir']} / {delta['gru_bidir_bwd']} ({smi})")
    log(f"[profiling]   {res['report']}")
    with trace(os.path.join(tmp, "trace_train")) as tr:
        with annotate("train_step"):
            step()
        sync()
    if DEVICE == "cuda":
        with open(tr.path) as f:
            events = json.load(f)["traceEvents"]
        route, spans = kernels_by_span(events, ["train_step"])
        ks = spans["train_step"]
        got = {"K3": count_events(ks, K3_EVENTS),
               "K3b": count_events(ks, ("gru_bidir_bwd_kernel", "gru_bidir_bwd_cluster_kernel"))}
        require(got == {"K3": n_mod, "K3b": n_mod}, f"(c) traced train step: K3 / K3b attributed {got} != {n_mod} each")
        res["traced"] = {"route": route, "launches": got, "kernels": len(ks),
                         "launch_calls": {k: launch_calls(events, [e for e in ks if any(n in e["name"] for n in names)])
                                          for k, names in (("K3", K3_EVENTS), ("K3b", K3B_EVENTS))}}
        log(f"[profiling] (c) one traced train step: {len(ks)} kernels attributed ({route}); K3 / K3b recurrences "
            f"{got}; launch calls {res['traced']['launch_calls']}")
    return res, step


def profiling_paths(tmp: str, config_path: str, smi: str) -> dict:
    """Phase 18's paths: (a) a WavLM-large trace and (b) a Whisper-large-v3
    trace, each kernel attributed to its step span; (c) ``StepTimer`` over
    fusion train steps against CUDA events; (d) ``RTFMeter`` over (a)'s
    steps; (e) ``SER_TPU_TRACE=0`` writes nothing. ``launches``: the counts
    of the run."""
    from interspeech_ser_tpu_torch.models.speech import wavlm_large
    from interspeech_ser_tpu_torch.models.whisper import whisper_large_v3
    from interspeech_ser_tpu_torch.profile_trace import profile_trace
    from interspeech_ser_tpu_torch.utils.profiling import RTFMeter, trace

    shape = PROFILING_SHAPE
    t0, at_start = time.perf_counter(), counts()
    out, runs = {}, {}
    for model, steps, layers, what in (
            ("wavlm", shape["wavlm_steps"], wavlm_large().num_layers, "(a) WavLM-large bf16"),
            ("whisper", shape["whisper_steps"], whisper_large_v3().encoder_layers, "(b) Whisper-large-v3 bf16")):
        before = counts()
        run = profile_trace(model, steps, shape["batch"], shape["seconds"], os.path.join(tmp, f"trace_{model}"),
                            DEVICE, SEED)
        sync()
        delta = {k: v - before[k] for k, v in counts().items()}
        want = {"K1": layers} if model == "whisper" else {"K1": layers, "K2": 1, "K8": 1}
        require(delta["attention_btd"] == layers * (steps + 1),
                f"{what}: K1 launches {delta['attention_btd']} != {layers} layers x {steps + 1} forwards")
        out[model] = read_trace(run, want, what, smi)
        runs[model] = run
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

    # (d) the inference seconds of (a)'s readback-forced steps over their audio
    run = runs["wavlm"]
    meter = RTFMeter()
    for name in run.spans:
        meter.add(run.timer.totals[name], n_samples=run.samples_per_step)
    inference_s = sum(run.timer.totals[name] for name in run.spans)
    audio_s = sum(run.samples_per_step / meter.sample_rate for _ in run.spans)
    require(meter.rtf == inference_s / audio_s, f"(d) rtf {meter.rtf} != {inference_s} / {audio_s}")
    out["rtf"] = {"rtf": meter.rtf, "inference_s": meter.inference_s, "audio_s": meter.audio_s}
    log(f"[profiling] (d) RTFMeter over (a)'s steps ({smi}):\n{meter.report()}")

    out["train"], step = time_train_steps(tmp, config_path, shape["train_steps"], smi)

    # (e) switched off: one step writes nothing
    off_dir = os.path.join(tmp, "trace_off")
    saved = os.environ.get("SER_TPU_TRACE")
    os.environ["SER_TPU_TRACE"] = "0"
    try:
        with trace(off_dir) as tr:
            step()
            sync()
    finally:
        if saved is None:
            del os.environ["SER_TPU_TRACE"]
        else:
            os.environ["SER_TPU_TRACE"] = saved
    require(tr is None and not os.path.exists(off_dir), f"(e) SER_TPU_TRACE=0 wrote under {off_dir}")
    out["paths_s"] = time.perf_counter() - t0
    out["launches"] = {k: v - at_start[k] for k, v in counts().items()}
    log(f"[profiling] (e) SER_TPU_TRACE=0: nothing under {os.path.basename(off_dir)}; paths "
        f"{out['paths_s']:.1f} s ({smi})")
    return out


def profiling_process(_rank: int, tmp: str, config_path: str, smi: str, out_path: str) -> None:
    out = profiling_paths(tmp, config_path, smi)
    with open(out_path, "w") as f:
        json.dump(out, f)


def kernel_records(tmp: str) -> tuple:
    """A trace of 8 elementwise launches and a matmul in this process ->
    (launch calls, kernel records of them)."""
    from interspeech_ser_tpu_torch.utils.profiling import annotate, trace

    x = torch.randn(2048, 2048, device=DEVICE)
    sync()
    with trace(os.path.join(tmp, "trace_records")) as tr:
        with annotate("records"):
            for _ in range(8):
                x * 2.0
            x @ x
        sync()
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    calls = {e["args"]["correlation"] for e in events
             if e.get("cat") in LAUNCH_CATS and "Launch" in e["name"] and "correlation" in e.get("args", {})}
    return len(calls), len(calls & {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"})


def phase_profiling(tmp: str, config_path: str, smi: str) -> dict:
    """Phase 18: ``utils/profiling`` and ``profile_trace`` on the card, in a
    process of its own (``profiling_paths``). In a process that has run much
    GPU work untraced, as this script's own has by now, ``torch.profiler``
    may lose the kernel records at a session's start (a record: the launch
    calls of a small trace here against its kernel records)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    own = kernel_records(tmp)
    log(f"[profiling] this process ({t0 - T0:.0f} s old): a trace of {own[0]} launch calls holds the kernel records "
        f"of {own[1]}")
    out_path = os.path.join(tmp, "profiling.json")
    mp.spawn(profiling_process, args=(tmp, config_path, smi, out_path), nprocs=1, join=True)
    with open(out_path) as f:
        out = json.load(f)
    out.update(own_process_records=own, phase_s=time.perf_counter() - t0)
    log(f"[profiling] phase 18 {out['phase_s']:.1f} s ({smi})")
    return out


def main() -> None:
    smi = phase_device()
    set_tf32(False)
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    parity: dict = {}
    check_attention(g, parity)
    check_attention_whisper(g, parity)
    parity["attention_btd"]["f32_plans"] = check_f32_plans()
    check_attention_bhtd(g, parity)
    parity["attention_bhtd"]["f32_plans"] = check_bhtd_f32_plans()
    check_conv_frontend(g, parity)
    check_ffn_fused(g, parity)
    check_pos_conv(g, parity)
    parity["pos_conv"]["plans"] = check_conv_plans()
    check_gru(g, parity)
    check_gru_sequence(g, parity)
    check_gru_bwd(g, parity)
    check_attention_bwd(g, parity)
    check_attention_dead_row(g, parity)
    log(f"[parity] phase 3 done at {time.perf_counter() - T0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        zero_counts()
        extracted = phase_extraction(tmp, smi)
        phase_scoring(tmp, extracted)
        serving = counts()
        for name in ("attention_btd", "conv_frontend", "gru_bidir"):
            require(serving[name] > 0, f"kernel {name} was not launched on the serving path")
        log(f"[serving path] launches {serving}; extraction utt/s {extracted['utt_per_sec']}")

        config_path = write_train_corpus(tmp)
        zero_counts()
        trained = phase_train(config_path)
        training = counts()
        want_bwd = trained["n_modalities"] * trained["steps"]
        require(training["gru_bidir"] > 0, "K3 was not launched on the training path")
        require(training["gru_bidir_bwd"] == want_bwd,
                f"K3b launches {training['gru_bidir_bwd']} != {trained['n_modalities']} modalities x "
                f"{trained['steps']} optimizer steps")
        log(f"[training path] launches {training}")
        step = check_train_step(config_path)

        zero_counts()
        whisper = phase_whisper_extraction(tmp)
        phase_lora(tmp, whisper, os.path.join(tmp, "wavlm-large"))
        lora_path = counts()
        for name in ("attention_btd", "attention_btd_bwd", "conv_frontend"):
            require(lora_path[name] > 0, f"kernel {name} was not launched on the LoRA path")
        log(f"[lora path] launches {lora_path}; Whisper extraction utt/s {whisper['utt_per_sec']}")
        lora_grads = check_lora_grads(tmp, whisper, os.path.join(tmp, "wavlm-large"))
        steps = {**time_lora_steps(whisper, "bfloat16"), **time_lora_steps(whisper, "float32")}

        zero_counts()
        text_run = phase_text(tmp, smi)
        text_path = counts()
        for name in ("attention_bhtd", "flash_attention"):
            require(text_path[name] > 0, f"kernel {name} was not launched on the text path")
        log(f"[text path] launches {text_path}; texts/s {text_run['texts_per_sec']}")

        zero_counts()
        zoo = phase_zoo(tmp, smi)
        zoo_path = counts()
        for name in ("attention_btd", "attention_btd_bwd", "conv_frontend", "conv_frontend_layer", "ffn_fused",
                     "pos_conv"):
            require(zoo_path[name] > 0, f"kernel {name} was not launched on the zoo path")
        log(f"[zoo path] launches {zoo_path}")

        zero_counts()
        ns3 = phase_ns3(tmp, config_path, smi)
        extraction = counts()
        require(not any(extraction.values()), f"a kernel launched during NS3 extraction: {extraction}")
        tri = phase_train(ns3["config_path"], trimodal=True)
        trimodal_path = counts()
        require(trimodal_path["gru_bidir"] > 0, "K3 was not launched on the trimodal path")
        require(trimodal_path["gru_bidir_bwd"] == tri["n_modalities"] * tri["steps"] and tri["n_modalities"] == 3,
                f"K3b launches {trimodal_path['gru_bidir_bwd']} != {tri['n_modalities']} modalities x "
                f"{tri['steps']} optimizer steps")
        log(f"[trimodal path] launches {trimodal_path} (none during NS3 extraction); NS3 utt/s {ns3['utt_per_sec']}")
        tri_step = time_trimodal_step(ns3["config_path"], smi)

        wavlm_dir = os.path.join(tmp, "wavlm-large")
        zero_counts()
        t_base = time.perf_counter()
        baseline = phase_baseline(tmp, wavlm_dir)
        baseline_path = counts()
        n_layers = baseline["n_layers"]
        require(baseline_path["attention_btd_bwd"] == 2 * n_layers * baseline["micro_batches"],
                f"K4 launches {baseline_path['attention_btd_bwd']} != 2 tasks x {n_layers} layers x "
                f"{baseline['micro_batches']} micro-batches on the baseline path")
        for name in ("attention_btd", "conv_frontend"):
            require(baseline_path[name] > 0, f"kernel {name} was not launched on the baseline path")
        for name in ("gru_bidir", "gru_bidir_bwd", "ffn_fused", "pos_conv", "gru_sequence", "conv_frontend_layer"):
            require(baseline_path[name] == 0, f"kernel {name} was launched on the baseline path: {baseline_path}")
        log(f"[baseline path] launches {baseline_path}")
        baseline["grads"] = check_baseline_grads(tmp, wavlm_dir, baseline["config_path"])
        baseline["steps"] = time_baseline_steps(wavlm_dir, baseline["config_path"], smi)
        baseline["phase_s"] = time.perf_counter() - t_base

        zero_counts()
        t_tr = time.perf_counter()
        transcribed = run_transcription(tmp, smi)
        transcribe_path = counts()
        n_batches = sum(run["stats"].n_batches for run in transcribed["runs"].values())
        want = transcribed["enc_cfg"].encoder_layers * n_batches
        require(transcribe_path["attention_btd"] == want,
                f"(b) K1 launches {transcribe_path['attention_btd']} != {transcribed['enc_cfg'].encoder_layers} "
                f"layers x {n_batches} batches on the transcription path")
        moved = {k: v for k, v in transcribe_path.items() if k != "attention_btd" and v}
        require(not moved, f"(b) kernels other than K1 launched on the transcription path: {moved}")
        log(f"[transcribe path] launches {transcribe_path}")
        transcription = check_transcription(transcribed, smi)
        transcription["write_s"] = transcribed["write_s"]
        transcription["load_s"] = transcribed["load_s"]
        transcription["phase_s"] = time.perf_counter() - t_tr

        zero_counts()
        t_leg = time.perf_counter()
        legacy = phase_legacy(tmp, config_path)
        legacy_path = counts()
        for name in ("gru_bidir", "gru_bidir_bwd"):
            ran = sum(run["launches"][name] for run in legacy["runs"].values())
            require(legacy_path[name] == ran > 0, f"{name} launches {legacy_path[name]} on the legacy path, {ran} "
                                                  f"counted run by run")
        moved = {k: v for k, v in legacy_path.items() if k not in ("gru_bidir", "gru_bidir_bwd") and v}
        require(not moved, f"kernels other than K3 / K3b launched on the legacy path: {moved}")
        log(f"[legacy path] launches {legacy_path}")
        legacy["steps"] = check_legacy_steps(legacy, smi)
        legacy["phase_s"] = time.perf_counter() - t_leg

        zero_counts()
        t_joint = time.perf_counter()
        joint = phase_joint(tmp, baseline["config_path"], wavlm_dir, os.path.join(tmp, "roberta-large"))
        joint_path = counts()
        ran = {name: sum(run["launches"][name] for run in joint["runs"].values()) for name in KERNELS}
        require(joint_path == ran, f"joint path launches {joint_path} != the runs' sum {ran}")
        for name in ("attention_btd", "attention_btd_bwd", "attention_bhtd", "conv_frontend", "pos_conv"):
            require(joint_path[name] > 0, f"kernel {name} was not launched on the joint path")
        log(f"[joint path] launches {joint_path}")
        joint["checks"] = check_joint_runs(joint, smi)
        joint["grads"] = check_joint_grads(tmp, wavlm_dir, joint)
        joint["phase_s"] = time.perf_counter() - t_joint

        zero_counts()
        t_info = time.perf_counter()
        info = phase_info(tmp, config_path, baseline["config_path"], wavlm_dir, joint)
        info_path = counts()
        ran = {name: sum(run["launches"][name] for run in info["runs"].values()) for name in KERNELS}
        require(info_path == ran, f"information-encoder path launches {info_path} != the runs' sum {ran}")
        for name in ("gru_bidir", "gru_bidir_bwd", "attention_btd", "attention_btd_bwd", "conv_frontend"):
            require(info_path[name] > 0, f"kernel {name} was not launched on the information-encoder path")
        log(f"[info path] launches {info_path}")
        info["reloads"] = check_info_reloads(info)
        info["steps"] = check_info_steps(info, smi)
        info["phase_s"] = time.perf_counter() - t_info

        zero_counts()
        t16 = time.perf_counter()
        decoded = phase_decoder(tmp, smi)
        decoder_path = counts()
        require(not any(decoder_path.values()), f"a kernel launched on the decoder path: {decoder_path}")
        log(f"[decoder path] launches {decoder_path} (none, as in the JAX package)")
        zero_counts()
        adapters, kept = phase_adapters(tmp, smi)
        adapter_path = counts()
        want = {name: sum(run["predicted"].get(name, 0) for run in adapters["runs"].values()) for name in KERNELS}
        require(adapter_path == want, f"adapter path launches {adapter_path} != predicted {want}")
        for name in ("attention_btd", "attention_btd_bwd", "conv_frontend"):
            require(adapter_path[name] > 0, f"kernel {name} was not launched on the adapter path")
        log(f"[adapter path] launches {adapter_path} (predicted {want})")
        adapters["grads"] = check_adapter_grads(tmp)
        adapters["prompt_batch1"] = check_prompt_batch1(tmp, kept)
        del kept
        phase16_s = time.perf_counter() - t16

        zero_counts()
        parallel = phase_parallel(tmp, config_path, smi)
        parallel_path = parallel["launches"]
        for name in ("attention_btd", "attention_btd_bwd", "conv_frontend", "pos_conv", "gru_bidir", "gru_bidir_bwd"):
            require(parallel_path[name] > 0, f"kernel {name} was not launched on the multi-device path")
        log(f"[parallel path] launches {parallel_path} (the one process and every rank)")

        prof = phase_profiling(tmp, config_path, smi)
        profiling_path = prof.pop("launches")
        for name in ("attention_btd", "conv_frontend", "pos_conv", "gru_bidir", "gru_bidir_bwd"):
            require(profiling_path[name] > 0, f"kernel {name} was not launched on the profiling path")
        log(f"[profiling path] launches {profiling_path}")
    by_path = {"serving": serving, "training": training, "lora": lora_path, "text": text_path, "zoo": zoo_path,
               "trimodal": trimodal_path, "baseline": baseline_path, "transcribe": transcribe_path,
               "legacy": legacy_path, "joint": joint_path, "info": info_path, "decoder": decoder_path,
               "adapters": adapter_path, "parallel": parallel_path, "profiling": profiling_path}
    # the speech, fusion and transcription paths never reach K6 / K7; the joint path's RoBERTa runs K7 alone
    for path in ("serving", "training", "lora", "zoo", "trimodal", "baseline", "transcribe", "legacy", "adapters",
                 "parallel", "profiling"):
        require(by_path[path]["attention_bhtd"] == by_path[path]["flash_attention"] == 0,
                f"K6 / K7 launched on the {path} path: {by_path[path]}")
    require(joint_path["flash_attention"] == info_path["flash_attention"] == 0,
            f"K6 launched on the joint or information-encoder path: {joint_path}, {info_path}")
    launches = {name: sum(path[name] for path in by_path.values()) for name in KERNELS}

    record = []
    for name, spec in KERNELS.items():
        cases = parity[name]
        f32 = cases[spec["headline"]] if "headline" in spec else (cases.get("f32") or cases["f32_erf"])
        record.append({
            "name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
            "launches": launches[name], "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "launches_by_path": {path: c[name] for path, c in by_path.items()}, "cases": cases,
        })
    log(f"[chip_smoke] {time.perf_counter() - T0:.1f} s")
    log(f"[train] median train-step ms {step['train_step_ms']:.3f} (batch 64, H=512, {smi})")
    log(f"[lora] Whisper-large-v3 LoRA step median: bf16 {steps['bf16_step_ms']:.3f} ms, f32 "
        f"{steps['f32_step_ms']:.3f} ms (batch 8, {smi})")
    log(f"[ns3] prosody utt/s f32 cold {ns3['utt_per_sec']['prosody_cold']:.2f}, warm "
        f"{ns3['utt_per_sec']['prosody_warm']:.2f}; speaker cold {ns3['utt_per_sec']['speaker_cold']:.2f}, warm "
        f"{ns3['utt_per_sec']['speaker_warm']:.2f} (all wavs, full batches of {NS3_SHAPE['batch_size']}); speaker "
        f"batch device idle {100 * ns3['profile']['idle_share']:.1f}%; distinct codes {ns3['distinct']}; trimodal "
        f"train-step median {tri_step['train_step_ms']:.3f} ms ({smi})")
    b = baseline["steps"]
    log(f"[baseline] WavLM-large fine-tune micro-step (8 rows x {b['frames'] // 50} s) median: f32 "
        f"{b['f32_micro_step_ms']:.3f} ms, bf16 {b['bf16_micro_step_ms']:.3f} ms; AdamW step {b['f32_optimizer_step_ms']:.3f} "
        f"ms; peak {b['f32_peak_gb']:.2f} / {b['bf16_peak_gb']:.2f} GB; f32 inference "
        f"{b['inference_s_per_audio_s']:.5f} s per audio-s; phase 11 {baseline['phase_s']:.1f} s ({smi})")
    t16, t32 = transcription["bfloat16"], transcription["float32"]
    log(f"[transcribe] Whisper-large-v3, B={TRANSCRIBE_SHAPE['batch_size']} x {TRANSCRIBE_SHAPE['max_new_tokens']} new "
        f"tokens: decode step median bf16 {t16['step_ms']:.3f} ms (bound {t16['bound_ms']:.3f}), f32 "
        f"{t32['step_ms']:.3f} ms (bound {t32['bound_ms']:.3f}); CLI emitted tokens/s bf16 {t16['cli_tokens_per_sec']:.1f}, "
        f"f32 {t32['cli_tokens_per_sec']:.1f} (slots/s {t16['cli_slots_per_sec']:.1f}, {t32['cli_slots_per_sec']:.1f}); encoder ms a batch bf16 {t16['encoder_ms']:.2f}, f32 "
        f"{t32['encoder_ms']:.2f}; decode idle bf16 {100 * t16['idle_share']:.1f}%, f32 {100 * t32['idle_share']:.1f}%;"
        f" phase 12 {transcription['phase_s']:.1f} s ({smi})")
    moe, dim = legacy["steps"]["train_cat_bimodal_lazy_moe"], legacy["steps"]["train_dim_bimodal_lazy_cka"]
    log(f"[legacy] train step median: MoE (4 experts) {moe['train_step_ms']:.3f} ms, dim + CKA "
        f"{dim['train_step_ms']:.3f} ms (batch 64, H=512); MoE scoring forward {moe['score']['score_batch_ms']:.3f} "
        f"ms; phase 13 {legacy['phase_s']:.1f} s ({smi})")
    timed = [joint["checks"][stem] for stem in JOINT_TIMED]
    log(f"[joint] micro-step median (8 rows of the longest train wavs + 128 tokens): ftall / large / cka "
        f"{' / '.join(format(t['step_ms'], '.3f') for t in timed)} ms, beside phase 11's f32 micro-step "
        f"{b['f32_micro_step_ms']:.3f} ms in this call; peak {' / '.join(str(t['peak_gb']) for t in timed)} GB; "
        f"gradients worst {joint['grads']['worst']:.3e}; phase 14 {joint['phase_s']:.1f} s ({smi})")
    st = info["steps"]
    log(f"[info] train step median: ProtoSERNet 1024 -> 512 at C x U = 80 ({st['proto_ser_net_frames']} frames) "
        f"{st['proto_ser_net_step_ms']:.3f} ms, BidirectionalReferenceEncoder at 64 "
        f"{st['reference_encoder_step_ms']:.3f} ms, StyleEmbeddingNet (H = 256) at 32 "
        f"{st['style_embedding_step_ms']:.3f} ms, x-vector micro-step (8 x {st['xvector_seconds']:.0f} s) "
        f"{st['xvector_step_ms']:.3f} ms; K3 + K3b gradients worst {st['grad_rel_err']:.3e}; runs "
        f"{ {k: round(r['seconds'], 2) for k, r in info['runs'].items()} } s; phase 15 {info['phase_s']:.1f} s ({smi})")
    steps16 = " / ".join(f"{k.split('/')[0].replace('wavlm-', '')} {k.split('/')[1]} {r['step_ms']:.1f}"
                         for k, r in adapters["runs"].items())
    log(f"[phase 16] FACodec decode of {DECODE_SHAPE['n_wavs']} x {DECODE_SHAPE['seconds']:g} s "
        f"{decoded['decode_ms']:.1f} ms ({decoded['decode_utt_per_sec']:.2f} utt/s), redecode "
        f"{decoded['redecode_ms']:.1f} ms ({decoded['redecode_utt_per_sec']:.2f} utt/s), peak "
        f"{decoded.get('decode_profile', {}).get('peak_gb')} / {decoded.get('redecode_profile', {}).get('peak_gb')} "
        f"GB; adapter step ms {steps16}; gradients worst "
        f"{max(g['worst'] for g in adapters['grads'].values()):.3e}; phase 16 "
        f"{phase16_s:.1f} s ({smi})")
    pf, pe = parallel["fusion"], parallel["extract"]["dp"]
    log(f"[parallel] {parallel['world']} ranks ({'NCCL' if torch.cuda.device_count() >= parallel['world'] else 'gloo, one shared card'}): "
        f"fusion train step ms one process {[round(t, 3) for t in pf['one']['step_ms']]}, rank 0 "
        f"{[round(t, 3) for t in pf['rank0']['step_ms']]}; WavLM-large f32 extraction at {PARALLEL_SHAPE['budget_seconds']} s "
        f"batches utt/s one process {pe['one_utt_per_sec']:.2f}, {parallel['world']} ranks {pe['utt_per_sec']:.2f}; "
        f"TP={parallel['world']} cos {parallel['tp']['cos_min']:.7f} max abs {parallel['tp']['max_abs']:.3e}; NCCL world "
        f"of one {parallel['nccl_world_1']}; phase 17 {parallel['phase_s']:.1f} s ({smi})")
    pw, tr = prof["wavlm"], prof["train"]
    log(f"[profiling] WavLM-large bf16 B={PROFILING_SHAPE['batch']} x {PROFILING_SHAPE['seconds']:g} s steps: span host ms "
        f"{[round(st['host_ms'], 3) for st in pw['spans'].values()]}, attributed device ms "
        f"{[round(st.get('device_ms', 0.0), 3) for st in pw['spans'].values()]}, to readback ms "
        f"{[round(st['readback_ms'], 3) for st in pw['spans'].values()]} (route {pw.get('route')}), trace "
        f"{pw['trace_bytes'] / 2 ** 20:.2f} MiB; Whisper trace {prof['whisper']['trace_bytes'] / 2 ** 20:.2f} MiB; "
        f"rtf {prof['rtf']['rtf']:.6f}; StepTimer / CUDA events {tr.get('ratio', float('nan')):.4f}; phase 18 "
        f"{prof['phase_s']:.1f} s; in this process a trace held the kernel records of {prof['own_process_records'][1]} "
        f"of {prof['own_process_records'][0]} launch calls ({smi})")
    joint["runs"] = {stem: {k: v for k, v in run.items() if k != "dev_logits"} for stem, run in joint["runs"].items()}
    info["runs"] = {k: {n: v for n, v in r.items() if n not in ("result", "best")} for k, r in info["runs"].items()}
    log(json.dumps({"kernels": record, "card": smi, "extraction_utt_per_sec": extracted["utt_per_sec"],
                    "train": {**trained, **step},
                    "lora": {"whisper_extraction_utt_per_sec": whisper["utt_per_sec"], "grad_rel_err": lora_grads,
                             **steps},
                    "text": text_run, "zoo": zoo, "ns3": {**ns3, "trimodal": {**tri, **tri_step}},
                    "baseline": baseline, "transcription": transcription, "legacy": legacy, "joint": joint,
                    "info": info, "decoder": decoded, "adapters": adapters, "phase16_s": phase16_s,
                    "parallel": {k: v for k, v in parallel.items() if k != "launches"}, "profiling": prof,
                    "seconds": time.perf_counter() - T0}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
