"""Embedding extraction of a wav corpus, as ``preprocess_cli`` runs it, up to the host copy.

The program's own pieces, driven as ``extract/pipeline.py``'s ``run()``
drives them, with ``_drive``'s one-batch lag: ``BatchStream`` decodes the
wavs on its threads and pads each planned batch; the pipeline's
``_forward`` makes the pinned host-to-device copy, runs the encoder and
selects the layer; the harness starts the pinned device-to-host copy of the
selected hidden state and, a batch later, waits for it. The per-utterance
``.pt`` writes are left out: at 1-3 MB an utterance they would write tens
of GB in a check. The batch plan is made once in set-up; the window streams
it again and again, in whole passes.

Four pieces of the program's policy are copied here, because ``_drive``
writes each output to a file and has no other sink: Whisper's batch plan
and its ``BatchStream`` arguments (``fixed_len``, ``row_multiple``), from
``WhisperExtractionPipeline.run``; ``_drive``'s one-batch lag; and its
pinned device-to-host copy. A change to any of them in the program does not
show in these cells until a sink argument lets this driver call ``_drive``
itself (each copy is marked "copy of the program's").

A traffic file for this driver gives: ``dtype``; ``num_workers``; for a
speech encoder ``token_budget_s`` (seconds of audio a batch) and for
Whisper ``batch_size``; ``corpus`` (``utterances``, ``seconds`` [lo, hi]);
``check_utterances`` (how many outputs of the window the check compares,
drawn from the seed, the longest always among them); ``trace_seconds``.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict
from functools import partial

import numpy as np
import torch

from .. import corpus, flops, weights
from ..reference import whisper as ref_whisper
from ..reference import wavlm as ref_wavlm
from ..reference.common import Ops, exact_float32
from ..weights import sub_seed

REFERENCES = {"wavlm": ref_wavlm, "whisper": ref_whisper}
BATCHES = 1000  # the window's stream: the plan repeated to at least this many batches


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over the utterance, or inf on a shape mismatch."""
    if got.shape != ref.shape:
        return float("inf")
    return float((got.double() - ref.double()).norm() / ref.double().norm())


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.ref = REFERENCES[self.cfg["model_type"]]
        self.device = torch.device(run.device)
        self.recording = self.tracing = False
        self.trace_bounds = defaultdict(float)
        self.window_flops = 0.0
        self.attempted = self.failed = 0
        self.kept = {}  # sampled utterance -> its last output in the window
        self.prev = None

    # -- set-up --------------------------------------------------------------

    def _build(self, params):
        """-> (pipeline, plan, batch stream's keyword arguments, forward)."""
        from interspeech_ser_tpu_torch.extract import pipeline, streaming

        dtype, names = self.tr["dtype"], sorted(self.lengths)
        if self.cfg["model_type"] == "whisper":
            from interspeech_ser_tpu_torch.models.whisper import WhisperEncoderConfig, WhisperEncoderModel

            cfg = WhisperEncoderConfig.from_hf(self.cfg, dtype=dtype)
            with torch.device("meta"):
                model = WhisperEncoderModel(cfg)
            model.load_state_dict(params, strict=True, assign=True)
            pipe = pipeline.WhisperExtractionPipeline(model, cfg, batch_size=self.tr["batch_size"],
                                                      num_workers=self.tr["num_workers"], device=self.device)
            bs = pipe.batch_size
            # copy of the program's: WhisperExtractionPipeline.run's plan and stream arguments
            plan = [streaming.PlannedBatch(names[i: i + bs], [0] * len(names[i: i + bs]))
                    for i in range(0, len(names), bs)]
            kw = dict(bucket_quantum=pipe.N_SAMPLES, fixed_len=pipe.N_SAMPLES, row_multiple=bs)
            return pipe, plan, kw, lambda rb: pipe._forward(rb.wav)
        from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel

        cfg = SpeechConfig.from_hf(self.cfg, dtype=dtype)
        with torch.device("meta"):
            model = SpeechEncoderModel(cfg)
        model.load_state_dict(params, strict=True, assign=True)
        pipe = pipeline.SpeechExtractionPipeline(
            model, cfg, do_normalize=self.cfg["do_normalize"], token_budget=int(self.tr["token_budget_s"] * 16000),
            num_workers=self.tr["num_workers"], device=self.device)
        plan = pipe._plan(self.wav_dir, names, pipeline.ExtractionStats())
        return pipe, plan, dict(bucket_quantum=pipeline.BUCKET_QUANTUM), \
            lambda rb: pipe._forward(rb.wav, rb.mask, pipe.n_layer)

    def setup(self):
        from interspeech_ser_tpu_torch.extract import streaming

        run = self.run
        self.wav_dir = os.path.join(run.workdir, "wavs")
        self.lengths = corpus.wavs(self.wav_dir, self.tr, run.seed)
        f32 = self.tr["dtype"] == "float32"  # TF32 off in f32, as preprocess_cli sets it
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not f32
        params = weights.make(self.ref.param_shapes(self.cfg), run.seed, self.device)
        self.pipe, plan, kw, self.forward = self._build(params)
        load_one = partial(self.pipe._load_one, self.wav_dir)

        shapes = {}
        for b in plan:  # the first batch of each shape the plan has
            shapes.setdefault((len(b.names), -(-max(b.lengths) // kw["bucket_quantum"])), b)
        for rb in streaming.BatchStream(load_one, list(shapes.values()), num_workers=self.tr["num_workers"], **kw):
            host, ev = self._fetch(self.forward(rb))
            if ev is not None:
                ev.synchronize()
        self.stream = streaming.BatchStream(load_one, plan * (BATCHES // len(plan) + 1),
                                            num_workers=self.tr["num_workers"], **kw)
        self.it = iter(self.stream)
        self.plan_len, self.streamed = len(plan), 0

        names = sorted(self.lengths)
        rng = np.random.default_rng(sub_seed(run.seed, "sample"))
        k = min(self.tr["check_utterances"], len(names))
        self.sample = set(rng.choice(names, size=k, replace=False).tolist())
        self.sample.add(max(names, key=lambda n: (self.lengths[n], n)))
        self.per_utt = (lambda n: flops.whisper_flops(self.cfg)) if self.cfg["model_type"] == "whisper" \
            else (lambda n: flops.wavlm_flops(n, self.cfg))
        print(f"[portbench] {run.cell.name}: {len(names)} wavs, {sum(self.lengths.values()) / 16000:.1f} audio-s, "
              f"{len(plan)} batches a pass, {len(shapes)} shapes warmed", file=sys.stderr)

    # -- the window ------------------------------------------------------------

    def _fetch(self, sel: torch.Tensor):
        """Start the copy of the selected hidden state into pinned host memory
        (copy of the program's: ``_drive``'s ``fetch``)."""
        if self.device.type != "cuda":
            return sel, None
        host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=True)
        host.copy_(sel, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def _bound(self, rb) -> None:
        """K1's least time for this batch, every layer."""
        cfg = self.cfg
        if cfg["model_type"] == "whisper":
            T = cfg["max_source_positions"]
            frames, D, H, L, bias = [T] * rb.wav.shape[0], cfg["d_model"], cfg["encoder_attention_heads"], \
                cfg["encoder_layers"], False
        else:
            T = ref_wavlm.frame_count(rb.wav.shape[1], cfg)
            frames = [ref_wavlm.frame_count(n, cfg) for n in rb.lengths]
            D, H, L, bias = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"], True
        self.trace_bounds["K1"] += L * flops.k1_seconds(frames, T, D, H, bias, self.tr["dtype"])

    def _drain(self, rb, host, ev) -> int:
        spans = self.run.spans
        if ev is not None:
            with spans("d2h_wait"):
                ev.synchronize()
        if self.recording:
            for i, name in enumerate(rb.names):
                n = rb.lengths[i]
                self.window_flops += self.per_utt(n)
                if name in self.sample:
                    self.kept[name] = host[i, : self.ref.frame_count(n, self.cfg)].float().clone()
            self.attempted += len(rb.names)
        return len(rb.names)

    def step(self) -> int:
        spans = self.run.spans
        with spans("batch_wait"):
            rb = next(self.it)
        self.streamed += 1
        if self.recording:
            self.failed += rb.n_failed
            self.attempted += rb.n_failed
        if not rb.names:
            return 0
        with spans("forward"):
            sel = self.forward(rb)
            cur = (rb, *self._fetch(sel))
        if self.tracing:
            self._bound(rb)
        # copy of the program's: _drive's one-batch lag, batch k enqueued before k-1 is drained
        done = self._drain(*self.prev) if self.prev is not None else 0
        self.prev = cur
        return done

    def pass_done(self) -> bool:
        return self.streamed % self.plan_len == 0

    def finish(self) -> int:
        done = self._drain(*self.prev) if self.prev is not None else 0
        self.prev = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return done

    def end_to_end(self, window, setup_s):
        return {"extract_utt_per_s": window["units"] / window["seconds"], "setup_s": setup_s}

    # -- the check ---------------------------------------------------------------

    def free(self):
        self.it.close()  # stops the stream's threads
        self.pipe = self.forward = self.stream = self.it = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The window's sampled outputs against the reference, each
        utterance alone and unpadded -> ([(name, value, limit)], readings)."""
        p = weights.make(self.ref.param_shapes(self.cfg), self.run.seed, self.device)
        errs, ctrl = {}, {}
        with exact_float32(), torch.no_grad():
            for name in sorted(self.kept):
                wav = corpus.read_wav(os.path.join(self.wav_dir, name))
                if self.cfg.get("do_normalize"):
                    wav = ref_wavlm.normalize(wav)
                x = torch.from_numpy(wav).to(self.device)
                ref = self.ref.forward(p, self.cfg, x, Ops())
                errs[name] = rel_err(self.kept[name].to(self.device), ref)
                if self.run.control:
                    ctrl[name] = rel_err(self.ref.forward(p, self.cfg, x, Ops(tf32=True)), ref)
        worst = max(errs.values()) if errs else float("inf")
        print(f"[portbench] compared {len(errs)} of {len(self.sample)} sampled utterances "
              f"(the others did not finish in the window); worst {worst!r}", file=sys.stderr)
        readings = {"hidden_rel_err": worst}
        if ctrl:
            readings["control.hidden_rel_err"] = max(ctrl.values())
        return [("hidden_rel_err", worst, self.run.cell.limits["hidden_rel_err"])], readings
