"""Faults planted in the program, for the readings a limit is set from and for the tests.

Each is a context manager that patches one of the program's methods for
its duration, as a broken change to the program would:

- extraction: ``answer_altered`` (each utterance's first output frame, a
  token of its answer, moved by 0.05 in every channel), ``half_batch``
  (the second half of each batch never computed: zeros),
  ``state_unchanged`` (the encoder's layers skipped: the selected state is
  the input embedding);
- training: ``state_unchanged`` (the optimizer step does nothing),
  ``half_batch`` (each step's loss the mean over the first half of its
  rows), ``answer_altered`` (the first logit of every row moved by 0.05).
"""

from __future__ import annotations

import contextlib

import torch

EXTRACT = ("answer_altered", "half_batch", "state_unchanged")
TRAIN = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _alter(fault, out, embedding):
    if fault == "answer_altered":
        out[:, 0, :] += 0.05
    elif fault == "half_batch":
        out[(out.shape[0] + 1) // 2:] = 0
    else:
        out = embedding()
    return out


@contextlib.contextmanager
def extraction(fault: str):
    from interspeech_ser_tpu_torch.extract import pipeline

    speech, whisper = pipeline.SpeechExtractionPipeline._forward, pipeline.WhisperExtractionPipeline._forward

    def speech_fwd(self, wav, mask, n_layer):
        with torch.inference_mode():
            return _alter(fault, speech(self, wav, mask, n_layer).clone(), lambda: speech(self, wav, mask, 0))

    def whisper_fwd(self, wav):
        def embedding():
            keep, self.n_layer = self.n_layer, 0
            try:
                return whisper(self, wav)
            finally:
                self.n_layer = keep

        with torch.inference_mode():
            return _alter(fault, whisper(self, wav).clone(), embedding)

    with _patched(pipeline.SpeechExtractionPipeline, "_forward", speech_fwd), \
            _patched(pipeline.WhisperExtractionPipeline, "_forward", whisper_fwd):
        yield


@contextlib.contextmanager
def training(fault: str):
    from interspeech_ser_tpu_torch.train import engine

    E = engine.FusionEngine
    if fault == "state_unchanged":
        patch = ("apply_gradients", lambda self, lr, n_micro=1: self.optimizer.zero_grad(set_to_none=True))
    elif fault == "half_batch":
        acc = E.accumulate_gradients

        def half(self, batch, class_w):
            mask = batch.sample_mask.copy()
            mask[(len(mask) + 1) // 2:] = 0
            return acc(self, engine.Batch(batch.feats, batch.masks, batch.labels, mask, batch.aux), class_w)

        patch = ("accumulate_gradients", half)
    else:
        fwd = E._forward

        def altered(self, feats, masks, generator=None):
            out = fwd(self, feats, masks, generator)
            shift = torch.zeros(out["logits"].shape[1], device=out["logits"].device)
            shift[0] = 0.05
            out["logits"] = out["logits"] + shift
            return out

        patch = ("_forward", altered)
    with _patched(E, *patch):
        yield


def planted(driver: str, fault: str):
    return (extraction if driver == "extract" else training)(fault)
