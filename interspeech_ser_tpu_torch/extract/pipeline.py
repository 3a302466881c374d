"""Batched, bucketed embedding extraction.

Port of ``interspeech_ser_tpu/extract/pipeline.py::SpeechExtractionPipeline``,
``WhisperExtractionPipeline`` and ``TextExtractionPipeline``:

  header-only batch plan (exact post-resample lengths, length-sorted
  token-budget batches, 1-s buckets)  ->  decoder threads + assembler
  feeding a bounded queue  ->  device loop: batch k is enqueued on the card,
  and its selected hidden state starts an async copy into pinned host
  memory, before batch k-1 is written out  ->  backpressured per-utterance
  ``.pt`` writer threads. Machinery in ``extract/streaming.py``.

Layer selection: ``n_layer`` (HF hidden_states indexing, -1 = last) or the
mean of the last 4 (``use_average``). ``replicate_dir_count_bug`` reproduces
the reference's ``hidden_states[len(os.listdir(save_path))]`` quirk.
``SER_TPU_SKIP_EXISTING=1`` skips utterances whose ``.pt`` already exists.

Whisper: fixed [8, 480000] batches (30 s, longer audio cut) in name order,
raw waveforms, the log-mel computed on the device, and the output cut to
``min(ceil(len / 320), 1500)`` frames.

NS3 FACodec prosody: each wav padded by ``200 - len % 200`` zeros (200 on a
multiple, the reference's pad), length-sorted batches of ``batch_size``
rows (zero rows fill the last) padded to a multiple of 3200 samples, each
utterance reflect-padded on the host for the mel, and ``len / 200`` frames
kept; ``codes`` saves the int32 VQ indices of the literal forward instead.

Text: transcripts in CSV order, batches of ``batch_size`` tokenized to
``max_length`` (``padding='max_length'``, truncation), through the same
device loop; the output is the FULL padded [max_length, D] row. A
transcription that is not a string tokenizes as ``""``.

Output contract: ``save_path/<utt>.pt``, a float32 [T_valid, D] tensor
(text: [max_length, D]).

Spans (``utils/profiling``, recorded while a profiler session records):
every ``_forward`` holds ``forward.h2d`` (the batch's inputs made on the
host, pinned and their copies enqueued) and ``forward.encoder`` (the rest:
Whisper's log-mel, the model, the layer select or average, enqueued).

Multi-device (one process a rank, ``parallel/mesh.py``): the one-device
batch plan is kept, and data rank r of n takes whole batches r, r + n, ...
and writes its own rows' files, so every file equals the one-device run's
(a group-norm frontend's padding included) and no gather is needed; the
stats are summed over the data axis by one all-reduce at the end.
``SpeechExtractionPipeline(model_parallel=mp)`` adds a model axis: the mp
ranks of a model group run the same batches on their shard of the encoder
(``parallel/tp.py``) and model rank 0 writes. ``n_devices`` is the number
of ranks (``None``: the world's).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.ns3.facodec import HOP
from ..models.speech import feat_extract_output_length, with_config
from ..ops.mel import NS3_PAD, whisper_log_mel
from ..parallel.mesh import Mesh, all_reduce_numbers, barrier, make_mesh
from ..parallel.tp import shard_speech_model
from ..utils import ptio
from ..utils.audio import load_wav, normalize_waveform
from ..utils.device import resolve_device
from ..utils.profiling import span
from . import streaming

BUCKET_QUANTUM = 16000  # batches pad to whole seconds of 16-kHz audio
NS3_BUCKET = 3200  # samples: NS3 batches pad to a multiple of 16 frames


@dataclass
class ExtractionStats:
    n_utts: int = 0
    n_failed: int = 0
    n_skipped: int = 0  # SER_TPU_SKIP_EXISTING resume
    n_batches: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def utts_per_sec(self) -> float:
        return self.n_utts / self.wall_seconds if self.wall_seconds else 0.0

    def summed(self, mesh: Mesh, shared_failed: int = 0) -> "ExtractionStats":
        """The counts summed over the data axis by one all-reduce; the
        ``shared_failed`` failures every rank counted (the plan's header
        reads) and the skips (every rank sees the same files) count once, and
        the wall time is this rank's."""
        if mesh.data == 1:
            return self
        n_utts, n_failed, n_batches, audio = all_reduce_numbers(
            mesh, [self.n_utts, self.n_failed - shared_failed, self.n_batches, self.audio_seconds])
        return ExtractionStats(n_utts=int(n_utts), n_failed=int(n_failed) + shared_failed, n_skipped=self.n_skipped,
                               n_batches=int(n_batches), audio_seconds=audio, wall_seconds=self.wall_seconds)


def _skip_existing(names: Sequence[str], save_path: str, stats: ExtractionStats) -> Sequence[str]:
    """SER_TPU_SKIP_EXISTING=1 -> skip utterances whose ``.pt`` exists (the
    writer is atomic). Off by default, as in the reference."""
    if os.environ.get("SER_TPU_SKIP_EXISTING") != "1":
        return names

    def done(n):
        stem = os.path.splitext(os.path.basename(n))[0]
        return os.path.exists(os.path.join(save_path, f"{stem}.pt"))

    kept = [n for n in names if not done(n)]
    stats.n_skipped = len(names) - len(kept)
    return kept


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(x)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def discard(name: str, row: torch.Tensor) -> None:
    """``_drive``'s sink for a rank that writes nothing."""


def _drive(
    stream,
    forward: Callable,  # ReadyBatch -> selected hidden state [B, T, D] on the device
    n_frames: Callable[[int, int], int],  # (samples, T) -> valid frames
    save_path: str,
    stats: ExtractionStats,
    num_workers: int,
    cuda: bool,
    sink: Optional[Callable[[str, torch.Tensor], None]] = None,
) -> None:
    """The device loop: batch k is enqueued on the card, and its selected
    hidden state starts an async copy into pinned host memory, before batch
    k-1 is handed on. Each utterance's host row (what its file holds, as a
    view of its batch's host tensor) goes to ``sink(name, host_row)`` on this
    thread; with no sink, to ``save_path/<utt>.pt`` by the bounded writer
    threads. ``sink=discard`` (a model rank other than 0) counts the batches,
    copies nothing to the host and writes nothing."""
    writer = None
    if sink is None:
        writer = streaming.BoundedWriter(num_workers=num_workers)

        def sink(name: str, row: torch.Tensor) -> None:  # save_tensor writes a compact clone of the row
            stem = os.path.splitext(os.path.basename(name))[0]
            writer.submit(ptio.save_tensor, row, os.path.join(save_path, f"{stem}.pt"))

    def fetch(sel: torch.Tensor):
        """Start the device-to-host copy; return (host tensor, done event)."""
        if not cuda:
            return sel, None
        host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=True)
        host.copy_(sel, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def drain(rb, host, ev) -> None:
        if ev is not None:
            ev.synchronize()
        feats = host.float() if host.is_floating_point() else host  # NS3 codes stay int32
        for i, name in enumerate(rb.names):
            sink(name, feats[i, :n_frames(rb.lengths[i], feats.shape[1])])
            stats.n_utts += 1
            stats.audio_seconds += rb.lengths[i] / 16000.0

    prev = None
    for rb in stream:
        stats.n_failed += rb.n_failed
        if not rb.names:
            continue
        sel = forward(rb)
        stats.n_batches += 1
        cur = (rb, sel, None) if sink is discard else (rb, *fetch(sel))
        if prev is not None:
            drain(*prev)  # host writes of k-1 overlap the device work of k
        prev = cur
    if prev is not None:
        drain(*prev)
    if writer is not None:
        writer.drain()


class SpeechExtractionPipeline:
    """wav dir -> per-utterance SSL embeddings (WavLM, wav2vec2, HuBERT).

    Batches pad to whole seconds as in the JAX pipeline; a group-norm
    frontend's statistics then take in the padded samples, as the JAX
    package's do, so a batched utterance may differ from its batch-1 run
    there (a layer-norm frontend normalises each frame on its own)."""

    def __init__(
        self,
        model,  # SpeechEncoderModel, f32 parameters
        config,  # SpeechConfig
        n_layer: int = -1,
        use_average: bool = False,
        do_normalize: bool = True,
        token_budget: Optional[int] = None,  # samples per batch
        num_workers: int = 8,
        replicate_dir_count_bug: bool = False,
        device="cuda",  # "cpu" only when asked: no card raises
        n_devices: Optional[int] = None,  # ranks; None: the world's
        model_parallel: int = 1,  # ranks a model group (tensor parallelism)
    ):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices, model_parallel=model_parallel)
        # extraction is inference only: the no-backward kernels (K8, and K5
        # under SER_TPU_FFN_KERNEL=1) on a copy of the config, the same
        # parameters, and K2's depth from default_fused_frontend
        config = dataclasses.replace(config, inference_kernels=True)
        model = with_config(model, config)
        # tensor parallelism: this rank's shard of the attentions and feed-forwards
        model = shard_speech_model(model, self.mesh)
        config = model.config
        # bf16 mode: cast the frozen parameters once (norms still compute in
        # f32 on the bf16 values)
        model = model.to(self.device)
        if config.compute_dtype == torch.bfloat16:
            model = model.to(torch.bfloat16)
        self.model = model.eval()
        self.config = config
        self.n_layer = n_layer
        self.use_average = use_average
        self.do_normalize = do_normalize
        if token_budget is None:
            # size-aware default: 320 s of audio per batch up to D=1024,
            # 160 s for wider encoders
            token_budget = 16000 * (320 if config.hidden_size <= 1024 else 160)
        self.token_budget = token_budget
        self.num_workers = num_workers
        self.replicate_dir_count_bug = replicate_dir_count_bug

    @torch.inference_mode()
    def _forward(self, wav: np.ndarray, mask: np.ndarray, n_layer: int) -> torch.Tensor:
        """Selected hidden state [B, T, D] in the compute dtype, on the device."""
        with span("forward.h2d"):
            wav_t, mask_t = _to_device(wav, self.device), _to_device(mask, self.device)
        with span("forward.encoder"):
            keep = (-4, -3, -2, -1) if self.use_average else (n_layer,)
            hs = self.model(wav_t, mask_t, keep=keep)["hidden_states"]
            if self.use_average:
                return (hs[-4] + hs[-3] + hs[-2] + hs[-1]) / 4.0
            return hs[n_layer]

    def _load_one(self, wav_dir: str, name: str) -> Optional[np.ndarray]:
        path = os.path.join(wav_dir, name)
        try:
            y, _sr = load_wav(path, target_sr=16000)
            return normalize_waveform(y, self.do_normalize)
        except Exception as e:  # skip-and-log like the reference
            print(f"Failed to process {path}: {e}")
            return None

    def _plan(self, wav_dir: str, wav_names: Sequence[str], stats: ExtractionStats):
        """Header-only batch plan (no audio decoded; exact lengths)."""

        def one(name: str):
            try:
                return name, streaming.planned_wav_len(os.path.join(wav_dir, name))
            except Exception:
                w = self._load_one(wav_dir, name)  # odd container: decode for the length
                return (name, len(w)) if w is not None else None

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            results = list(pool.map(one, wav_names))
        planned = [r for r in results if r is not None]
        stats.n_failed += len(results) - len(planned)
        return streaming.plan_batches(planned, self.token_budget, BUCKET_QUANTUM)

    def run(self, wav_dir: str, save_path: str, wav_names: Optional[Sequence[str]] = None) -> ExtractionStats:
        os.makedirs(save_path, exist_ok=True)
        n_layer = self.n_layer
        if self.replicate_dir_count_bug:
            n_layer = len(os.listdir(save_path))
        if wav_names is None:
            wav_names = sorted(os.listdir(wav_dir))
        stats = ExtractionStats()
        t0 = time.perf_counter()

        wav_names = _skip_existing(wav_names, save_path, stats)
        barrier(self.mesh)  # every rank has read the save dir before any rank writes to it
        plan = self._plan(wav_dir, wav_names, stats)
        shared_failed = stats.n_failed
        stream = streaming.BatchStream(
            partial(self._load_one, wav_dir), plan[self.mesh.data_rank:: self.mesh.data], BUCKET_QUANTUM,
            num_workers=self.num_workers,
        )
        _drive(stream, lambda rb: self._forward(rb.wav, rb.mask, n_layer),
               lambda n, T: feat_extract_output_length(n, self.config), save_path, stats,
               self.num_workers, self.device.type == "cuda", None if self.mesh.model_rank == 0 else discard)
        stats.wall_seconds = time.perf_counter() - t0
        return stats.summed(self.mesh, shared_failed)


class WhisperExtractionPipeline:
    """wav dir -> Whisper-encoder embeddings, cut to each utterance's frames."""

    N_SAMPLES = 480000  # 30 s at 16 kHz

    def __init__(
        self,
        model,  # WhisperEncoderModel, f32 parameters
        config,  # WhisperEncoderConfig
        n_layer: int = -1,
        use_average: bool = False,
        batch_size: int = 8,
        num_workers: int = 8,
        device="cuda",  # "cpu" only when asked: no card raises
        n_devices: Optional[int] = None,  # ranks; None: the world's
    ):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        model = model.to(self.device)
        if config.compute_dtype == torch.bfloat16:
            model = model.to(torch.bfloat16)  # cast once
        self.model = model.eval()
        self.config = config
        self.n_layer = n_layer
        self.use_average = use_average
        self.batch_size = batch_size
        self.num_workers = num_workers

    @torch.inference_mode()
    def _forward(self, wav: np.ndarray) -> torch.Tensor:
        with span("forward.h2d"):
            wav_t = _to_device(wav, self.device)
        with span("forward.encoder"):
            mel = whisper_log_mel(wav_t, self.config.num_mel_bins)
            keep = (-4, -3, -2, -1) if self.use_average else (self.n_layer,)
            hs = self.model(mel, keep=keep)["hidden_states"]
            if self.use_average:
                return (hs[-4] + hs[-3] + hs[-2] + hs[-1]) / 4.0
            return hs[self.n_layer]

    def _load_one(self, wav_dir: str, name: str) -> Optional[np.ndarray]:
        try:
            return load_wav(os.path.join(wav_dir, name), target_sr=16000)[0]
        except Exception as e:  # skip-and-log like the reference
            print(f"Failed to process {name}: {e}")
            return None

    def run(self, wav_dir: str, save_path: str, wav_names: Optional[Sequence[str]] = None) -> ExtractionStats:
        os.makedirs(save_path, exist_ok=True)
        if wav_names is None:
            wav_names = sorted(os.listdir(wav_dir))
        stats = ExtractionStats()
        t0 = time.perf_counter()
        wav_names = _skip_existing(wav_names, save_path, stats)
        barrier(self.mesh)  # every rank has read the save dir before any rank writes to it
        bs = self.batch_size
        plan = [streaming.PlannedBatch(list(wav_names[i: i + bs]), [0] * len(wav_names[i: i + bs]))
                for i in range(0, len(wav_names), bs)]
        stream = streaming.BatchStream(
            partial(self._load_one, wav_dir), plan[self.mesh.data_rank:: self.mesh.data], self.N_SAMPLES,
            num_workers=self.num_workers, fixed_len=self.N_SAMPLES, row_multiple=bs,
        )
        _drive(stream, lambda rb: self._forward(rb.wav), lambda n, T: min(math.ceil(n / 320), T),
               save_path, stats, self.num_workers, self.device.type == "cuda")
        stats.wall_seconds = time.perf_counter() - t0
        return stats.summed(self.mesh)


def ns3_batch_inputs(wav: np.ndarray, lengths: Sequence[int]):
    """The host half of ``ProsodyExtractor.extract_batched`` for a batch
    zero-padded to its bucket -> (wav_reflect [B, Lb + 824], each utterance
    reflect-padded by 412 samples before the bucket's zeros; frame_mask
    [B, Lb / 200], 1 on each utterance's frames)."""
    B, Lb = wav.shape
    refl = np.zeros((B, Lb + 2 * NS3_PAD), np.float32)
    fmask = np.zeros((B, Lb // HOP), np.float32)
    for i, n in enumerate(lengths):
        refl[i, : n + 2 * NS3_PAD] = np.pad(wav[i, :n], (NS3_PAD, NS3_PAD), mode="reflect")
        fmask[i, : n // HOP] = 1
    return refl, fmask


class ProsodyExtractionPipeline:
    """wav dir -> per-utterance NS3 FACodec prosody features, [len / 200,
    256] (speaker variant: 512), or with ``codes`` the [len / 200] int32 VQ
    indices.

    The plan reads WAV headers only; a file whose decode fails after its
    header was read drops out of its planned batch, where the reference
    would have regrouped the rest (``codes`` depends on an utterance's batch
    row; the features do not)."""

    def __init__(
        self,
        extractor,  # ProsodyExtractor, f32
        batch_size: int = 16,
        codes: bool = False,
        num_workers: int = 4,
        device="cuda",  # "cpu" only when asked: no card raises
    ):
        self.device = resolve_device(device)
        self.extractor = extractor.to(self.device).eval()
        self.batch_size = batch_size
        self.codes = codes
        self.num_workers = num_workers

    def _load_one(self, wav_dir: str, name: str) -> Optional[np.ndarray]:
        try:
            y, _ = load_wav(os.path.join(wav_dir, name), target_sr=16000)
            return np.pad(y, (0, HOP - len(y) % HOP))  # the reference's pad, 200 zeros on a multiple
        except Exception as e:  # skip-and-log like the reference
            print(f"Failed to process {name}: {e}")
            return None

    def _plan(self, wav_dir: str, wav_names: Sequence[str], stats: ExtractionStats):
        """Length-sorted batches of ``batch_size`` at the padded lengths, from headers."""

        def one(name: str):
            try:
                n = streaming.planned_wav_len(os.path.join(wav_dir, name))
                return name, n + HOP - n % HOP
            except Exception:
                w = self._load_one(wav_dir, name)  # odd container: decode for the length
                return (name, len(w)) if w is not None else None

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            results = list(pool.map(one, wav_names))
        planned = sorted((r for r in results if r is not None), key=lambda kv: kv[1])
        stats.n_failed += len(results) - len(planned)
        bs = self.batch_size
        return [streaming.PlannedBatch([n for n, _ in planned[i: i + bs]], [n for _, n in planned[i: i + bs]])
                for i in range(0, len(planned), bs)]

    @torch.inference_mode()
    def _forward(self, rb) -> torch.Tensor:
        with span("forward.h2d"):
            wav = _to_device(rb.wav, self.device)
            if not self.codes:
                refl, fmask = ns3_batch_inputs(rb.wav, rb.lengths)
                refl, fmask = _to_device(refl, self.device), _to_device(fmask, self.device)
        with span("forward.encoder"):
            if self.codes:
                return self.extractor.codes(wav)
            return self.extractor.extract_batched(wav, refl, fmask)

    def run(self, wav_dir: str, save_path: str, wav_names: Optional[Sequence[str]] = None) -> ExtractionStats:
        os.makedirs(save_path, exist_ok=True)
        if wav_names is None:
            wav_names = sorted(os.listdir(wav_dir))
        stats = ExtractionStats()
        t0 = time.perf_counter()
        wav_names = _skip_existing(wav_names, save_path, stats)
        stream = streaming.BatchStream(
            partial(self._load_one, wav_dir), self._plan(wav_dir, wav_names, stats), NS3_BUCKET,
            num_workers=self.num_workers, row_multiple=self.batch_size,
        )
        _drive(stream, self._forward, lambda n, T: n // HOP, save_path, stats, self.num_workers,
               self.device.type == "cuda")
        stats.wall_seconds = time.perf_counter() - t0
        return stats


@dataclass
class TextBatch:
    """One tokenized batch, in the shape ``_drive`` reads."""

    names: List[str]
    ids: np.ndarray  # [B, max_length] int64
    mask: np.ndarray  # [B, max_length] int64
    lengths: List[int]  # no audio: zeros, so audio_seconds stays 0
    n_failed: int = 0


class TextExtractionPipeline:
    """transcripts -> per-utterance text embeddings (RoBERTa / DeBERTa-v2).

    Reference semantics (preprocessing/preprocess_roberta.py): tokenize with
    ``padding='max_length'``, ``max_length`` (80) and truncation, and save
    the full padded [max_length, D] hidden state (``n_layer``, HF indexing)
    or the mean of the last 4, keyed by ``FileName``'s stem. Batches need no
    padding to a static size: each row's forward depends on its own tokens
    only."""

    def __init__(
        self,
        model,  # RobertaModel or DebertaV2Model, f32 parameters
        config,  # its config
        tokenize: Callable[[List[str]], Dict[str, np.ndarray]],
        n_layer: int = -1,
        use_average: bool = False,
        batch_size: int = 64,
        num_workers: int = 8,
        device="cuda",  # "cpu" only when asked: no card raises
        n_devices: Optional[int] = None,  # ranks; None: the world's
    ):
        self.device = resolve_device(device)
        self.mesh = make_mesh(n_devices)
        model = model.to(self.device)
        if config.compute_dtype == torch.bfloat16:
            model = model.to(torch.bfloat16)  # cast once
        self.model = model.eval()
        self.config = config
        self.tokenize = tokenize
        self.n_layer = n_layer
        self.use_average = use_average
        self.batch_size = batch_size
        self.num_workers = num_workers

    @torch.inference_mode()
    def _forward(self, tb: TextBatch) -> torch.Tensor:
        """Selected hidden state [B, max_length, D] in the compute dtype, on the device."""
        with span("forward.h2d"):
            ids, mask = _to_device(tb.ids, self.device), _to_device(tb.mask, self.device)
        with span("forward.encoder"):
            keep = (-4, -3, -2, -1) if self.use_average else (self.n_layer,)
            hs = self.model(ids, mask, keep=keep)["hidden_states"]
            if self.use_average:
                return (hs[-4] + hs[-3] + hs[-2] + hs[-1]) / 4.0
            return hs[self.n_layer]

    def _batches(self, names: Sequence[str], texts: Sequence):
        """The rank's batches: r, r + n, ... of the one-device run's."""
        bs, m = self.batch_size, self.mesh
        for start in range(m.data_rank * bs, len(names), m.data * bs):
            chunk = [t if isinstance(t, str) else "" for t in texts[start: start + bs]]
            toks = self.tokenize(chunk)
            yield TextBatch(list(names[start: start + bs]), np.asarray(toks["input_ids"], np.int64),
                            np.asarray(toks["attention_mask"], np.int64), [0] * len(chunk))

    def run(self, names: Sequence[str], texts: Sequence, save_path: str) -> ExtractionStats:
        os.makedirs(save_path, exist_ok=True)
        stats = ExtractionStats()
        t0 = time.perf_counter()
        kept = set(_skip_existing(names, save_path, stats))
        barrier(self.mesh)  # every rank has read the save dir before any rank writes to it
        if len(kept) < len(names):
            pairs = [(n, t) for n, t in zip(names, texts) if n in kept]
            names, texts = [n for n, _ in pairs], [t for _, t in pairs]
        _drive(self._batches(names, texts), self._forward, lambda n, T: T, save_path, stats,
               self.num_workers, self.device.type == "cuda")
        stats.wall_seconds = time.perf_counter() - t0
        return stats.summed(self.mesh)
