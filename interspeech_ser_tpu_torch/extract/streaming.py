"""Bounded-memory streaming machinery for the extraction pipeline.

A copy of ``interspeech_ser_tpu/extract/streaming.py`` (host threads and
numpy only), so that host RSS stays bounded at corpus scale and the card
never idles on host I/O:

  planner: WAV *headers* only -> exact post-resample lengths ->
           length-sorted token-budget batch plan (no audio decoded yet)
  decoder threads: sliding-window decode in plan order (bounded in-flight)
  assembler thread: pad/mask each planned batch -> bounded queue
  device loop: enqueue batch k, then write out batch k-1
  writer threads: per-utterance ``.pt`` writes, bounded pending set

Memory bound ~ queue_depth x batch arrays + decode window x one waveform +
writer window x one feature slice, independent of corpus size.

Spans and counters (``utils/profiling``, recorded while a profiler session
records): ``stream.decode`` one a wav on the decode threads,
``stream.assemble`` one a batch on the assembler, ``stream.put_wait`` the
assembler's wait on a full queue (the host running ahead of the card),
``stream.get_wait`` the consumer's wait on the queue (the card's loop
waiting on host I/O), and the
counters ``stream.live_samples`` / ``stream.padded_samples``: the real
samples kept against ``B x T`` of each assembled batch.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
import wave
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import count, span


def planned_wav_len(path: str, target_sr: int = 16000) -> int:
    """Post-resample sample count from the WAV header alone (no decode).

    ``scipy.signal.resample_poly`` (and the native sinc resampler) return
    ``ceil(n * up / down)`` samples; mono mixdown keeps the frame count. So
    the header frame count fully determines the decoded length.
    """
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        sr = w.getframerate()
    if sr == target_sr:
        return n
    return -(-n * target_sr // sr)  # ceil(n * target_sr / sr)


def bounded_map(pool: cf.ThreadPoolExecutor, fn: Callable, items: Iterable,
                window: int) -> Iterator:
    """``pool.map`` with a bounded in-flight window, yielding in order."""
    futs: deque = deque()
    it = iter(items)
    for item in it:
        futs.append(pool.submit(fn, item))
        if len(futs) >= window:
            yield futs.popleft().result()
    while futs:
        yield futs.popleft().result()


@dataclass
class PlannedBatch:
    names: List[str]
    lengths: List[int]  # planned (== decoded) sample counts


@dataclass
class ReadyBatch:
    names: List[str]           # valid rows only, row i ↔ wav[i]
    lengths: List[int]         # decoded sample count per valid row
    wav: np.ndarray            # [B, T] float32
    mask: np.ndarray           # [B, T] float32
    n_failed: int = 0


def plan_batches(
    names_and_lengths: Sequence[Tuple[str, int]],
    token_budget: int,
    bucket_quantum: int,
) -> List[PlannedBatch]:
    """Length-sorted token-budget batching at bucketed lengths.

    Stable sort by length, greedy fill while ``(rows+1) * bucketed_max_len``
    fits the budget.
    """
    items = sorted(names_and_lengths, key=lambda kv: kv[1])
    batches: List[PlannedBatch] = []
    cur = PlannedBatch([], [])
    for name, n in items:
        blen = max(bucket_quantum, -(-n // bucket_quantum) * bucket_quantum)
        if cur.names and (len(cur.names) + 1) * blen > token_budget:
            batches.append(cur)
            cur = PlannedBatch([], [])
        cur.names.append(name)
        cur.lengths.append(n)
    if cur.names:
        batches.append(cur)
    return batches


class BatchStream:
    """Decode + assemble planned batches into a bounded queue.

    ``load_one(name) -> Optional[np.ndarray]`` runs on ``num_workers``
    threads with a sliding in-flight window; one assembler thread pads each
    planned batch to its bucketed length (or to ``fixed_len``, cutting longer
    waveforms, which keep their true length for frame accounting; rows
    rounded up to ``row_multiple``) and enqueues it. ``queue_depth``
    bounds assembled batches held in host RAM. Decode failures drop the row
    (skip-and-log lives in ``load_one``) and are counted per batch.
    """

    _SENTINEL = None

    def __init__(
        self,
        load_one: Callable[[str], Optional[np.ndarray]],
        plan: Sequence[PlannedBatch],
        bucket_quantum: int,
        num_workers: int = 8,
        queue_depth: int = 2,
        fixed_len: Optional[int] = None,
        row_multiple: int = 1,
    ):
        self.load_one = load_one
        self.plan = plan
        self.bucket_quantum = bucket_quantum
        self.num_workers = num_workers
        self.fixed_len = fixed_len
        self.row_multiple = row_multiple
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._err: Optional[BaseException] = None
        # set when the consumer abandons iteration (device error mid-run):
        # the producer's bounded put must not deadlock on a full queue
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer is gone."""
        with span("stream.put_wait"):
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

    def _decode(self, name: str) -> Optional[np.ndarray]:
        with span("stream.decode"):
            return self.load_one(name)

    def _assemble(self, batch: PlannedBatch, waves: List[Optional[np.ndarray]]) -> Optional[ReadyBatch]:
        ok = [(n, w) for n, w in zip(batch.names, waves) if w is not None]
        n_failed = len(batch.names) - len(ok)
        if not ok:
            return ReadyBatch([], [], np.zeros((0, 0), np.float32),
                              np.zeros((0, 0), np.float32), n_failed)
        if self.fixed_len is not None:
            T = self.fixed_len
        else:
            tmax = max(len(w) for _, w in ok)
            T = max(self.bucket_quantum, -(-tmax // self.bucket_quantum) * self.bucket_quantum)
        B = -(-len(ok) // self.row_multiple) * self.row_multiple
        wav = np.zeros((B, T), np.float32)
        mask = np.zeros((B, T), np.float32)
        live = 0
        for i, (_, w) in enumerate(ok):
            m = min(len(w), T)
            wav[i, :m] = w[:m]
            mask[i, :m] = 1.0
            live += m
        count("stream.live_samples", live)
        count("stream.padded_samples", B * T)
        return ReadyBatch([n for n, _ in ok], [len(w) for _, w in ok],
                          wav, mask, n_failed)

    def _produce(self) -> None:
        pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            flat = [n for b in self.plan for n in b.names]
            window = max(2 * self.num_workers, 1)
            gen = bounded_map(pool, self._decode, flat, window)
            for batch in self.plan:
                waves = [next(gen) for _ in batch.names]
                with span("stream.assemble"):
                    rb = self._assemble(batch, waves)
                if not self._put(rb):
                    return  # consumer abandoned iteration
        except BaseException as e:  # surface on the consumer side
            self._err = e
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
            self._put(self._SENTINEL)

    def __iter__(self) -> Iterator[ReadyBatch]:
        # single-use: the finally below sets the shared _stop event, so a
        # second pass would see a dead producer and block forever on the
        # queue — fail loudly instead (callers re-plan a fresh stream).
        if self._stop.is_set() or getattr(self, "_thread", None) is not None:
            raise RuntimeError(
                "BatchStream is single-use; build a new one to re-stream"
            )
        t = threading.Thread(target=self._produce, daemon=True)
        self._thread = t  # exposed for the abort-regression test
        t.start()
        try:
            while True:
                with span("stream.get_wait"):
                    item = self.q.get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            # normal exit or consumer abort (exception at the yield /
            # GeneratorExit): release the producer if it is blocked on a
            # full queue, then reap the thread — no leaked pools/batches
            self._stop.set()
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10)
        if self._err is not None:
            raise self._err


class BoundedWriter:
    """Threaded per-utterance writer with a bounded pending set.

    Backpressure: ``submit`` blocks once ``window`` writes are in flight, so
    fetched feature slices never pile up faster than the disk drains them.
    """

    def __init__(self, num_workers: int = 8, window: int = 64):
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self.sem = threading.Semaphore(window)
        self.window = window
        self._futs: List[cf.Future] = []
        self._first_err: Optional[BaseException] = None
        self._err_lock = threading.Lock()

    def _on_done(self, fut: cf.Future) -> None:
        exc = fut.exception()
        if exc is not None:
            with self._err_lock:
                if self._first_err is None:
                    self._first_err = exc
        self.sem.release()

    def submit(self, fn: Callable, *args) -> None:
        # fail FAST: a persistent write failure (disk full, permissions)
        # surfaces at the next submit, not hours later at final drain —
        # extraction must not burn the whole corpus on the device first
        if self._first_err is not None:
            raise self._first_err
        self.sem.acquire()
        fut = self.pool.submit(fn, *args)
        fut.add_done_callback(self._on_done)
        self._futs.append(fut)
        # prune settled futures so the pending list stays O(window), not
        # O(corpus) — this class exists to bound memory
        if len(self._futs) > 2 * self.window:
            self._futs = [f for f in self._futs if not f.done()]

    def drain(self) -> None:
        for f in self._futs:
            f.result()  # re-raises writer errors
        self._futs.clear()
        if self._first_err is not None:
            raise self._first_err
