"""The port's copy of the streaming extraction threads: header lengths,
planned-batch assembly, and a bounded stress run of decoder, assembler and
writer threads with more workers than cores."""

import os
import sys
import threading
import wave

import numpy as np
import pytest

from interspeech_ser_tpu_torch.extract import streaming
from interspeech_ser_tpu_torch.utils.audio import load_wav


def _write_wav(path, n, sr):
    pcm = (np.random.default_rng(n).normal(size=n) * 3000).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("sr,n", [(16000, 12345), (8000, 9999), (44100, 30001)])
def test_header_length_matches_decode(tmp_path, sr, n):
    p = str(tmp_path / "u.wav")
    _write_wav(p, n, sr)
    assert streaming.planned_wav_len(p) == len(load_wav(p)[0])


def test_stream_and_writer_stress():
    """Every planned row arrives once, in plan order, padded to its bucket,
    and every write lands, with 4x more threads than cores and a short
    switch interval; failed decodes drop their row and are counted."""
    lengths = {f"u{i}": 1000 + 137 * i for i in range(200)}
    plan = streaming.plan_batches(sorted(lengths.items()), token_budget=8000, bucket_quantum=1000)

    def load(name):
        return None if name == "u7" else np.full(lengths[name], float(name[1:]), np.float32)

    written, lock = [], threading.Lock()

    def write(name, row):
        with lock:
            written.append((name, float(row[0])))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = 4 * (os.cpu_count() or 1)
        writer = streaming.BoundedWriter(num_workers=workers, window=8)
        seen, failed = [], 0
        for rb in streaming.BatchStream(load, plan, bucket_quantum=1000, num_workers=workers):
            failed += rb.n_failed
            assert rb.wav.shape[1] % 1000 == 0 and rb.wav.shape == rb.mask.shape
            for i, name in enumerate(rb.names):
                assert rb.mask[i].sum() == lengths[name] == rb.lengths[i]
                seen.append(name)
                writer.submit(write, name, rb.wav[i])
        writer.drain()
    finally:
        sys.setswitchinterval(old)
    assert failed == 1
    assert seen == [n for b in plan for n in b.names if n != "u7"]
    assert sorted(written) == sorted((n, float(n[1:])) for n in seen)
