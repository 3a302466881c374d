"""The port's own spans and counters (``utils/profiling``: ``span``, ``count``,
``snapshot``, ``reset``) on the extraction path, and the benchmark's readers
of them (``portbench/metrics``), on the CPU.

Off (no ``torch.profiler`` session recording) a span or a counter reads one
flag: no clock, no lock, no record. On, every span and counter is summed
from any thread, and a span on the session's thread is also a ``ser.<name>``
range of the Chrome trace."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from interspeech_ser_tpu_torch.extract import pipeline, streaming
from interspeech_ser_tpu_torch.utils import profiling
from portbench.bench import ROOT as BENCH_ROOT, metric_reader

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    yield
    profiling.reset()


class _Session:
    """A profiler session started by ``with profile(...)`` or by ``start()`` / ``stop()``."""

    def __init__(self, how):
        self.how = how
        self.prof = profile(activities=[ProfilerActivity.CPU])

    def __enter__(self):
        if self.how == "with":
            self.prof.__enter__()
        else:
            self.prof.start()
        return self.prof

    def __exit__(self, *exc):
        if self.how == "with":
            self.prof.__exit__(*exc)
        else:
            self.prof.stop()
        return False


def _ser_ranges(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("ser.")]


# -- a tiny stream over generated wavs ---------------------------------------------------

LENGTHS = [1200, 3100, 800, 4000, 2500, 1700, 3900]
FAILED = "utt3"  # its decode fails: the row drops out of its batch


def _waves():
    rng = np.random.default_rng(0)
    return {f"utt{i}": (None if f"utt{i}" == FAILED else rng.normal(size=n).astype(np.float32) * 0.1)
            for i, n in enumerate(LENGTHS)}


LAYOUTS = {  # BatchStream keyword arguments: the speech pipelines' buckets, Whisper's fixed length and rows
    "bucketed": dict(bucket_quantum=1000),
    "fixed_len": dict(bucket_quantum=2000, fixed_len=2000, row_multiple=4),
    "row_multiple": dict(bucket_quantum=500, row_multiple=3),
}


def _plan():
    names = sorted(_waves())
    return [streaming.PlannedBatch(names[i: i + 3], [LENGTHS[int(n[3:])] for n in names[i: i + 3]])
            for i in range(0, len(names), 3)]


def _hand_count(layout):
    """(live samples, padded samples) of the stream's batches, counted by hand."""
    kw, waves = LAYOUTS[layout], _waves()
    live = padded = 0
    for b in _plan():
        ok = [len(waves[n]) for n in b.names if waves[n] is not None]
        if not ok:
            continue
        q = kw["bucket_quantum"]
        T = kw.get("fixed_len") or max(q, -(-max(ok) // q) * q)
        rows = -(-len(ok) // kw.get("row_multiple", 1)) * kw.get("row_multiple", 1)
        live += sum(min(n, T) for n in ok)
        padded += rows * T
    return live, padded


def _stream(layout):
    waves = _waves()
    return streaming.BatchStream(waves.__getitem__, _plan(), num_workers=3, **LAYOUTS[layout])


class _NoClock:
    """A stand-in for the module's ``time``: reading its clock fails."""

    @staticmethod
    def perf_counter():
        raise AssertionError("a clock was read with no session recording")


class _NoLock:
    def __enter__(self):
        raise AssertionError("a lock was taken with no session recording")

    def __exit__(self, *exc):
        return False


# -- off ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["span", "count", "stream", "forward"])
def test_off_reads_no_clock_takes_no_lock_and_records_nothing(path, monkeypatch):
    monkeypatch.setattr(profiling, "time", _NoClock)
    monkeypatch.setattr(profiling, "_LOCK", _NoLock())
    if path == "span":
        for name in ("a", "b"):
            # one shared null context: nothing is allocated a call
            assert profiling.span(name) is profiling._OFF
            with profiling.span(name):
                pass
    elif path == "count":
        profiling.count("c", 5)
    elif path == "stream":
        assert sum(len(rb.names) for rb in _stream("bucketed")) == len(LENGTHS) - 1
    else:
        pipe = _speech_pipeline()
        pipe._forward(np.zeros((2, 8000), np.float32), np.ones((2, 8000), np.float32), -1)
    monkeypatch.undo()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_a_span_opened_before_the_session_is_neither_recorded_nor_traced(tmp_path):
    with profiling.span("before"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("inside"):
                pass
    assert list(profiling.snapshot()["spans"]) == ["inside"]
    assert [e["name"] for e in _ser_ranges(prof, tmp_path)] == ["ser.inside"]


@pytest.mark.parametrize("where", ["main", "thread"])
def test_a_span_open_across_the_stop_is_left_out(where):
    """The record holds the session: a span still open when it stops (a thread blocked on a full queue) is dropped."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    opened, release = threading.Event(), threading.Event()

    def blocked():
        with profiling.span("open_at_stop"):
            opened.set()
            release.wait(60)

    with profiling.span("closed"):
        pass
    if where == "main":
        cm = profiling.span("open_at_stop")
        cm.__enter__()
        prof.stop()
        cm.__exit__(None, None, None)
    else:
        t = threading.Thread(target=blocked)
        t.start()
        assert opened.wait(60)
        prof.stop()
        release.set()
        t.join(60)
    spans = profiling.snapshot()["spans"]
    assert list(spans) == ["closed"] and spans["closed"][0] == 1


# -- on: the stream ----------------------------------------------------------------------


@pytest.mark.parametrize("how", ["with", "start"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stream_records_each_wav_each_batch_and_the_samples(how, layout):
    with _Session(how):
        batches = list(_stream(layout))
    snap = profiling.snapshot()
    assert snap["spans"]["stream.decode"][0] == len(LENGTHS)  # on the decode threads, failed decode included
    assert snap["spans"]["stream.assemble"][0] == len(_plan())
    # one put a batch and one for the stream's end, all inside the session
    assert snap["spans"]["stream.put_wait"][0] == len(_plan()) + 1
    # one wait a batch, and the last for the stream's end
    assert snap["spans"]["stream.get_wait"][0] == len(batches) + 1
    live, padded = _hand_count(layout)
    assert snap["counters"] == {"stream.live_samples": live, "stream.padded_samples": padded}
    assert padded == sum(rb.wav.size for rb in batches)
    assert live == sum(int(rb.mask.sum()) for rb in batches)


def test_a_stream_left_early_records_one_wait_a_batch_taken():
    with _Session("with"):
        it = iter(_stream("bucketed"))
        next(it)
        next(it)
        it.close()
    assert profiling.snapshot()["spans"]["stream.get_wait"][0] == 2


def test_records_from_other_threads_are_kept_and_main_thread_ranges_are_traced(tmp_path):
    main = threading.get_ident()
    threads = set()
    waves = _waves()

    def load_one(name):
        threads.add(threading.get_ident())
        return waves[name]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(streaming.BatchStream(load_one, _plan(), bucket_quantum=1000, num_workers=3))
    assert main not in threads
    assert profiling.snapshot()["spans"]["stream.decode"][0] == len(LENGTHS)
    names = {e["name"] for e in _ser_ranges(prof, tmp_path)}
    assert "ser.stream.get_wait" in names  # the consumer is the session's thread


# -- on: the pipelines' forwards -------------------------------------------------------------------


def _tiny_hf(name, **over):
    with open(os.path.join(BENCH_ROOT, "portbench", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **over)


def _speech_pipeline():
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel

    torch.manual_seed(0)
    cfg = SpeechConfig.from_hf(_tiny_hf("wavlm_large", hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                        intermediate_size=128, num_conv_pos_embeddings=16,
                                        num_conv_pos_embedding_groups=2, conv_dim=[32] * 7))
    return pipeline.SpeechExtractionPipeline(SpeechEncoderModel(cfg), cfg, device="cpu")


def _whisper_pipeline():
    from interspeech_ser_tpu_torch.models.whisper import WhisperEncoderConfig, WhisperEncoderModel

    torch.manual_seed(0)
    cfg = WhisperEncoderConfig.from_hf(_tiny_hf("whisper_large_v3", num_mel_bins=16, d_model=64, encoder_layers=2,
                                                encoder_attention_heads=2, encoder_ffn_dim=128))
    return pipeline.WhisperExtractionPipeline(WhisperEncoderModel(cfg), cfg, batch_size=2, device="cpu")


def _text_pipeline():
    from interspeech_ser_tpu_torch.models.text import RobertaConfig, RobertaModel

    torch.manual_seed(0)
    cfg = RobertaConfig(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                        max_position_embeddings=40)
    return pipeline.TextExtractionPipeline(RobertaModel(cfg), cfg, tokenize=None, batch_size=2, device="cpu")


class _Prosody(torch.nn.Module):
    """A stand-in for ``ProsodyExtractor``: the pipeline's ``_forward`` around it is what is under test."""

    def codes(self, wav):
        return torch.zeros(wav.shape[0], wav.shape[1] // 200, dtype=torch.int32)

    def extract_batched(self, wav, refl, fmask):
        return fmask[..., None] * refl.mean()


def _forward_calls(kind):
    """-> (pipeline, a call of its ``_forward`` on a batch of two utterances)."""
    rng = np.random.default_rng(1)
    wav = np.zeros((2, 9600), np.float32)
    wav[0], wav[1, :6400] = rng.normal(size=9600) * 0.1, rng.normal(size=6400) * 0.1
    mask = (wav != 0).astype(np.float32)
    if kind == "speech":
        pipe = _speech_pipeline()
        return pipe, lambda: pipe._forward(wav, mask, -1)
    if kind == "whisper":
        pipe = _whisper_pipeline()
        full = np.zeros((2, pipe.N_SAMPLES), np.float32)
        full[:, :9600] = wav
        return pipe, lambda: pipe._forward(full)
    if kind == "text":
        pipe = _text_pipeline()
        tb = pipeline.TextBatch(["a", "b"], rng.integers(3, 50, (2, 12)), np.ones((2, 12), np.int64), [0, 0])
        return pipe, lambda: pipe._forward(tb)
    pipe = pipeline.ProsodyExtractionPipeline(_Prosody(), codes=kind == "ns3_codes", device="cpu")
    rb = streaming.ReadyBatch(["a", "b"], [9600, 6400], wav, mask)
    return pipe, lambda: pipe._forward(rb)


@pytest.mark.parametrize("kind", ["speech", "whisper", "text", "ns3", "ns3_codes"])
def test_each_forward_records_h2d_and_encoder_once_a_call(kind):
    _, call = _forward_calls(kind)
    with _Session("with"):
        for _ in range(2):
            out = call()
    assert out.shape[0] == 2
    spans = profiling.snapshot()["spans"]
    assert sorted(spans) == ["forward.encoder", "forward.h2d"]
    assert [spans[k][0] for k in ("forward.h2d", "forward.encoder")] == [2, 2]


def test_forward_ranges_are_in_the_chrome_trace_and_agree_with_the_record(tmp_path):
    _, call = _forward_calls("speech")
    call()  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            call()
    spans = profiling.snapshot()["spans"]
    ranges = _ser_ranges(prof, tmp_path)
    for name in ("forward.h2d", "forward.encoder"):
        traced = [e["dur"] / 1e6 for e in ranges if e["name"] == f"ser.{name}"]
        n, seconds = spans[name]
        assert len(traced) == n == 3
        # the range holds the timed block: it is at least as long, and longer only by opening and closing it
        assert seconds <= sum(traced) + 1e-4
        assert sum(traced) - seconds <= 5e-3 * n + 0.05 * seconds


# -- on: the record itself -------------------------------------------------------------------


@pytest.mark.parametrize("error", [ValueError, KeyboardInterrupt])
def test_a_span_whose_body_raises_still_records(error, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(error):
            with profiling.span("raises"):
                raise error("body")
        with profiling.span("after"):
            pass
    spans = profiling.snapshot()["spans"]
    assert spans["raises"][0] == 1 and spans["raises"][1] >= 0 and spans["after"][0] == 1
    assert [e["name"] for e in _ser_ranges(prof, tmp_path)] == ["ser.raises", "ser.after"]


def test_snapshot_is_a_copy_and_reset_clears():
    with _Session("with"):
        profiling.count("c", 3)
        profiling.count("c")
        with profiling.span("s"):
            pass
    snap = profiling.snapshot()
    assert snap["counters"] == {"c": 4} and snap["spans"]["s"][0] == 1
    snap["counters"]["c"] = 0
    assert profiling.snapshot()["counters"] == {"c": 4}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_no_update_is_lost_across_threads():
    threads_n, per_thread = 12, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                profiling.count("hits")
                with profiling.span("work"):
                    profiling.count("inside", 2)

        with _Session("with"):
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = profiling.snapshot()
    assert snap["counters"] == {"hits": threads_n * per_thread, "inside": 2 * threads_n * per_thread}
    assert snap["spans"]["work"][0] == threads_n * per_thread


# -- _drive's sink -------------------------------------------------------------------------------------


def _drive_batches():
    rng = np.random.default_rng(2)
    batches = [streaming.ReadyBatch(["a.wav", "b.wav"], [16000, 9000], np.zeros((2, 16000), np.float32),
                                    np.zeros((2, 16000), np.float32)),
               streaming.ReadyBatch([], [], np.zeros((0, 0), np.float32), np.zeros((0, 0), np.float32), 1),
               streaming.ReadyBatch(["c.wav"], [20000], np.zeros((1, 32000), np.float32),
                                    np.zeros((1, 32000), np.float32))]
    outs = {id(rb): torch.from_numpy(rng.normal(size=(rb.wav.shape[0], rb.wav.shape[1] // 320, 4)).astype(np.float32))
            for rb in batches}
    return batches, outs


def _drive(save_path, sink=None):
    batches, outs = _drive_batches()
    stats = pipeline.ExtractionStats()
    pipeline._drive(batches, lambda rb: outs[id(rb)], lambda n, T: min(-(-n // 320), T), save_path, stats, 2, False,
                    sink)
    return stats


def test_a_sink_receives_exactly_the_rows_the_files_hold(tmp_path):
    files = str(tmp_path / "files")
    os.makedirs(files)
    stats_files = _drive(files)
    got = {}
    stats_sink = _drive(str(tmp_path / "unused"), sink=lambda name, row: got.setdefault(name, row.clone()))
    assert not os.path.exists(tmp_path / "unused")
    assert sorted(got) == ["a.wav", "b.wav", "c.wav"] and sorted(os.listdir(files)) == ["a.pt", "b.pt", "c.pt"]
    for name, row in got.items():
        on_disk = torch.load(os.path.join(files, name.replace(".wav", ".pt")), weights_only=True)
        assert row.dtype == on_disk.dtype and torch.equal(row, on_disk)
    assert (stats_files.n_utts, stats_files.n_failed, stats_files.n_batches) == \
        (stats_sink.n_utts, stats_sink.n_failed, stats_sink.n_batches) == (3, 1, 2)


def test_the_discard_sink_counts_and_writes_nothing(tmp_path):
    save_path = str(tmp_path / "unused")
    stats = _drive(save_path, sink=pipeline.discard)
    assert not os.path.exists(save_path)
    assert (stats.n_utts, stats.n_failed, stats.n_batches, stats.audio_seconds) == (3, 1, 2, 45000 / 16000)


# -- the benchmark's readers of the record -----------------------------------------------------


SNAPSHOT = {"spans": {"stream.decode": (8, 0.02), "stream.get_wait": (4, 0.006), "forward.h2d": (4, 0.01),
                      "forward.encoder": (4, 0.2), "stream.assemble": (4, 0.001)},
            "counters": {"stream.live_samples": 1446, "stream.padded_samples": 7680}}
READERS = {"decode_ms.extract": 2.5, "stream_wait_ms.extract": 1.5, "h2d_ms.extract": 2.5,
           "enqueue_ms.extract": 50.0, "live_samples_pct.extract": 100 * 1446 / 7680}


@pytest.mark.parametrize("record", ["synthetic", "empty", "no_record"])
@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_of_the_record(metric, record, monkeypatch):
    if record == "no_record":  # a program without the spans and counters
        monkeypatch.delattr(profiling, "snapshot")
    else:
        snap = SNAPSHOT if record == "synthetic" else {"spans": {}, "counters": {}}
        monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    value = metric_reader(metric)(None)
    if record == "synthetic":
        assert value == pytest.approx(READERS[metric], rel=1e-12)
    else:
        assert value is None
