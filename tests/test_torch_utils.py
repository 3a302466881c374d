"""Host-side counterparts of the port against the JAX package's modules:
WAV decode, .pt I/O, labels, config, metrics and the batch planner."""

import os
import wave

import numpy as np
import pytest
import torch

from interspeech_ser_tpu_torch.utils import labels as port_labels
from interspeech_ser_tpu_torch.utils import ptio
from interspeech_ser_tpu_torch.utils.audio import load_wav
from interspeech_ser_tpu_torch.utils.config import load_fusion_config
from interspeech_ser_tpu_torch.utils.metrics import macro_f1

ROOT = os.path.join(os.path.dirname(__file__), "..")
torch.set_num_threads(2)


def _write(path, data: np.ndarray, sr: int, width: int, channels: int):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("width,channels,sr", [(2, 1, 16000), (2, 2, 16000), (3, 1, 16000), (4, 1, 8000), (1, 1, 22050)])
def test_load_wav_matches_jax_python_path(tmp_path, monkeypatch, width, channels, sr):
    from interspeech_ser_tpu.utils import native_audio
    from interspeech_ser_tpu.utils.audio import load_wav as jax_load_wav

    # the JAX package's python decoder: its native loader may already be
    # probed and cached by another test in this process; the port's python
    # path too (its native loader is held to both packages' paths in
    # tests/test_torch_native_audio.py)
    monkeypatch.setattr(native_audio, "_TRIED", True)
    monkeypatch.setattr(native_audio, "_LIB", None)
    monkeypatch.setenv("SER_TPU_NATIVE", "0")
    rng = np.random.default_rng(width * 10 + channels)
    n = 3001 * channels
    if width == 1:
        data = rng.integers(0, 256, n).astype(np.uint8)
    elif width == 3:
        v = rng.integers(-(2 ** 23), 2 ** 23, n).astype(np.int32)
        data = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=1).astype(np.uint8)
    else:
        data = rng.integers(-(2 ** (8 * width - 1)), 2 ** (8 * width - 1), n).astype(f"<i{width}")
    path = str(tmp_path / "x.wav")
    _write(path, data, sr, width, channels)
    ours, sr_o = load_wav(path)
    ref, sr_r = jax_load_wav(path)
    assert sr_o == sr_r == 16000 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_save_tensor_writes_only_the_slice(tmp_path):
    big = torch.randn(64, 1000, 16)
    p = str(tmp_path / "row.pt")
    ptio.save_tensor(big[3, :10], p)
    assert os.path.getsize(p) < 4096  # a view would drag the 4 MB storage along
    np.testing.assert_array_equal(ptio.load_tensor(p), big[3, :10].numpy())
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_labels_merge_and_split_match_pandas(tmp_path):
    import pandas as pd

    from interspeech_ser_tpu.utils import labels as jax_labels

    rng = np.random.default_rng(0)
    names = [f"u{i}.wav" for i in range(7)]
    lab = pd.DataFrame({"FileName": names})
    onehot = np.eye(8)[rng.integers(0, 8, 7)]
    for j, c in enumerate(port_labels.CLASSES):
        lab[c] = onehot[:, j]
    lab["Split_Set"] = ["Train", "Development"] * 3 + ["Development"]
    lab.to_csv(tmp_path / "l.csv", index=False)
    txt = pd.DataFrame({"FileName": names[::-1][:5], "transcription": [f"t{i}" for i in range(5)]})
    txt.to_csv(tmp_path / "t.csv", index=False)
    ref = jax_labels.split(jax_labels.load_merged(str(tmp_path / "l.csv"), str(tmp_path / "t.csv")), "Development")
    ours = port_labels.split(port_labels.load_merged(str(tmp_path / "l.csv"), str(tmp_path / "t.csv")), "Development")
    assert port_labels.column(ours, "FileName") == ref["FileName"].tolist()
    np.testing.assert_array_equal(port_labels.matrix(ours), ref[port_labels.CLASSES].values.astype(np.float32))
    assert port_labels.CLASSES == jax_labels.CLASSES and port_labels.INDEX_TO_LETTER == jax_labels.INDEX_TO_LETTER


def test_fusion_config_matches_jax():
    from interspeech_ser_tpu.utils.config import load_fusion_config as jax_load

    path = os.path.join(ROOT, "configs", "config_cat_bimodal_lazy_lr1e4_head1.json")
    ours, ref = load_fusion_config(path), jax_load(path)
    for field in ("feat_dims", "lazy_dirs", "model_path", "batch_size", "fusion_hidden_dim", "num_emotions"):
        assert getattr(ours, field) == getattr(ref, field), field


def test_macro_f1_matches_jax():
    from interspeech_ser_tpu.utils.metrics import macro_f1 as jax_macro_f1

    rng = np.random.default_rng(1)
    for _ in range(5):
        y, p = rng.integers(0, 8, 50), rng.integers(0, 6, 50)
        assert macro_f1(y, p) == pytest.approx(jax_macro_f1(y, p), abs=1e-12)


def test_plan_batches_matches_jax():
    from interspeech_ser_tpu.extract.streaming import plan_batches as jax_plan

    from interspeech_ser_tpu_torch.extract.streaming import plan_batches

    rng = np.random.default_rng(2)
    items = [(f"u{i}", int(n)) for i, n in enumerate(rng.integers(16000, 16000 * 15, 40))]
    ours, ref = plan_batches(items, 16000 * 60, 16000), jax_plan(items, 16000 * 60, 16000)
    assert [(b.names, b.lengths) for b in ours] == [(b.names, b.lengths) for b in ref]
