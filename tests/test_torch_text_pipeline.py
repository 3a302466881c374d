"""``preprocess_cli roberta`` / ``deroberta`` of the port (``--device cpu``)
against the JAX package's CLIs on the same model directory, CSV and
tokenizer files.

The directories are written by transformers (3 layers, so that the mean
of the last 4 hidden states exists; D=64, 4 heads): the
RoBERTa one with a byte-level BPE trained here with ``tokenizers``, the
DeBERTa one with a hand-built SentencePiece model. The CSV has an empty
transcription, an ``NA`` one (both read as the empty text) and one long
enough to be cut at ``--max_len``. Bars: the same file set, [max_len, D]
float32 rows, values within 1e-4 (same math, other summation orders).
"""

import csv
import os

import pytest
import torch

from interspeech_ser_tpu import preprocess_cli as jax_cli
from interspeech_ser_tpu.utils import spm as jspm
from interspeech_ser_tpu_torch import preprocess_cli
from interspeech_ser_tpu_torch.utils.spm import serialize_spm_model

torch.set_num_threads(2)

MAX_LEN = 16
TEXTS = [
    "the cat sat on the mat",
    "",
    "NA",
    "I can't believe it's over, said the dog!",
    "Café déjà vu 123 😀",
    "a long transcript " * 8,
    "short",
    "the mat is on the cat, and the dog is doing it",
    "  spaced   out  ",
]


def _write_csv(path):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FileName", "transcription", "Split_Set"])
        for i, t in enumerate(TEXTS):
            w.writerow([f"utt{i:02d}.wav", t, "Train"])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from tokenizers import ByteLevelBPETokenizer
    from transformers import DebertaV2Config, DebertaV2Model, RobertaConfig, RobertaModel

    root = tmp_path_factory.mktemp("text")
    rob, deb = root / "roberta", root / "deberta"
    torch.manual_seed(0)
    RobertaModel(RobertaConfig(
        vocab_size=300, hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
    )).save_pretrained(rob)
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(TEXTS * 2, vocab_size=300, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(str(rob))
    torch.manual_seed(1)
    DebertaV2Model(DebertaV2Config(
        vocab_size=300, hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=0, relative_attention=True, position_buckets=8,
        norm_rel_ebd="layer_norm", share_att_key=True, pos_att_type=["p2c", "c2p"],
        position_biased_input=False, conv_kernel_size=3, conv_act="gelu", layer_norm_eps=1e-7,
    )).save_pretrained(deb)
    words = ["▁the", "▁cat", "▁sat", "▁on", "▁mat", "▁dog", "▁is", "▁do", "ing", "▁a", "▁long", "▁it"]
    letters = sorted({c for t in TEXTS for c in t if c != " "})
    pieces = ([("[PAD]", 0.0, jspm.CONTROL), ("[CLS]", 0.0, jspm.CONTROL), ("[SEP]", 0.0, jspm.CONTROL),
               ("[UNK]", 0.0, jspm.UNKNOWN), ("▁", -1.0, jspm.NORMAL)]
              + [(w, -2.0 - i / 10, jspm.NORMAL) for i, w in enumerate(words)]
              + [(c, -5.0 - i / 100, jspm.NORMAL) for i, c in enumerate(letters[:-3])])  # a few unknowns
    (deb / "spm.model").write_bytes(serialize_spm_model(pieces))
    csv_path = root / "transcripts.csv"
    _write_csv(csv_path)
    return {"roberta": str(rob), "deroberta": str(deb), "csv": str(csv_path)}


def _run(main, model_dir, csv_path, save, *extra):
    return main(["--roberta_type", model_dir, "--df_path", csv_path, "--save_path", save,
                 "--max_len", str(MAX_LEN), *extra])


@pytest.mark.parametrize("average", ["n", "y"])
@pytest.mark.parametrize("family", ["roberta", "deroberta"])
def test_port_cli_matches_jax_cli(family, average, dirs, tmp_path):
    jax_main = jax_cli.roberta_main if family == "roberta" else jax_cli.deroberta_main
    port_main = preprocess_cli.COMMANDS[family]
    _run(jax_main, dirs[family], dirs["csv"], str(tmp_path / "jax"), "--use_average", average)
    stats = _run(port_main, dirs[family], dirs["csv"], str(tmp_path / "port"), "--use_average", average,
                 "--device", "cpu")
    assert stats.n_utts == len(TEXTS) and stats.n_batches == 1
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files == [f"utt{i:02d}.pt" for i in range(len(TEXTS))]
    for f in files:
        want = torch.load(tmp_path / "jax" / f, weights_only=True)
        got = torch.load(tmp_path / "port" / f, weights_only=True)
        assert got.dtype == torch.float32 and tuple(got.shape) == (MAX_LEN, 64) == tuple(want.shape)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=f)


def test_skip_existing(dirs, tmp_path, monkeypatch):
    save = tmp_path / "out"
    save.mkdir()
    sentinel = torch.zeros(1)
    torch.save(sentinel, save / "utt03.pt")
    monkeypatch.setenv("SER_TPU_SKIP_EXISTING", "1")
    stats = _run(preprocess_cli.roberta_main, dirs["roberta"], dirs["csv"], str(save), "--device", "cpu")
    assert stats.n_skipped == 1 and stats.n_utts == len(TEXTS) - 1
    assert torch.equal(torch.load(save / "utt03.pt", weights_only=True), sentinel)
    assert len(os.listdir(save)) == len(TEXTS)
    full = tmp_path / "full"
    monkeypatch.delenv("SER_TPU_SKIP_EXISTING")
    _run(preprocess_cli.roberta_main, dirs["roberta"], dirs["csv"], str(full), "--device", "cpu")
    for f in os.listdir(full):  # the skipped row leaves every other row as it was
        if f != "utt03.pt":
            torch.testing.assert_close(torch.load(save / f, weights_only=True),
                                       torch.load(full / f, weights_only=True), atol=1e-6, rtol=0)


def test_transcripts_read_as_pandas_reads_them(dirs):
    import pandas as pd

    names, texts = preprocess_cli.read_transcripts(dirs["csv"])
    df = pd.read_csv(dirs["csv"])
    assert names == df["FileName"].tolist()
    assert [t if isinstance(t, str) else None for t in df["transcription"].tolist()] == texts


def test_default_device_needs_a_card(dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _run(preprocess_cli.deroberta_main, dirs["deroberta"], dirs["csv"], str(tmp_path / "x"))
