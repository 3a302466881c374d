"""The port's Whisper decode against transformers' fast Whisper tokenizer.

The vocabulary is synthetic, in Whisper-large-v3's layout
(``chip_smoke.write_whisper_tokenizer``: 256 byte symbols, seeded merges up
to 1,000 ids, then the 1,609 added tokens at their large-v3 offsets). The
reference is ``AutoTokenizer.from_pretrained(dir).decode(ids,
skip_special_tokens=...)`` on the same files, then on transformers'
``save_pretrained`` copy of them, then on the slow files alone (no
``tokenizer.json``). Bar: equal strings.
"""

import os
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

from interspeech_ser_tpu_torch.utils.whisper_tokenizer import WhisperTokenizer, clean_up_tokenization  # noqa: E402

N_REGULAR = 1000


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    import chip_smoke

    d = tmp_path_factory.mktemp("whisper_tok")
    ids = chip_smoke.write_whisper_tokenizer(str(d), n_regular=N_REGULAR)
    return str(d), ids


def _cases(ids):
    """Named id sequences: prompts, specials, timestamps, split UTF-8, clean-up."""
    enc = lambda s: list(s.encode("utf-8"))  # noqa: E731  ids 0-255: the byte symbols in byte order
    sot, eot = ids["<|startoftranscript|>"], ids["<|endoftext|>"]
    en, tr, nots = ids["<|en|>"], ids["<|transcribe|>"], ids["<|notimestamps|>"]
    prev = ids["<|startofprev|>"]
    ts = lambda t: ids["<|%.2f|>" % t]  # noqa: E731
    rng = np.random.default_rng(0)
    return {
        "prompt and text": [sot, en, tr, nots] + list(range(300, 320)) + [eot],
        "text prompt stripped": [prev, 310, 311, sot, en, tr, nots, 330, 331],
        "prompt without start": [prev, 310, 311, 312],
        "timestamps": [sot, ts(0.0), 400, 401, ts(1.24), ts(29.98), 402, ts(30.0)],
        "timestamp before a dot": [sot, 500] + enc(" ") + [ts(0.5)] + enc("."),
        "split utf-8": enc("caf") + enc("é")[:1] + [ts(0.1)] + enc("é")[1:] + enc(" 日本 €"),
        "broken utf-8": enc("日")[:2] + enc(" a") + enc("€")[1:] + [eot],
        "clean-up": enc("it 's a test . really ? yes ! no , don 't I 'm we 've they 're ' x"),
        "ids past the vocabulary": [sot, 600, N_REGULAR + len(ids) + 5, 601],
        "random": [int(i) for i in rng.integers(0, N_REGULAR + len(ids), 200)],
        "empty": [],
    }


def _check_against(reference_dir, ids, port_dir=None):
    from transformers import AutoTokenizer

    ref = AutoTokenizer.from_pretrained(reference_dir)
    assert type(ref).__name__ == "WhisperTokenizerFast"
    port = WhisperTokenizer.from_dir(port_dir or reference_dir)
    for name, seq in _cases(ids).items():
        for skip in (True, False):
            assert port.decode(seq, skip_special_tokens=skip) == ref.decode(seq, skip_special_tokens=skip), (name, skip)


def test_decode_matches_transformers(tok_dir):
    d, ids = tok_dir
    _check_against(d, ids)


def test_decode_matches_transformers_save_pretrained(tok_dir, tmp_path):
    from transformers import AutoTokenizer

    d, ids = tok_dir
    AutoTokenizer.from_pretrained(d).save_pretrained(str(tmp_path))
    _check_against(str(tmp_path), ids)


def test_decode_without_tokenizer_json(tok_dir, tmp_path):
    """The slow files alone (vocab.json, merges.txt, added_tokens.json,
    special_tokens_map.json, tokenizer_config.json): the port reads them,
    transformers converts them to a fast tokenizer."""
    d, ids = tok_dir
    for name in os.listdir(d):
        if name != "tokenizer.json":
            shutil.copy(os.path.join(d, name), tmp_path / name)
    _check_against(str(tmp_path), ids)


def test_clean_up_off_and_layout(tok_dir, tmp_path):
    import json

    d, ids = tok_dir
    assert ids["<|endoftext|>"] == N_REGULAR and ids["<|startoftranscript|>"] == N_REGULAR + 1
    assert ids["<|en|>"] == N_REGULAR + 2 and ids["<|notimestamps|>"] == N_REGULAR + 107
    assert ids["<|0.00|>"] == N_REGULAR + 108 and ids["<|30.00|>"] == N_REGULAR + 1608
    for name in os.listdir(d):
        shutil.copy(os.path.join(d, name), tmp_path / name)
    cfg_path = tmp_path / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["clean_up_tokenization_spaces"] = False
    cfg_path.write_text(json.dumps(cfg))
    _check_against(str(tmp_path), ids)
    assert clean_up_tokenization("a . b ?") == "a. b?"
