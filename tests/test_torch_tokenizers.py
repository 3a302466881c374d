"""The port's tokenizers against the JAX package's and transformers'.

- byte-level BPE (``utils/bpe.py``) against transformers' ``RobertaTokenizer``
  on a synthetic vocabulary trained here with ``tokenizers`` (a few hundred
  merges over ASCII, accented, digit and emoji text): the same ids and
  masks, with and without truncation, and on texts that hold the special
  tokens (each emitted as its id, ``<mask>`` taking the space on its left);
- the SentencePiece copy (``utils/spm.py``) against the JAX package's
  ``DebertaV2SpmTokenizer`` on a hand-built unigram model;
- ``auto_tokenizer``'s choice by the files present.
"""

import json
import os

import numpy as np
import pytest

from interspeech_ser_tpu.utils import spm as jspm
from interspeech_ser_tpu_torch.utils import bpe, spm

CORPUS = [
    "I can't believe it's already over, we'll see what they've done.",
    "Café déjà vu: naïve façade, coöperate, résumé, Ångström, São Paulo.",
    "Call me at 555-0123 or 1,234.56 dollars on 2024/07/19 at 10:45pm",
    "so happy 😀😀 and sad 😢 🎉 party 🇺🇸 ✨",
    "Whitespace   runs\tand\ttabs\nnewlines\n\n  leading and trailing  ",
    "Mixed: ÄÖÜ äöü ß, Ελληνικά, русский, 中文字符, 日本語のテキスト",
    "Punctuation!!! ... ??? -- (parens) [brackets] {braces} \"quotes\" 'single'",
    "numbers ① ② ½ ¾ Ⅻ and letters ǅ ʰ ᾈ",
]
TEXTS = CORPUS + [
    "",
    " ",
    "   ",
    "a",
    "'s'S'LL 'll'd don't WON'T",
    "  two leading spaces",
    "trailing spaces   ",
    "tab\tthen  double  space nbsp em-space　ideographic",
    "x\x1cy\x1dz unit separators",
    "unseen chars: ☃ ♞ 𝔘𝔫𝔦𝔠𝔬𝔡𝔢 ٣٤ ",
    " ".join(CORPUS),  # long enough to be cut at max_length
]


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    from tokenizers import ByteLevelBPETokenizer

    d = tmp_path_factory.mktemp("bpe")
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(CORPUS * 3, vocab_size=600, min_frequency=1,
                            special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"])
    tok.save_model(str(d))
    return str(d)


@pytest.mark.parametrize("max_length", [80, 12])
def test_bpe_matches_transformers_roberta_tokenizer(bpe_dir, max_length):
    from transformers import RobertaTokenizer

    ref = RobertaTokenizer(os.path.join(bpe_dir, "vocab.json"), os.path.join(bpe_dir, "merges.txt"))
    ours = bpe.RobertaBpeTokenizer.from_pretrained(bpe_dir)
    want = ref(TEXTS, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    got = ours(TEXTS, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
    for i, text in enumerate(TEXTS):
        assert got["input_ids"][i].tolist() == want["input_ids"][i].tolist(), repr(text)
        assert got["attention_mask"][i].tolist() == want["attention_mask"][i].tolist(), repr(text)
    assert got["input_ids"].dtype == np.int64 and got["input_ids"].shape == (len(TEXTS), max_length)
    assert got["attention_mask"][-1].all()  # the long text was cut to fit


SPECIAL_TEXTS = [
    "hello <mask> world",
    "<s>",
    "</s> starts with an end",
    "a<pad>b<unk>c",
    "two  spaces   <mask>then<mask> and\t<mask>",
    "<mask>",
    " <mask>",
    "<s><s></s></s>",
    "it's <mask>! <pad> </s>ending",
    "nearly: <s <mask <ma sk> </ s> <unk",
    "<<s>> <</s>>",
    "café <unk> déjà 😀<mask>😢",
]


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_bpe_emits_special_tokens_as_transformers(bpe_dir, add_prefix_space):
    from transformers import RobertaTokenizer

    ref = RobertaTokenizer(os.path.join(bpe_dir, "vocab.json"), os.path.join(bpe_dir, "merges.txt"),
                           add_prefix_space=add_prefix_space)
    ours = bpe.RobertaBpeTokenizer.from_pretrained(bpe_dir)
    ours.add_prefix_space = add_prefix_space
    want = ref(SPECIAL_TEXTS, padding="max_length", max_length=40, truncation=True, return_tensors="np")
    got = ours(SPECIAL_TEXTS, padding="max_length", max_length=40, truncation=True, return_tensors="np")
    for i, text in enumerate(SPECIAL_TEXTS):
        assert got["input_ids"][i].tolist() == want["input_ids"][i].tolist(), repr(text)
        assert got["attention_mask"][i].tolist() == want["attention_mask"][i].tolist(), repr(text)
    for tok in bpe.SPECIAL_TOKENS:  # each special string inside a text comes out as its one id
        assert ours.encoder[tok] in ours.tokenize(f"x {tok} y"), tok


def test_pretokenize_matches_gpt2_regex():
    import regex

    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    for text in TEXTS:
        assert bpe.pretokenize(text) == pat.findall(text), repr(text)


def test_bpe_prefix_space_and_unknown_symbols(bpe_dir, tmp_path):
    from transformers import RobertaTokenizer

    vocab = json.loads(open(os.path.join(bpe_dir, "vocab.json")).read())
    del vocab["Ã"]  # a byte symbol no merge can avoid for "é"
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(open(os.path.join(bpe_dir, "merges.txt")).read())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"add_prefix_space": True}))
    ref = RobertaTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"), add_prefix_space=True)
    ours = bpe.RobertaBpeTokenizer.from_pretrained(str(tmp_path))
    texts = ["éàè unknown bytes", "prefix space", " already spaced"]
    want = ref(texts, padding="max_length", max_length=24, truncation=True)
    got = ours(texts, max_length=24)
    assert got["input_ids"].tolist() == want["input_ids"]
    assert ours.unk_id in got["input_ids"][0]


SPM_PIECES = [("[PAD]", 0.0, jspm.CONTROL), ("[CLS]", 0.0, jspm.CONTROL), ("[SEP]", 0.0, jspm.CONTROL),
              ("[UNK]", 0.0, jspm.UNKNOWN)] + [
    (p, -float(i) / 10, jspm.NORMAL) for i, p in enumerate(
        ["▁", "▁the", "▁a", "s", "e", "t", "h", "▁c", "at", "▁cat", "▁sat", "▁on", "▁mat", "a", "o", "n",
         "m", "r", "i", "▁is", "d", "▁do", "g", "ing", "'", "!", ".", ",", "é", "1", "2"], start=1)]


@pytest.mark.parametrize("byte_fallback", [False, True])
def test_spm_copy_matches_jax(tmp_path, byte_fallback):
    pieces = SPM_PIECES + ([(f"<0x{b:02X}>", 0.0, jspm.BYTE) for b in range(256)] if byte_fallback else [])
    blob = spm.serialize_spm_model(pieces, byte_fallback=byte_fallback)
    assert blob == jspm.serialize_spm_model(pieces, byte_fallback=byte_fallback)
    (tmp_path / "spm.model").write_bytes(blob)
    texts = ["the cat sat on the mat", "The Dog's doing it!", "", "  spaced   out  ", "éé 12 ☃ zebra",
             "a " * 60, None]
    ours = spm.auto_tokenizer(str(tmp_path))
    theirs = jspm.DebertaV2SpmTokenizer.from_pretrained(str(tmp_path))
    assert isinstance(ours, spm.DebertaV2SpmTokenizer)
    for max_length in (80, 10):
        got = ours(texts, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
        want = theirs(texts, padding="max_length", max_length=max_length, truncation=True, return_tensors="np")
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def test_auto_tokenizer_choice_and_missing_files(bpe_dir, tmp_path):
    assert isinstance(spm.auto_tokenizer(bpe_dir), bpe.RobertaBpeTokenizer)
    (tmp_path / "vocab.json").write_text("{}")  # merges.txt missing
    with pytest.raises(FileNotFoundError) as err:
        spm.auto_tokenizer(str(tmp_path))
    for name in ("spm.model", "vocab.json", "merges.txt"):
        assert name in str(err.value)


def test_tokenizers_refuse_ragged_batches(bpe_dir, tmp_path):
    """padding='max_length' without truncation could give rows longer than
    max_length; both tokenizers refuse it rather than return a ragged batch."""
    (tmp_path / "spm.model").write_bytes(spm.serialize_spm_model(SPM_PIECES))
    for tok in (spm.auto_tokenizer(bpe_dir), spm.auto_tokenizer(str(tmp_path))):
        with pytest.raises(ValueError, match="truncation"):
            tok(["the cat sat on the mat " * 5], padding="max_length", max_length=8, truncation=False)
