"""GPT-2 byte-level BPE: the RoBERTa tokenizer, in the standard library only.

The JAX package tokenizes RoBERTa transcripts with transformers'
``RobertaTokenizer`` (through ``AutoTokenizer``); the card's machine has no
transformers, so the port carries the same behaviour, read from the model
directory's ``vocab.json`` and ``merges.txt``:

0. split the text on the special tokens of ``vocab.json`` (``<s>``, ``</s>``,
   ``<pad>``, ``<unk>``, ``<mask>``), leftmost first, as transformers' split
   on added tokens does; each is emitted as its own id, and ``<mask>``
   takes the whitespace on its left with it (``lstrip``, as
   ``RobertaTokenizer`` declares it). Steps 1-3 run on the text between;
1. split the text as GPT-2's pattern
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
   does. The standard ``re`` has no ``\\p{L}`` / ``\\p{N}``, so
   :func:`pretokenize` is a small scanner over ``unicodedata.category``
   (letters L*, numbers N*) and the ``regex`` module's ``\\s`` (Python's
   ``str.isspace`` less U+001C-U+001F);
2. map each piece's UTF-8 bytes to GPT-2's printable byte alphabet;
3. merge symbol pairs by rank (``merges.txt``) until none applies, and look
   each symbol up in ``vocab.json`` (``<unk>`` if absent).

Framing and padding follow ``RobertaTokenizer(...)(texts,
padding="max_length", max_length=80, truncation=True)``: ``<s> ... </s>``,
truncation keeping the first ``max_length - 2`` pieces, ``<pad>`` to
``max_length``, attention mask 1 on the real tokens. ``add_prefix_space``
is read from ``tokenizer_config.json`` where it is set.

Known difference from transformers: a character that Python's Unicode
database (older than the ``regex`` module's) does not know as a letter or
number counts as "other".
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

BPE_FILES = ("vocab.json", "merges.txt")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_SPACE = "\x1c\x1d\x1e\x1f"  # str.isspace() but not the regex module's \s
SPECIAL_TOKENS = ("<s>", "</s>", "<pad>", "<unk>", "<mask>")
_LSTRIP = ("<mask>",)  # special tokens that take the whitespace on their left


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_SPACE


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _is_other(ch: str) -> bool:
    return not (_is_space(ch) or _is_letter(ch) or _is_number(ch))


def pretokenize(text: str) -> List[str]:
    """GPT-2's regex split (module docstring), alternative by alternative."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': an optional leading
        # space, then a run of one class (the classes are disjoint)
        start = i + 1 if text[i] == " " else i
        if start < n:
            cls = next((f for f in (_is_letter, _is_number, _is_other) if f(text[start])), None)
            if cls is not None:
                j = start + 1
                while j < n and cls(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
                continue
        # '\s+(?!\S)' leaves the run's last space to the next piece when a
        # non-space follows; '\s+' takes a lone space before a non-space
        j = i
        while j < n and _is_space(text[j]):
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


class RobertaBpeTokenizer:
    """Byte-level BPE with RoBERTa's framing (module docstring)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, ...]], add_prefix_space: bool = False):
        self.encoder = vocab
        self.bpe_ranks = {m: r for r, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.add_prefix_space = add_prefix_space
        missing = [t for t in ("<s>", "</s>", "<pad>", "<unk>") if t not in vocab]
        if missing:
            raise KeyError(f"vocab.json lacks the special tokens {missing}")
        self.bos_id, self.eos_id = vocab["<s>"], vocab["</s>"]
        self.pad_id, self.unk_id = vocab["<pad>"], vocab["<unk>"]
        specials = [t for t in SPECIAL_TOKENS if t in vocab]  # none is a prefix of another
        self._specials = re.compile("|".join(map(re.escape, specials)))
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "RobertaBpeTokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            # as transformers reads it: the first line is the version header,
            # and the last (empty after the final newline) is dropped
            merges = [tuple(m.split()) for m in f.read().split("\n")[1:-1]]
        add_prefix_space = False
        cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg):
            with open(cfg) as f:
                add_prefix_space = bool(json.load(f).get("add_prefix_space", False))
        return cls(vocab, merges, add_prefix_space)

    def bpe(self, token: str) -> List[str]:
        """Merge the lowest-ranked adjacent pair until no pair has a rank."""
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            ranked = [(self.bpe_ranks.get(pair, float("inf")), pair) for pair in zip(word, word[1:])]
            rank, (first, second) = min(ranked, key=lambda rp: rp[0])
            if rank == float("inf"):
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """``text`` cut at its special tokens -> [(piece, is_special)], the text
        left of an ``lstrip`` token stripped of trailing whitespace, empty
        pieces dropped."""
        parts: List[Tuple[str, bool]] = []
        start = 0
        for m in self._specials.finditer(text):
            left = text[start:m.start()]
            parts.append((left.rstrip() if m.group() in _LSTRIP else left, False))
            parts.append((m.group(), True))
            start = m.end()
        parts.append((text[start:], False))
        return [(piece, special) for piece, special in parts if piece]

    def tokenize(self, text: str) -> List[int]:
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
        ids: List[int] = []
        for part, special in self.split_specials(text):
            if special:
                ids.append(self.encoder[part])
                continue
            for piece in pretokenize(part):
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                ids.extend(self.encoder.get(sym, self.unk_id) for sym in self.bpe(mapped))
        return ids

    def __call__(
        self,
        texts: Sequence[str],
        padding: str = "max_length",
        max_length: int = 80,
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if padding != "max_length" or return_tensors != "np":
            raise NotImplementedError("only padding='max_length' with numpy output is implemented")
        if not truncation:  # a row longer than max_length would make the batch ragged
            raise ValueError("padding='max_length' needs truncation=True")
        rows, masks = [], []
        for text in texts:
            ids = self.tokenize(text if isinstance(text, str) else "")[: max_length - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            pad = max(0, max_length - len(row))
            rows.append(row + [self.pad_id] * pad)
            masks.append([1] * len(row) + [0] * pad)
        return {"input_ids": np.asarray(rows, dtype=np.int64), "attention_mask": np.asarray(masks, dtype=np.int64)}
