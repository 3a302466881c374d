"""Pure-Python SentencePiece unigram tokenizer (DeBERTa-v2's), and the
tokenizer chooser of the text-extraction CLIs.

A copy of ``interspeech_ser_tpu/utils/spm.py`` that imports only numpy and
the standard library (the card's machine has neither transformers nor the
sentencepiece wheel):

- :func:`load_spm_model` / :func:`serialize_spm_model`: a minimal protobuf
  wire-format reader and writer for the fields inference needs (the writer
  builds small synthetic models for tests and ``chip_smoke.py``).
- :class:`UnigramEncoder`: NFKC + NMT whitespace normalization, dummy prefix
  and ``▁`` escaping per the model's NormalizerSpec flags, then Viterbi over
  the pieces' log-probs with SentencePiece's unknown-character score
  (min_score - 10) and optional byte fallback.
- :class:`DebertaV2SpmTokenizer`: transformers' ``DebertaV2Tokenizer``
  calling convention, ``tok(texts, padding='max_length', max_length=80,
  truncation=True, return_tensors='np')`` -> ``{'input_ids',
  'attention_mask'}`` with [CLS] ... [SEP] framing.
- :func:`auto_tokenizer`: picks the tokenizer by the files in the model
  directory: a SentencePiece model gives :class:`DebertaV2SpmTokenizer`,
  ``vocab.json`` + ``merges.txt`` give the byte-level BPE of ``utils/bpe.py``.

Known divergences, kept as the reference has them: normalization
approximates the precompiled ``nmt_nfkc`` charsmap with
``unicodedata.normalize("NFKC")`` plus the NMT whitespace and control rules;
and a run of unknown characters is scored one character at a time, where
the C++ implementation merges consecutive unknowns into one piece.
"""

from __future__ import annotations

import os
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# SentencePiece piece types (sentencepiece_model.proto enum Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "▁"  # ▁ the SPM whitespace escape
_UNK_PENALTY = 10.0  # kUnkPenalty in unigram_model.cc


# ------------------------------------------------------------------ protobuf
# Minimal wire-format codec. Field layout (sentencepiece_model.proto):
#   ModelProto { repeated SentencePiece pieces = 1;
#                TrainerSpec trainer_spec = 2;
#                NormalizerSpec normalizer_spec = 3; }
#   SentencePiece { string piece = 1; float score = 2; Type type = 3; }
#   TrainerSpec   { ... int32 unk_id = 40; byte_fallback (bool) = 35; }
#   NormalizerSpec{ string name = 1; bytes precompiled_charsmap = 2;
#                   bool add_dummy_prefix = 3;
#                   bool remove_extra_whitespaces = 4;
#                   bool escape_whitespaces = 5; }


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message's bytes."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wtype == 1:  # 64-bit
            val, i = buf[i : i + 8], i + 8
        elif wtype == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wtype == 5:  # 32-bit
            val, i = buf[i : i + 4], i + 4
        else:  # groups (3/4) never appear in sentencepiece models
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _write_field(fnum: int, wtype: int, payload: bytes) -> bytes:
    head = _write_varint((fnum << 3) | wtype)
    if wtype == 2:
        return head + _write_varint(len(payload)) + payload
    return head + payload


@dataclass
class SpmModel:
    pieces: List[Tuple[str, float, int]]  # (piece, score, type)
    unk_id: int = 0
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    vocab: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.vocab:
            self.vocab = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        # the UNKNOWN-typed piece is authoritative for unk_id (trainer_spec
        # may be stripped from distributed models)
        for i, (_, _, t) in enumerate(self.pieces):
            if t == UNKNOWN:
                self.unk_id = i
                break


def load_spm_model(path: str) -> SpmModel:
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    kw = dict(unk_id=0, byte_fallback=False, add_dummy_prefix=True,
              remove_extra_whitespaces=True, escape_whitespaces=True)
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:  # SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for pf, pw, pv in _iter_fields(val):
                if pf == 1 and pw == 2:
                    piece = pv.decode("utf-8")
                elif pf == 2 and pw == 5:
                    score = struct.unpack("<f", pv)[0]
                elif pf == 3 and pw == 0:
                    ptype = pv
            pieces.append((piece, score, ptype))
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for tf, tw, tv in _iter_fields(val):
                if tf == 40 and tw == 0:
                    kw["unk_id"] = tv
                elif tf == 35 and tw == 0:
                    kw["byte_fallback"] = bool(tv)
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for nf, nw, nv in _iter_fields(val):
                if nf == 3 and nw == 0:
                    kw["add_dummy_prefix"] = bool(nv)
                elif nf == 4 and nw == 0:
                    kw["remove_extra_whitespaces"] = bool(nv)
                elif nf == 5 and nw == 0:
                    kw["escape_whitespaces"] = bool(nv)
    return SpmModel(pieces, **kw)


def serialize_spm_model(
    pieces: Sequence[Tuple[str, float, int]],
    unk_id: Optional[int] = None,
    byte_fallback: bool = False,
    add_dummy_prefix: bool = True,
    remove_extra_whitespaces: bool = True,
    escape_whitespaces: bool = True,
) -> bytes:
    """Write a loadable ModelProto: tests and ``chip_smoke.py`` hand-build
    small models with it (the sentencepiece wheel reads them too)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = _write_field(1, 2, piece.encode("utf-8"))
        body += _write_field(2, 5, struct.pack("<f", score))
        body += _write_field(3, 0, _write_varint(ptype))
        out += _write_field(1, 2, body)
    trainer = b""
    if unk_id is not None:
        trainer += _write_field(40, 0, _write_varint(unk_id))
    if byte_fallback:
        trainer += _write_field(35, 0, _write_varint(1))
    # model_type = UNIGRAM (field 3) so the real wheel accepts the file
    trainer += _write_field(3, 0, _write_varint(1))
    out += _write_field(2, 2, trainer)
    norm = _write_field(1, 2, b"identity")
    norm += _write_field(3, 0, _write_varint(int(add_dummy_prefix)))
    norm += _write_field(4, 0, _write_varint(int(remove_extra_whitespaces)))
    norm += _write_field(5, 0, _write_varint(int(escape_whitespaces)))
    out += _write_field(3, 2, norm)
    return bytes(out)


# ------------------------------------------------------------------- encoder
class UnigramEncoder:
    """Viterbi unigram segmentation over an SPM model's pieces.

    Matches sentencepiece's unigram inference: maximize the sum of piece
    log-probs over segmentations of the normalized string; characters no
    piece covers become single-character pieces at ``min_score − 10``
    (mapped to ``unk_id`` at id-lookup, or to ``<0xXX>`` byte pieces when
    the model declares byte fallback)."""

    # trie leaf marker: a non-string sentinel so it can never collide with
    # a character key — pieces themselves may contain any char, '$'
    # included (the real deberta-v2 vocab has '$'-bearing pieces)
    _LEAF = None

    def __init__(self, model: SpmModel):
        self.model = model
        # trie as nested dicts; leaf = {_LEAF: (piece_id, score)}.
        # CONTROL/UNUSED pieces never match text; UNKNOWN is special.
        self.trie: Dict = {}
        min_score = 0.0
        for pid, (piece, score, ptype) in enumerate(model.pieces):
            if ptype in (CONTROL, UNUSED, UNKNOWN, BYTE):
                continue
            node = self.trie
            for ch in piece:
                node = node.setdefault(ch, {})
            node[self._LEAF] = (pid, score)
            min_score = min(min_score, score)
        self.unk_score = min_score - _UNK_PENALTY
        self.byte_ids = {}
        if model.byte_fallback:
            for pid, (piece, _, ptype) in enumerate(model.pieces):
                if ptype == BYTE:
                    self.byte_ids[piece] = pid

    # -- normalization ----------------------------------------------------
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        # NMT rules: unicode spaces → ' ', control/format chars dropped
        # (tab/newline count as whitespace)
        chars = []
        for ch in text:
            cat = unicodedata.category(ch)
            if ch in "\t\n\r\v\f" or cat == "Zs":
                chars.append(" ")
            elif cat in ("Cc", "Cf"):
                continue
            else:
                chars.append(ch)
        text = "".join(chars)
        if self.model.remove_extra_whitespaces:
            text = " ".join(text.split())
        if not text:
            return ""
        if self.model.add_dummy_prefix:
            text = " " + text
        if self.model.escape_whitespaces:
            text = text.replace(" ", _SPACE)
        return text

    # -- Viterbi ----------------------------------------------------------
    def _segment(self, s: str) -> List[Tuple[str, int]]:
        """Best segmentation of normalized ``s`` → [(piece_str, piece_id)];
        unknown chars carry id = unk_id."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            node, j = self.trie, i
            # walk matching pieces starting at i
            while j < n and (nxt := node.get(s[j])) is not None:
                node, j = nxt, j + 1
                leaf = node.get(self._LEAF)
                if leaf is not None:
                    pid, score = leaf
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, s[i:j], pid)
            # unknown single char — always available so Viterbi never strands
            cand = best[i] + self.unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, s[i], self.model.unk_id)
        pieces: List[Tuple[str, int]] = []
        j = n
        while j > 0:
            i, piece, pid = back[j]
            pieces.append((piece, pid))
            j = i
        pieces.reverse()
        return pieces

    def encode(self, text: str) -> Tuple[List[str], List[int]]:
        """→ (pieces, ids). Pieces are the surface strings (like
        ``spm.encode(out_type=str)`` — unknown chars appear verbatim);
        ids map unknowns to unk_id or byte pieces under byte fallback."""
        s = self.normalize(text)
        if not s:
            return [], []
        toks, ids = [], []
        for piece, pid in self._segment(s):
            if pid == self.model.unk_id and self.byte_ids:
                for b in piece.encode("utf-8"):
                    bp = f"<0x{b:02X}>"
                    toks.append(bp)
                    ids.append(self.byte_ids.get(bp, self.model.unk_id))
            else:
                toks.append(piece)
                ids.append(pid)
        return toks, ids


# ------------------------------------------------- DebertaV2 HF conventions
class DebertaV2SpmTokenizer:
    """transformers' ``DebertaV2Tokenizer`` call pattern as the text
    extraction pipeline uses it, built on :class:`UnigramEncoder`. Framing per transformers' DebertaV2Tokenizer: ``[CLS] pieces
    [SEP]`` with truncation to ``max_length`` (specials included), pad with
    ``[PAD]``, attention_mask 1 on real tokens."""

    SPM_NAMES = ("spm.model", "spiece.model", "sentencepiece.bpe.model")

    def __init__(self, model: SpmModel, do_lower_case: bool = False,
                 split_by_punct: bool = False):
        self.encoder = UnigramEncoder(model)
        self.vocab = model.vocab
        self.do_lower_case = do_lower_case
        self.split_by_punct = split_by_punct

        def _id(name: str, default: int) -> int:
            return self.vocab.get(name, default)

        # deberta-v2's spm model carries the specials as control pieces
        # 0-3; fall back to those conventions if absent
        self.pad_id = _id("[PAD]", 0)
        self.cls_id = _id("[CLS]", 1)
        self.sep_id = _id("[SEP]", 2)
        self.unk_id = _id("[UNK]", model.unk_id)

    @classmethod
    def from_pretrained(cls, path: str) -> "DebertaV2SpmTokenizer":
        import json

        spm_path = None
        for name in cls.SPM_NAMES:
            p = os.path.join(path, name)
            if os.path.exists(p):
                spm_path = p
                break
        if spm_path is None:
            raise FileNotFoundError(
                f"no SentencePiece model ({'/'.join(cls.SPM_NAMES)}) in {path}"
            )
        kw = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                tc = json.load(f)
            kw = {k: tc[k] for k in ("do_lower_case", "split_by_punct") if k in tc}
        return cls(load_spm_model(spm_path), **kw)

    def tokenize(self, text: str) -> List[int]:
        if self.do_lower_case:
            text = text.lower()
        if self.split_by_punct:
            ids: List[int] = []
            for word in _split_on_punct(text):
                ids.extend(self.encoder.encode(word)[1])
            return ids
        return self.encoder.encode(text)[1]

    def __call__(
        self,
        texts: Sequence[str],
        padding: str = "max_length",
        max_length: int = 80,
        truncation: bool = True,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if return_tensors != "np":
            raise NotImplementedError("only numpy output is implemented")
        if padding == "max_length" and not truncation:
            # a row longer than max_length would make the batch ragged
            raise ValueError("padding='max_length' needs truncation=True")
        rows, masks = [], []
        body = max_length - 2  # [CLS] ... [SEP]
        for text in texts:
            ids = self.tokenize(text if isinstance(text, str) else "")
            if truncation:
                ids = ids[:body]
            row = [self.cls_id] + ids + [self.sep_id]
            mask = [1] * len(row)
            if padding == "max_length" and len(row) < max_length:
                pad = max_length - len(row)
                row += [self.pad_id] * pad
                mask += [0] * pad
            rows.append(row)
            masks.append(mask)
        if padding != "max_length":  # pad to batch max
            longest = max(len(r) for r in rows)
            for r, m in zip(rows, masks):
                r += [self.pad_id] * (longest - len(r))
                m += [0] * (longest - len(m))
        return {
            "input_ids": np.asarray(rows, dtype=np.int64),
            "attention_mask": np.asarray(masks, dtype=np.int64),
        }


def _split_on_punct(text: str) -> List[str]:
    """transformers-style punctuation split (each punct char its own word)."""
    words, cur = [], []
    for ch in text:
        if unicodedata.category(ch).startswith("P"):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


def auto_tokenizer(path: str):
    """The tokenizer of the model directory ``path``, chosen by its files:
    a SentencePiece model (``spm.model``, ...) -> :class:`DebertaV2SpmTokenizer`;
    ``vocab.json`` and ``merges.txt`` -> :class:`~.bpe.RobertaBpeTokenizer`.
    Raises ``FileNotFoundError`` naming the files when neither set is there."""
    from .bpe import BPE_FILES, RobertaBpeTokenizer

    if any(os.path.exists(os.path.join(path, n)) for n in DebertaV2SpmTokenizer.SPM_NAMES):
        return DebertaV2SpmTokenizer.from_pretrained(path)
    if all(os.path.exists(os.path.join(path, n)) for n in BPE_FILES):
        return RobertaBpeTokenizer.from_pretrained(path)
    raise FileNotFoundError(
        f"no tokenizer in {path}: expected a SentencePiece model "
        f"({' or '.join(DebertaV2SpmTokenizer.SPM_NAMES)}) or {' + '.join(BPE_FILES)}"
    )
