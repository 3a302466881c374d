"""Whisper's tokenizer, decode only, in the standard library.

The JAX package's transcription script turns token ids into text with
``AutoTokenizer.from_pretrained(model_dir).decode(ids,
skip_special_tokens=True)``, i.e. transformers' fast ``WhisperTokenizerFast``;
the card's machine has neither transformers nor tokenizers, so the port
carries the same decode, read from the model directory's files:

1. with ``skip_special_tokens``, a sequence that opens with
   ``<|startofprev|>`` (a text prompt) loses everything before
   ``<|startoftranscript|>`` (all of it when that is absent);
2. each id becomes its token (an id outside the vocabulary is dropped), and
   with ``skip_special_tokens`` the added tokens marked special are dropped
   (the timestamps ``<|0.00|>``... are added tokens that are not special);
3. the byte-level decoder maps each token's characters back to bytes through
   the inverse of GPT-2's ``bytes_to_unicode`` (a token with a character
   outside that alphabet keeps its own UTF-8 bytes) and decodes all the
   bytes at once as UTF-8, an invalid sequence giving U+FFFD;
4. ``clean_up_tokenization_spaces`` (``tokenizer_config.json``, False when
   unset) applies transformers' ``clean_up_tokenization`` (" ." -> "." and
   the like);
5. timestamp strings (``<|\\d+.\\d+|>``) are removed.

The files: ``tokenizer.json`` (``model.vocab`` and ``added_tokens`` with
their ``special`` flags) when present, as the fast tokenizer loads it;
otherwise ``vocab.json``, ``added_tokens.json`` and
``special_tokens_map.json``. ``tokenizer_config.json``'s
``added_tokens_decoder`` sets the ``special`` flags where it has them.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Set

from .bpe import bytes_to_unicode

TIMESTAMP_PAT = re.compile(r"<\|(\d+\.\d+)\|>")
PROMPT_TOKEN = "<|startofprev|>"
START_TOKEN = "<|startoftranscript|>"
_SPECIAL_MAP_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token", "sep_token", "cls_token", "mask_token")


def clean_up_tokenization(text: str) -> str:
    """transformers' ``PreTrainedTokenizerBase.clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                 (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _read(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(tok) -> str:
    return tok["content"] if isinstance(tok, dict) else tok


class WhisperTokenizer:
    """Decode-only Whisper tokenizer (see the module's docstring)."""

    def __init__(self, id_to_token: Dict[int, str], special: Set[str], clean_up_tokenization_spaces: bool = False):
        self.id_to_token = id_to_token
        self.token_to_id = {t: i for i, t in id_to_token.items()}
        self.special = special
        self.clean_up_tokenization_spaces = clean_up_tokenization_spaces
        self._byte = {c: b for b, c in bytes_to_unicode().items()}

    @classmethod
    def from_dir(cls, model_dir: str) -> "WhisperTokenizer":
        path = lambda name: os.path.join(model_dir, name)  # noqa: E731
        config = _read(path("tokenizer_config.json")) if os.path.exists(path("tokenizer_config.json")) else {}
        flags: Dict[str, bool] = {}  # added token -> special
        if os.path.exists(path("tokenizer.json")):
            tj = _read(path("tokenizer.json"))
            decoder = (tj.get("decoder") or {}).get("type")
            if decoder != "ByteLevel":
                raise ValueError(f"{path('tokenizer.json')}: decoder {decoder!r}, want 'ByteLevel'")
            id_to_token = {int(i): t for t, i in tj["model"]["vocab"].items()}
            for a in tj.get("added_tokens", []):
                id_to_token[int(a["id"])] = a["content"]
                flags[a["content"]] = bool(a.get("special", False))
        else:
            id_to_token = {int(i): t for t, i in _read(path("vocab.json")).items()}
            if os.path.exists(path("added_tokens.json")):
                for t, i in _read(path("added_tokens.json")).items():
                    id_to_token[int(i)] = t
                    flags.setdefault(t, False)
            if os.path.exists(path("special_tokens_map.json")):
                smap = _read(path("special_tokens_map.json"))
                for key in _SPECIAL_MAP_KEYS:
                    if smap.get(key):
                        flags[_content(smap[key])] = True
                for tok in smap.get("additional_special_tokens", []) or []:
                    flags[_content(tok)] = True
        for i, tok in (config.get("added_tokens_decoder") or {}).items():
            id_to_token[int(i)] = tok["content"]
            flags[tok["content"]] = bool(tok.get("special", False))
        return cls(id_to_token, {t for t, s in flags.items() if s},
                   bool(config.get("clean_up_tokenization_spaces", False)))

    def _strip_prompt(self, ids: list) -> list:
        prompt, start = self.token_to_id.get(PROMPT_TOKEN), self.token_to_id.get(START_TOKEN)
        if ids and prompt is not None and ids[0] == prompt:
            return ids[ids.index(start):] if start in ids else []
        return ids

    def _token_bytes(self, token: str) -> bytes:
        try:
            return bytes(self._byte[c] for c in token)
        except KeyError:
            return token.encode("utf-8")

    def decode(self, token_ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        ids = [int(i) for i in token_ids]
        if skip_special_tokens:
            ids = self._strip_prompt(ids)
        tokens = [self.id_to_token[i] for i in ids if i in self.id_to_token]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in self.special]
        text = b"".join(self._token_bytes(t) for t in tokens).decode("utf-8", errors="replace")
        if self.clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return TIMESTAMP_PAT.sub("", text)
