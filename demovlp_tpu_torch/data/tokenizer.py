"""Host-side tokenization (copy of demovlp_tpu/data/tokenizer.py).

Every batch is (B, 100), as the reference tokenizes. `build_tokenizer`
loads a HuggingFace tokenizer from a local path when one is configured and
present (the `transformers` import is lazy), else `SimpleTokenizer`: a
deterministic lowercase word/punctuation tokenizer with FNV-1a hashed ids
in the DistilBERT vocab range and the same special-token layout
([CLS] x ... [SEP] pad).
"""
from __future__ import annotations

import os
import re
from typing import List, Sequence, Union

import numpy as np

MAX_TEXT_LEN = 100


class SimpleTokenizer:
    """Deterministic offline tokenizer (DistilBERT-shaped ids)."""

    PAD_ID = 0
    UNK_ID = 100
    CLS_ID = 101
    SEP_ID = 102
    HASH_LO = 1000  # non-special tokens hash into [1000, vocab_size)

    def __init__(self, vocab_size: int = 30522, max_length: int = MAX_TEXT_LEN):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._word_re = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

    def _token_ids(self, text: str) -> List[int]:
        span = self.vocab_size - self.HASH_LO
        ids = []
        for t in self._word_re.findall(text.lower()):
            h = 2166136261  # FNV-1a 32-bit: stable across processes
            for ch in t.encode("utf8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(self.HASH_LO + (h % span))
        return ids

    def __call__(self, text: Union[str, Sequence[str]], max_length: int | None = None, **_):
        if isinstance(text, str):
            text = [text]
        length = max_length or self.max_length
        input_ids = np.full((len(text), length), self.PAD_ID, dtype=np.int32)
        attention_mask = np.zeros((len(text), length), dtype=np.int32)
        for i, t in enumerate(text):
            ids = [self.CLS_ID] + self._token_ids(t)[: length - 2] + [self.SEP_ID]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


class _HFTokenizerWrapper:
    """A HuggingFace tokenizer behind the fixed-shape numpy protocol."""

    def __init__(self, hf_tokenizer, max_length: int = MAX_TEXT_LEN):
        self.hf = hf_tokenizer
        self.max_length = max_length

    def __call__(self, text, max_length: int | None = None, **_):
        if isinstance(text, str):
            text = [text]
        enc = self.hf(list(text), padding="max_length", truncation=True,
                      max_length=max_length or self.max_length, return_tensors="np")
        return {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }


def build_tokenizer(model_name_or_path: str = "", max_length: int = MAX_TEXT_LEN):
    """HF tokenizer from a local path if one loads, else SimpleTokenizer
    (the JAX package's rule; nothing is downloaded)."""
    if model_name_or_path and os.path.exists(model_name_or_path):
        try:
            from transformers import AutoTokenizer

            hf = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
            return _HFTokenizerWrapper(hf, max_length)
        except (ImportError, OSError, ValueError):
            pass
    return SimpleTokenizer(max_length=max_length)
