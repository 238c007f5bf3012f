"""Host-side batch preparation (the `prepare_batch`/`pad_batch` part of
demovlp_tpu/train/steps.py; host numpy only). Text buckets are off: every
batch is tokenized to the fixed length 100, as the reference does. The
train and eval steps wait for a later slice."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def prepare_batch(batch: Dict[str, Any], tokenizer, max_text_len: int = 100):
    """Tokenize the text and assemble the model's numpy array batch."""
    enc = tokenizer(batch["text"], max_length=max_text_len)
    return {
        "input_ids": enc["input_ids"],
        "attention_mask": enc["attention_mask"],
        "object": batch["object"],
        "object_mask": batch["object_mask"],
    }


def pad_batch(arrays: Dict[str, np.ndarray], target: int) -> Tuple[Dict, int]:
    """Pad the batch axis to `target` rows by repeating row 0; returns
    (padded, n_valid)."""
    n = next(iter(arrays.values())).shape[0]
    if n == target:
        return arrays, n
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds the target {target}")
    out = {k: np.concatenate([v, np.repeat(v[:1], target - n, axis=0)], axis=0)
           for k, v in arrays.items()}
    return out, n
