"""BERT-style masked-language-model token masking, 80/10/10 (copy of
demovlp_tpu/data/mlm.py; reference utils/util.py:193-240).

Pure numpy and deterministic under a Generator: the same generator state
gives the JAX package's masks bit for bit. Labels are -100 at the positions
that were not selected (the cross-entropy ignore convention).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def mask_batch_text_tokens(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    mask_token_id: int,
    vocab_size: int,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
    special_ids: Tuple[int, ...] = (0, 101, 102),
    ignore_index: int = -100,
) -> Tuple[np.ndarray, np.ndarray]:
    """(masked input ids, labels). Of the selected positions, 80% become
    [MASK], 10% a random token and 10% stay as they are."""
    ids = input_ids.copy()
    labels = ids.copy()

    special = np.isin(ids, np.asarray(special_ids))
    candidates = (attention_mask > 0) & ~special
    probs = np.where(candidates, mlm_probability, 0.0)
    masked = rng.random(ids.shape) < probs
    labels[~masked] = ignore_index

    replace_mask = masked & (rng.random(ids.shape) < 0.8)
    ids[replace_mask] = mask_token_id

    random_mask = masked & ~replace_mask & (rng.random(ids.shape) < 0.5)
    ids[random_mask] = rng.integers(0, vocab_size, size=ids.shape)[random_mask]
    return ids, labels
