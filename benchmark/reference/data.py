"""The inputs of a run, made from the seed, and the word tokenizer.

Both sides take the same inputs: the program through its loader
(harness/dataset.py hands them to it as a dataset), the reference from
`Inputs` directly. They are made on the device in a few large calls and
held on the host, so that serving a sample costs a slice and no random
draws (the port's own synthetic dataset draws 493k normals a sample at
f = 8, several cores' worth of host work a step, which no deployment
pays: real region features are decoded from archives off the training
thread):

  * a bank of 2**24 normal(0, 1) values; sample i's (F, K, 2054) region
    features are the bank's values from offset[i] on;
  * frame lengths lens[i, f] in [1, K] (regions past them are padding);
  * captions of words[i] in [3, 9] words drawn from WORDS.

The tokenizer: FNV-1a ids in DistilBERT's range, [CLS] words [SEP] then
pads, 100 positions. A train epoch `e` of a loader with seed `s` visits
the indices in `default_rng(SeedSequence([s, e]))`'s permutation, batch
after batch.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

REGION_DIM = 2054
BANK = 1 << 24
MAX_WORDS = 9
WORDS = (
    "a the person dog cat car runs jumps plays red blue small large street park "
    "video shows man woman child ball game water tree house music group walking"
).split()
PAD, CLS, SEP, HASH_LO, VOCAB = 0, 101, 102, 1000, 30522
TEXT_LEN = 100
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class Inputs:
    """`n` samples of (F, K, 2054) regions, their masks and captions, from
    `seed`, drawn on `device`."""

    def __init__(self, seed: int, n: int, frames: int, regions: int, device):
        self.n, self.frames, self.regions = int(n), int(frames), int(regions)
        block = self.frames * self.regions * REGION_DIM
        if block > BANK:
            raise ValueError(f"a sample of {block} values does not fit the bank of {BANK}")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def ints(low, high, shape):
            return torch.randint(low, high, shape, generator=gen, device=device).cpu().numpy()

        self.bank = torch.randn(BANK, generator=gen, device=device).cpu().numpy()
        self.offsets = ints(0, BANK - block + 1, (self.n,))
        self.lens = ints(1, self.regions + 1, (self.n, self.frames))
        self.words = ints(3, MAX_WORDS + 1, (self.n,))
        self.word_ids = ints(0, len(WORDS), (self.n, MAX_WORDS))

    def sample(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(features (F, K, 2054), mask (F, K) 1 / 0) of sample i; the
        features are a view of the bank."""
        f, k = self.frames, self.regions
        o = int(self.offsets[i])
        feats = self.bank[o:o + f * k * REGION_DIM].reshape(f, k, REGION_DIM)
        mask = (np.arange(k)[None, :] < self.lens[i][:, None]).astype(np.float32)
        return feats, mask

    def caption(self, i: int) -> str:
        return " ".join(WORDS[int(w)] for w in self.word_ids[i, :int(self.words[i])])

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The model's arrays of these samples."""
        feats, masks = zip(*(self.sample(int(i)) for i in indices))
        out = tokenize([self.caption(int(i)) for i in indices])
        out["object"] = np.stack(feats).astype(np.float32)
        out["object_mask"] = np.stack(masks)
        return out


def _ids(text: str) -> List[int]:
    span = VOCAB - HASH_LO
    out = []
    for t in _WORD_RE.findall(text.lower()):
        h = 2166136261
        for ch in t.encode("utf8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        out.append(HASH_LO + h % span)
    return out


def tokenize(texts: Sequence[str], length: int = TEXT_LEN) -> Dict[str, np.ndarray]:
    ids = np.full((len(texts), length), PAD, np.int64)
    mask = np.zeros((len(texts), length), np.int64)
    for i, t in enumerate(texts):
        row = [CLS] + _ids(t)[:length - 2] + [SEP]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def train_order(seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)
