"""The inputs of a pixel cell (Frozen in Time), made from the seed, as
data.py makes a region cell's.

Both sides take the same inputs: the program through its loader
(harness/frames_dataset.py hands them to it as a dataset), the reference
from `FrameInputs` directly. A pool of `pool` uint8 clips (F, 3, R, R) is
drawn on the device in one call and held on the host; sample i is clip
clips[i] of the pool, so serving a sample costs a slice and no draws.
Captions of words[i] in [3, 9] words drawn from data.WORDS; the
tokenizer and the train order are data.py's.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.data import MAX_WORDS, WORDS, tokenize


class FrameInputs:
    """`n` samples of uint8 clips (F, 3, R, R) and captions, from `seed`,
    drawn on `device`."""

    def __init__(self, seed: int, n: int, frames: int, resolution: int, pool: int, device):
        self.n = int(n)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def ints(low, high, shape):
            return torch.randint(low, high, shape, generator=gen, device=device).cpu().numpy()

        self.pool = torch.randint(0, 256, (int(pool), int(frames), 3, int(resolution),
                                           int(resolution)), generator=gen, device=device,
                                  dtype=torch.uint8).cpu().numpy()
        self.clips = ints(0, int(pool), (self.n,))
        self.words = ints(3, MAX_WORDS + 1, (self.n,))
        self.word_ids = ints(0, len(WORDS), (self.n, MAX_WORDS))

    def sample(self, i: int) -> np.ndarray:
        """The clip of sample i (a view of the pool)."""
        return self.pool[int(self.clips[i])]

    def caption(self, i: int) -> str:
        return " ".join(WORDS[int(w)] for w in self.word_ids[i, :int(self.words[i])])

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The model's arrays of these samples."""
        out = tokenize([self.caption(int(i)) for i in indices])
        out["video"] = np.stack([self.sample(int(i)) for i in indices])
        return out
