"""The general generator of query traffic, driven by a traffic file.

Queries are free text: words drawn from the file's vocabulary, their
number from a lognormal (`median`, `sigma`) clipped to [`min`, `max`]. The
multiset of lengths is the same for every seed (the lognormal's quantiles
at evenly spaced levels); the seed draws their order and the words, so
every seed asks for the same work.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np


def query_lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    levels = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(p)) for p in levels])
    words = np.exp(np.log(float(spec["median"])) + float(spec["sigma"]) * z)
    return np.clip(np.rint(words), int(spec["min"]), int(spec["max"])).astype(int)


def query_calls(spec: Dict[str, Any], seed: int, calls: int, per_call: int,
                stream: int = 0) -> List[List[str]]:
    """`calls` lists of `per_call` query strings, from `seed` (`stream`
    keeps separate draws apart, e.g. warm-up from the window)."""
    words = spec["vocabulary"]
    lens = query_lengths(spec["words"], calls * per_call)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1 + int(stream)]))
    lens = lens[rng.permutation(len(lens))]
    texts = [" ".join(words[int(i)] for i in rng.integers(0, len(words), int(n))) for n in lens]
    return [texts[c * per_call:(c + 1) * per_call] for c in range(calls)]
