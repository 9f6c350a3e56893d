"""The one traffic generator: every mix is a data file under ``traffic/``
whose parameters this module reads.  Same seed, same inputs.

Token ids follow a Zipf law over the vocabulary (rank r drawn with weight
1/r^s), each rank mapped to an id through a permutation drawn from the seed,
so that frequent ids are scattered as in text.  Id 0 is never drawn: the
port's data pipeline pads with it.

- ``documents``: an endless stream of documents with clipped lognormal
  lengths (``doc_len_mean``, ``doc_len_sigma``, ``doc_len_min``,
  ``doc_len_max``), for the port's ``DataPipeline`` to pack.
- ``prompts``: round ``r`` of a closed loop of offline rounds, ``prompts``
  prompts of ``prompt_len`` tokens each.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np


class ZipfIds:
    """Ids 1..V-1 with Zipf(``s``) frequencies through a seed-drawn
    permutation."""

    def __init__(self, vocab: int, s: float, seed: int):
        ranks = np.arange(1, vocab, dtype=np.float64)
        cdf = np.cumsum(ranks ** -s)
        self.cdf = cdf / cdf[-1]
        self.ids = (np.random.default_rng([seed % 2**64, 0x5A4950]).permutation(vocab - 1) + 1).astype(np.int32)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        r = np.searchsorted(self.cdf, rng.random(n), side="right")
        return self.ids[np.minimum(r, len(self.ids) - 1)]


def documents(seed: int, mix: Dict, vocab: int) -> Iterator[np.ndarray]:
    ids = ZipfIds(vocab, float(mix["zipf_s"]), seed)
    rng = np.random.default_rng([seed % 2**64, 0x444F43])
    sigma = float(mix["doc_len_sigma"])
    mu = math.log(float(mix["doc_len_mean"])) - 0.5 * sigma ** 2
    lo, hi = int(mix["doc_len_min"]), int(mix["doc_len_max"])
    while True:
        n = int(np.clip(rng.lognormal(mu, sigma), lo, hi))
        yield ids.draw(rng, n)


def prompts(seed: int, mix: Dict, vocab: int, round_index: int) -> np.ndarray:
    """(prompts, prompt_len) int32 ids of one round."""
    ids = ZipfIds(vocab, float(mix["zipf_s"]), seed)
    rng = np.random.default_rng([seed % 2**64, 0x50524F, round_index])
    B, S = int(mix["prompts"]), int(mix["prompt_len"])
    return ids.draw(rng, B * S).reshape(B, S)
