"""The one traffic generator: a mix is a JSON file of parameters under
`traffic/`, and request i of a run is a pure function of (seed, i).

Parameters of a mix:
  batch        prompts a request carries;
  text_len     {"min", "max"}: prompt lengths in tokens. Every run sees the
               same set of lengths: min..max in a shuffled cycle, the order
               drawn from the seed, one length for all prompts of a request;
  vocab        [low, high): token ids drawn uniformly;
  uncond_id    the id of every position of the unconditional prompts;
  guidance     the guidance weight of every request.
One client sends them in a closed loop: its next request when the last
one's output is on the host. The initial noise of each request is drawn on
the device from (seed, i).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.weights import derive


@dataclass(frozen=True)
class Request:
    index: int
    ids: np.ndarray  # [batch, length] int64
    mask: np.ndarray
    uncond_ids: np.ndarray
    uncond_mask: np.ndarray
    guidance: float

    @property
    def length(self) -> int:
        return self.ids.shape[1]


class Traffic:
    def __init__(self, params: dict, seed: int, vocab_size: int):
        self.p = params
        self.seed = int(seed)
        lo, hi = params["text_len"]["min"], params["text_len"]["max"]
        rng = np.random.default_rng(derive(seed, "lengths"))
        self.cycle = rng.permutation(np.arange(lo, hi + 1))
        self.vocab = (params["vocab"][0], min(params["vocab"][1], vocab_size))

    @property
    def batch(self) -> int:
        return self.p["batch"]

    @property
    def lengths(self):
        """Every prompt length the mix sends, ascending."""
        return sorted(int(n) for n in self.cycle)

    def request(self, i: int, length: int = None) -> Request:
        """Request i (with `length`, a request of that length: warm-up)."""
        n = int(self.cycle[i % len(self.cycle)]) if length is None else length
        rng = np.random.default_rng(derive(self.seed, "ids", i, n))
        ids = rng.integers(*self.vocab, size=(self.batch, n)).astype(np.int64)
        ones = np.ones_like(ids)
        return Request(i, ids, ones, np.full_like(ids, self.p["uncond_id"]), ones.copy(),
                       float(self.p["guidance"]))

    def noise(self, i: int, shape, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(derive(self.seed, "noise", i))
        return torch.randn(shape, generator=gen, device=device)
