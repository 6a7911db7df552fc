"""The one generator of every traffic mix: inputs from the seed and the
mix's data file, never from the program.

Training mixes draw a fresh batch every step on the card from a
``torch.Generator``. A serving mix is an open loop: ``requests`` gives
every seed the same schedule, the quantiles of the mix's distributions of
prompt lengths, output lengths and gaps between arrivals put in the order
of the mix's ``schedule_seed``, and draws the prompts' tokens from the
run's seed. So a seed changes the inputs and not the work: which request
meets a burst decides a tail, and an order of its own for every seed
moved the tails of runs by more than any change the benchmark has to see.
Arrivals are the gaps' running sum: a Poisson process's exponential gaps
at the mix's rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """Stream ``stream`` of a seed: 0 the weights, 1 the inputs, 2 the
    sample of checked requests."""
    return torch.Generator(device=device).manual_seed(3 * int(seed) + stream)


def token_batch(gen: torch.Generator, batch: int, seq: int, vocab: int, device) -> torch.Tensor:
    """(batch, seq) token ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (batch, seq), generator=gen, device=device)


def lognormal_quantiles(n: int, spec: dict) -> np.ndarray:
    """``n`` whole lengths at the quantiles (i + 1/2) / n of a lognormal of
    the given median and sigma, clipped to [min, max]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


@dataclass
class Request:
    index: int
    arrival: float  # seconds after the window opens
    prompt: List[int]
    max_new: int


def requests(mix: dict, seed: int, seconds: float, vocab: int) -> List[Request]:
    """The window's requests: round(rate * seconds) arrivals."""
    n = max(int(round(mix["rate_per_s"] * seconds)), 1)
    order = np.random.default_rng(int(mix["schedule_seed"]))
    prompts = order.permutation(lognormal_quantiles(n, mix["prompt"]))
    outputs = order.permutation(lognormal_quantiles(n, mix["output"]))
    gaps = order.permutation([-math.log(1.0 - (i + 0.5) / n) / mix["rate_per_s"]
                              for i in range(n)])
    arrivals = np.cumsum(gaps) - gaps[0]  # the first request opens the window
    ids = np.random.default_rng(int(seed)).integers(0, vocab, size=int(prompts.sum()))
    out, start = [], 0
    for i in range(n):
        p = int(prompts[i])
        out.append(Request(i, float(arrivals[i]), ids[start:start + p].tolist(),
                           int(outputs[i])))
        start += p
    return out
