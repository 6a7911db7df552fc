"""The generator's draws for a seed: the same seed gives the same inputs,
every seed the same work in another order."""

import math

import numpy as np
import torch

from h100bench import generate, lookup

MIX = lookup.traffic("serve_saturated")


def test_requests_repeat_for_a_seed():
    a = generate.requests(MIX, 2 ** 31 + 12345, 10.0, 50257)
    b = generate.requests(MIX, 2 ** 31 + 12345, 10.0, 50257)
    assert [(r.arrival, r.prompt, r.max_new) for r in a] == [(r.arrival, r.prompt, r.max_new) for r in b]


def test_every_seed_draws_the_same_work():
    a = generate.requests(MIX, 1, 30.0, 50257)
    b = generate.requests(MIX, 2, 30.0, 50257)
    assert len(a) == len(b) == round(MIX["rate_per_s"] * 30.0)
    assert [(r.arrival, len(r.prompt), r.max_new) for r in a] == [
        (r.arrival, len(r.prompt), r.max_new) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]  # other tokens


def test_the_schedule_is_the_mix_data():
    other = dict(MIX, schedule_seed=MIX["schedule_seed"] + 1)
    a = generate.requests(MIX, 1, 30.0, 50257)
    b = generate.requests(other, 1, 30.0, 50257)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)


def test_lengths_are_the_mix_quantiles():
    n = 240
    lengths = generate.lognormal_quantiles(n, MIX["prompt"])
    assert lengths.min() >= MIX["prompt"]["min"] and lengths.max() <= MIX["prompt"]["max"]
    assert abs(np.median(lengths) - MIX["prompt"]["median"]) <= 2
    outs = generate.lognormal_quantiles(n, MIX["output"])
    assert abs(np.median(outs) - MIX["output"]["median"]) <= 2
    # the tail: sigma 0.8 puts about a tenth of prompts above 512 * e^(0.8 * 1.28)
    assert 0.05 < np.mean(lengths > 512 * math.exp(0.8 * 1.2816)) < 0.15


def test_arrivals_are_poisson_at_the_rate():
    reqs = generate.requests(MIX, 7, 60.0, 50257)
    arrivals = np.array([r.arrival for r in reqs])
    assert arrivals[0] == 0.0 and np.all(np.diff(arrivals) >= 0)
    gaps = np.diff(arrivals)
    assert abs(gaps.mean() * MIX["rate_per_s"] - 1.0) < 0.1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.15  # exponential: sd = mean


def test_requests_fit_the_model():
    cfg = lookup.config_file(lookup.benchmark(), "forde_lm_ref")
    for r in generate.requests(MIX, 3, 30.0, cfg["vocab_size"]):
        assert len(r.prompt) + r.max_new <= cfg["max_seq_len"]
        assert min(r.prompt) >= 0 and max(r.prompt) < cfg["vocab_size"]


def test_training_batches_repeat_for_a_seed():
    mix = lookup.traffic("train_8x2k")
    g1 = generate.generator(2 ** 31 + 9, 1, "cpu")
    g2 = generate.generator(2 ** 31 + 9, 1, "cpu")
    a = [generate.token_batch(g1, 2, 16, 50257, "cpu") for _ in range(3)]
    b = [generate.token_batch(g2, 2, 16, 50257, "cpu") for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])  # a fresh batch every step
    assert mix["batch"] * mix["seq_len"] == 16384
