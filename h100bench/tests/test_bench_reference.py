"""The plain reference against the port's plain path at tiny sizes, in
fp32, where the two must agree to rounding: three training steps, and a
served request's prefill and pooled decode."""

import dataclasses

import pytest
import torch

from h100bench import compare, lookup
from h100bench.common import RunContext
from h100bench.drivers import clip_train, lm_train, serve_pool
from h100bench.reference import brain, lowp
from h100bench.tests import tiny


def _ctx(workload, traffic, mix, config="forde_lm_ref", sizes=tiny.LM, **extra):
    bench = lookup.benchmark()
    cfg = dict(lookup.config_file(bench, config), **sizes, **extra)
    return RunContext(workload, cfg, dict(lookup.traffic(traffic), **mix), {}, 2 ** 31 + 5,
                      3.0, False, torch.device("cpu"))


def test_training_steps_agree_in_fp32():
    ctx = _ctx("forde_lm_ref.train_8x2k", "train_8x2k", tiny.TRAIN, dtype="float32")
    numbers = lm_train.numbers(ctx, lm_train.program_side(ctx), lm_train.reference_side(ctx))
    assert numbers["loss"] < 1e-6
    assert numbers["first_grad"] < 1e-5
    assert numbers["first_grad_rows"] < 1e-5
    assert numbers["usage"] < 1e-5
    assert numbers["change"] < 1e-3
    assert numbers["router"] < 1e-6  # the same usage and draws give the same nudges


def test_dual_encoder_steps_and_slow_loop_agree_in_fp32():
    ctx = _ctx("clip_vit_b16.train_sensed_256", "train_sensed_256", tiny.CLIP_TRAIN,
               "clip_vit_b16", tiny.CLIP, dtype="float32")
    numbers = clip_train.numbers(ctx, clip_train.program_side(ctx), clip_train.reference_side(ctx))
    assert numbers["loss"] < 1e-5
    assert numbers["first_grad"] < 1e-5 and numbers["first_grad_rows"] < 1e-5
    assert numbers["sensed"] < 1e-5
    assert numbers["change"] < 1e-3
    assert numbers["slow_loop"] == 0.0  # the same sums and draws give the same neuron types
    assert numbers["slow_loop_median"] == 0.0


@pytest.mark.parametrize("shape", [(1, 2, 4), (1, 2, 2), (1, 3, 3), (2, 4, 5)])
def test_expert_mode_filter_matches_the_port(shape):
    from forde_tpu_torch.brain.smoothing import smooth_assignments_3d

    gen = torch.Generator().manual_seed(sum(shape))
    for _ in range(20):
        grid = torch.randint(0, 3, shape, generator=gen)
        assert torch.equal(brain.mode_filter_3d(grid), smooth_assignments_3d(grid).long())


def test_fused_projection_counts_as_three_leaves():
    t = torch.arange(12.0).reshape(6, 2)
    norms = compare.leaf_norms([("a.attention.qkv_proj.weight", t), ("a.out_proj.weight", t)])
    assert sorted(norms) == ["a.attention.qkv_proj.weight[0]", "a.attention.qkv_proj.weight[1]",
                             "a.attention.qkv_proj.weight[2]", "a.out_proj.weight"]
    assert norms["a.attention.qkv_proj.weight[1]"] == pytest.approx(float(t[2:4].norm()))


def test_served_tokens_agree_in_fp32():
    ctx = _ctx("forde_lm_ref.serve_saturated", "serve_saturated", tiny.SERVE, dtype="float32")
    sample = serve_pool.served_sample(dataclasses.replace(
        ctx, traffic=dict(ctx.traffic, calibrate_seconds=2.0)))
    assert sum(len(s.tokens) for s in sample) >= 20
    gap, _ = serve_pool.reference_gaps(ctx, sample)
    assert gap < 1e-5  # greedy tokens are the reference's argmax


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_rounding_is_straight_through(precision):
    x = torch.randn(5, 7, requires_grad=True)
    y = lowp.rnd(x, precision)
    assert not torch.equal(y.detach(), x.detach())
    (y * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    assert torch.equal(lowp.rnd(x, None), x)
