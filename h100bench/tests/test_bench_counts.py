"""The counts' arithmetic against hand-worked shapes."""

import numpy as np
import pytest

from h100bench import lookup
from h100bench.counts import attention as att
from h100bench.counts import lm
from h100bench.counts.peaks import least_seconds


def test_window_pairs():
    # s = 6, window 3: 1 + 2 + 3 + 3 + 3 + 3
    assert att.window_pairs(6, 3) == 15
    assert att.window_pairs(4, 8) == 10  # plain causal


def test_flash_forward_counts_each_byte_once():
    moved, ops = att.flash_fwd(2, 3, 6, 4, 3, 2)
    assert moved == 4 * 2 * 3 * 6 * 4 * 2 + 2 * 3 * 6 * 4  # q, k, v, o bf16; lse fp32
    assert ops == 4 * 4 * 2 * 3 * 15


def test_flash_backward_counts_the_four_products():
    moved, ops = att.flash_bwd(1, 1, 6, 4, 3, 2)
    assert moved == 7 * 6 * 4 * 2 + 2 * 6 * 4
    assert ops == 8 * 4 * 15


def test_pools_visible_and_the_uniform_quirk():
    vis = att.pool_visible(20, 3, 4)  # pool p seen from (p + 1) * 4
    assert list(vis[:13]) == [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3]
    moved, ops = att.small_kv_fwd(1, 1, 20, 3, 4, vis, 2)
    # 4 queries see no pool and average all 3: 2 * D per key each
    pairs = vis.sum() + 0.5 * 3 * 4
    assert ops == 4 * 4 * pairs
    assert moved == (2 * 20 * 4 + 2 * 3 * 4) * 2 + 3 * 4


def test_topk_visible_spread_evenly():
    vis = att.topk_visible(8, 4)  # selections at every other position
    assert list(vis) == [0, 1, 1, 2, 2, 3, 3, 4]


def test_lm_token_flops_by_hand():
    cfg = dict(d_model=8, num_heads=2, head_dim=4, num_experts=4, top_k_experts=2,
               expert_hidden_dim=16, num_streams=2, vocab_size=10, num_layers=1)
    d, hd = 8, 8
    per_layer = 2 * (d * 3 * hd + hd * d + 2 * d * hd + d * d + 2 * d * hd + d * d + d
                     + d * 4 + 2 * 2 * d * 16 + 2 * 4 * d)
    head = 2 * (d * 1 * d + d * 10)
    assert lm.token_flops(cfg) == per_layer + head


def test_lm_reference_config_counts():
    cfg = lookup.config_file(lookup.benchmark(), "forde_lm_ref")
    per_token = lm.train_step_flops(cfg, 8, 2048) / (8 * 2048)
    # routed top-2 of 8 experts: each 2 * 2 * 512 * 2048 a token and layer, three passes
    experts = 3 * 12 * 2 * 2 * 2 * 512 * 2048
    assert 0.5e9 < per_token < 0.8e9 and 0.4 < experts / per_token < 0.5
    dense_all = 3 * 12 * 8 * 2 * 2 * 512 * 2048
    assert per_token < dense_all  # not the eight that dense dispatch computes


def test_decode_counts_grow_with_position():
    cfg = lookup.config_file(lookup.benchmark(), "forde_lm_ref")
    assert lm.decode_token_flops(cfg, 100) < lm.decode_token_flops(cfg, 1500)
    assert lm.decode_kernel_seconds(cfg, 32) > lm.decode_kernel_seconds(cfg, 8)


@pytest.mark.parametrize("moved,ops,dtype,expect", [
    (3.35e12, 0.0, "bfloat16", 1.0), (0.0, 989e12, "bfloat16", 1.0),
    (0.0, 165e12, "float32", 1.0)])
def test_least_seconds(moved, ops, dtype, expect):
    assert np.isclose(least_seconds(moved, ops, dtype), expect)
