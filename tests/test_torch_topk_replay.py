"""The NSA prefill's top-k replay (forde_tpu_torch.ops.topk_replay)
against the JAX package's: a ``lax.scan`` of ``topk_insert`` over the
positions, as its ``nsa_prefill`` runs it. The result is a selection, so
the kept scores and their positions must be equal exactly, slot order
included: ragged rows (-inf pads), ties (integer scores, all equal), P < K
and P = 1.

``_warp_walk`` emulates the CUDA kernel's walk (csrc/topk_replay.cu) in
numpy, lane by lane: per 32 positions a ballot of those above the current
first minimum, the insertion by the lane that owns the slot, and the new
first minimum by a butterfly over (value, slot) pairs. It is held to the
plain version exactly, so that the kernel's algorithm is checked here; the
kernel itself runs only on the card (chip_smoke.py holds it to the plain
version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.nn.attention import topk_insert
from forde_tpu_torch import kernels
from forde_tpu_torch.ops.topk_replay import MAX_K, topk_replay, topk_replay_reference

EMPTY = 2048


def jax_replay(scores: np.ndarray, k: int, empty: int):
    n, p = scores.shape
    s = jnp.asarray(scores)
    zeros = jnp.zeros((n, 1, 1, 1), jnp.float32)
    init = (jnp.full((n, k), -jnp.inf, jnp.float32), jnp.full((n, k), empty, jnp.int32),
            jnp.zeros((n, 1, k, 1), jnp.float32), jnp.zeros((n, 1, k, 1), jnp.float32))

    def insert(carry, t):
        return topk_insert(carry, s[:, t], zeros, zeros, t), None

    (kept, idx, _, _), _ = jax.lax.scan(insert, init, jnp.arange(p))
    return np.asarray(kept), np.asarray(idx)


def _case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "ragged_pads":  # 3 layers x 4 rows, lengths 40, 17, 9, 1
        s = rng.randn(12, 40).astype(np.float32)
        lens = np.tile([40, 17, 9, 1], 3)
        s[np.arange(40)[None, :] >= lens[:, None]] = -np.inf
        return s, 8
    if name == "integer_ties":
        return np.round(rng.randn(5, 120) * 1.5).astype(np.float32), 16
    if name == "all_tied":
        return np.zeros((3, 50), np.float32), 8
    if name == "p_below_k":
        return rng.randn(4, 5).astype(np.float32), 8
    if name == "p_is_1":
        return rng.randn(6, 1).astype(np.float32), 64
    if name == "k_not_a_lane_multiple":
        return rng.randn(2, 300).astype(np.float32), 40
    if name == "serving_k64":
        return rng.randn(2, 700).astype(np.float32), 64
    raise KeyError(name)


CASES = ["ragged_pads", "integer_ties", "all_tied", "p_below_k", "p_is_1",
         "k_not_a_lane_multiple", "serving_k64"]


@pytest.mark.parametrize("name", CASES)
def test_plain_replay_matches_jax_scan(name):
    scores, k = _case(name)
    want_kept, want_idx = jax_replay(scores, k, EMPTY)
    kept, idx = topk_replay_reference(torch.from_numpy(scores), k, EMPTY)
    assert kept.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


def _warp_walk(row: np.ndarray, k: int, empty: int):
    """csrc/topk_replay.cu's walk for one row (one warp), lane by lane."""
    per = 1 if k <= 32 else 2 if k <= 64 else 4 if k <= 128 else 8
    val = np.full((per, 32), -np.inf, np.float32)
    pos = np.full((per, 32), empty, np.int64)
    min_val, min_slot = np.float32(-np.inf), 0
    p = len(row)
    for t0 in range(0, p, 32):
        x = np.array([row[t0 + lane] if t0 + lane < p else -np.inf for lane in range(32)],
                     np.float32)
        above = sum(1 << lane for lane in range(32) if x[lane] > min_val)
        while above:
            i = (above & -above).bit_length() - 1
            j, owner = divmod(min_slot, 32)
            val[j, owner], pos[j, owner] = x[i], t0 + i
            pairs = []
            for lane in range(32):
                v, sl = np.float32(np.inf), 2**31 - 1
                for jj in range(per):
                    slot = jj * 32 + lane
                    if slot < k and (val[jj, lane] < v or (val[jj, lane] == v and slot < sl)):
                        v, sl = val[jj, lane], slot
                pairs.append((v, sl))
            m = 16
            while m:
                pairs = [min(pairs[lane], pairs[lane ^ m]) for lane in range(32)]
                m //= 2
            assert len(set(pairs)) == 1  # every lane ends with the same minimum
            min_val, min_slot = pairs[0]
            above = sum(1 << lane for lane in range(32) if x[lane] > min_val)
            above &= ~((2 << i) - 1) & 0xFFFFFFFF
    slots = range(k)
    return (np.array([val[s // 32, s % 32] for s in slots], np.float32),
            np.array([pos[s // 32, s % 32] for s in slots], np.int32))


@pytest.mark.parametrize("name", CASES)
def test_warp_walk_matches_plain(name):
    scores, k = _case(name)
    kept, idx = topk_replay_reference(torch.from_numpy(scores), k, EMPTY)
    for r in range(scores.shape[0]):
        got_kept, got_idx = _warp_walk(scores[r], k, EMPTY)
        np.testing.assert_array_equal(got_kept, kept[r].numpy(), err_msg=f"row {r}")
        np.testing.assert_array_equal(got_idx, idx[r].numpy(), err_msg=f"row {r}")


def test_cpu_tensor_takes_the_plain_version():
    scores = torch.from_numpy(_case("integer_ties")[0])
    before = dict(kernels.launches)
    kept, idx = topk_replay(scores, 16, EMPTY)
    want_kept, want_idx = topk_replay_reference(scores, 16, EMPTY)
    assert torch.equal(kept, want_kept) and torch.equal(idx, want_idx)
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("k,shape", [(0, (2, 5)), (MAX_K + 1, (2, 5)), (4, (5,))])
def test_topk_replay_refuses_what_the_kernel_does_not_take(k, shape):
    with pytest.raises(ValueError):
        topk_replay(torch.zeros(shape), k, EMPTY)
