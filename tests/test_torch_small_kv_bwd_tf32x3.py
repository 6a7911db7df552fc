"""The arithmetic of the fp32 route of ``csrc/small_kv_bwd.cu``: every
product three TF32 passes on the tensor cores, held to the bar that
chip_smoke.py holds the kernels to on the card.

Each fp32 operand is split as x = hi + lo (``split_tf32`` of
``csrc/mma.cuh``; ``_split`` of tests/test_torch_flash_mha_tf32x3.py), and
a product a b is taken as tf32(lo_a) hi_b + hi_a tf32(lo_b) + hi_a hi_b in
fp32 (``_mm3``). ``_tf32x3_backward`` runs the two kernels:

  * the dq kernel walks the key tiles twice: walk 1 keeps each row's
    online max m and sum l of 2^(s - m) in log2 units (masked scores -1e9,
    padding keys -inf) and the sum u of 2^(s - m) dw, with s = q k^T and
    dw = do v^T from three-pass products; delta = u / l. Walk 2 forms ds =
    w (dw - delta) scale, zeroed where the mask was false, splits it and
    sums dq = ds k;
  * the dk/dv kernel takes the queries of each chunk (the wrapper's
    ``dkdv_chunks`` of 64-query tiles) in tiles of 16: s^T = k q^T and
    dw^T = v do^T, w^T from the dq kernel's m, l (selected to 0 past S),
    ds^T from its delta, both split before w^T do and ds^T q; the chunks'
    partials are summed in chunk order.

It is held against the port's plain version (``small_kv_bwd_reference``)
and against ``jax.grad`` of the JAX package's ``small_kv_attention(impl=
"interpret")`` on the same fp32 inputs, at phase 3's fp32 bar
``TOL_SKV_BWD["float32"]``: |Δ| <= 1e-4 + 1e-4 (|plain| + mag) per
element, mag the sum of the absolute terms the element adds up.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import nsa_attention as jnsa
from forde_tpu_torch.ops import nsa_attention as nsa
from tests.test_torch_flash_mha_tf32x3 import _split, _tf32

torch.set_num_threads(1)

CSRC = Path(nsa.__file__).resolve().parent.parent / "csrc"
LOG2E = 1.4426950408889634
ATOL, RTOL = 1e-4, 1e-4  # chip_smoke's TOL_SKV_BWD["float32"]
BQ = 64  # query rows of a dq block; the chunks' query tiles
DKDV_QUERIES = 16  # queries per tile of the dk/dv kernel


def dq_keys(d):
    """Keys per tile of the dq kernel."""
    return 16 if d == 128 else 32


# (B, H, S, K, D, keys): pools (a row that sees no key first), top-k,
# padding keys (INVALID_KEY_POS), every key in the future (the uniform
# quirk), D = 128, K = 200 (not a multiple of the tiles), and MAX_KEYS at
# D = 128 as chip_smoke's max_keys_s256_k1024_d128 (a pool every 8
# positions: most keys masked for every row).
CASES = {
    "pools_s200_k24_d64": (2, 2, 200, 24, 64, "pools"),
    "topk_s200_k64_d64": (2, 2, 200, 64, 64, "topk"),
    "invalid_s128_k96_d64": (2, 2, 128, 96, 64, "invalid"),
    "future_s64_k40_d64": (1, 2, 64, 40, 64, "future"),
    "pools_s100_k70_d128": (1, 2, 100, 70, 128, "pools"),
    "pools_s150_k200_d64": (1, 2, 150, 200, 64, "pools"),
    "max_keys_s256_k1024_d128": (1, 2, 256, 1024, 128, "pools8"),
}


def _inputs(case, seed=0):
    """fp32 q, k, v, do and int32 key_pos of one case."""
    b, h, s, kk, d, kind = CASES[case]
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, h, kk, d).astype(np.float32)) for _ in range(2))
    j = np.arange(kk)
    if kind == "pools":  # pool j visible from position (j + 1) * (S // K)
        key_pos = np.broadcast_to((j + 1) * max(s // kk, 1), (b, kk))
    elif kind == "pools8":
        key_pos = np.broadcast_to((j + 1) * 8, (b, kk))
    elif kind == "topk":  # selected token indices
        key_pos = np.stack([rng.permutation(s)[:kk] for _ in range(b)])
    elif kind == "invalid":  # a row's pools past its count
        key_pos = np.broadcast_to((j + 1) * 2, (b, kk)).copy()
        key_pos[0, kk // 2:] = nsa.INVALID_KEY_POS
        key_pos[1, 5:] = nsa.INVALID_KEY_POS
    else:  # every key in the future
        key_pos = np.full((b, kk), s + 10)
    return q, k, v, do, torch.from_numpy(np.ascontiguousarray(key_pos, np.int32))


def _mm3(a, b):
    """a @ b in three TF32 passes, summed in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return _tf32(al) @ bh + ah @ _tf32(bl) + ah @ bh


def _masks(s, key_pos):
    """(B, 1, S, K) visible keys and real (non-padding) keys."""
    pos = torch.arange(s)[None, None, :, None]
    kpos = key_pos.to(torch.int64)[:, None, None, :]
    real = kpos < nsa.INVALID_KEY_POS
    return (pos >= kpos) & real, real.expand(-1, -1, s, -1)


def _log2_scores(x, vis, real):
    """Scores in log2 units with the kernels' masks (skv_score)."""
    x = torch.where(vis, x, torch.full_like(x, nsa.NEG_BIG))
    return torch.where(real, x, torch.full_like(x, -float("inf")))


def _tf32x3_backward(q, k, v, key_pos, do, scale):
    """The fp32 route's arithmetic: (dq, dk, dv), fp32."""
    b, h, s, d = q.shape
    kk = k.shape[2]
    vis, real = _masks(s, key_pos)
    # dq kernel, walk 1: the online m, l and u over the key tiles.
    kt = dq_keys(d)
    m = torch.full((b, h, s, 1), -float("inf"))
    l = torch.zeros_like(m)
    u = torch.zeros_like(m)
    for k0 in range(0, kk, kt):
        cols = slice(k0, k0 + kt)
        x = _log2_scores(_mm3(q, k[:, :, cols].transpose(-1, -2)) * (scale * LOG2E),
                         vis[..., cols], real[..., cols])
        dw = _mm3(do, v[:, :, cols].transpose(-1, -2))
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        ms = torch.where(mn == -float("inf"), torch.zeros_like(mn), mn)
        alpha = torch.exp2(m - ms)
        p = torch.exp2(x - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        u = u * alpha + (p * dw).sum(-1, keepdim=True)
        m = mn
    delta = u / l
    # Walk 2: ds, split as it stands, times the key tile.
    dq = torch.zeros(b, h, s, d)
    for k0 in range(0, kk, kt):
        cols = slice(k0, k0 + kt)
        x = _log2_scores(_mm3(q, k[:, :, cols].transpose(-1, -2)) * (scale * LOG2E),
                         vis[..., cols], real[..., cols])
        dw = _mm3(do, v[:, :, cols].transpose(-1, -2))
        w = torch.exp2(x - m) * (1.0 / l)
        ds = torch.where(vis[..., cols], w * (dw - delta) * scale, torch.zeros(()))
        dq = dq + _mm3(ds, k[:, :, cols])
    # dk/dv kernel: per chunk of 64-query tiles, its queries in tiles of 16
    # (s^T = k q^T), then the chunks' partials in order.
    tiles = -(-s // BQ)
    chunks = nsa.dkdv_chunks(b, h, s, kk)
    per = -(-tiles // chunks)
    dk = torch.zeros(b, h, kk, d)
    dv = torch.zeros(b, h, kk, d)
    for c in range(chunks):
        part_k = torch.zeros(b, h, kk, d)
        part_v = torch.zeros(b, h, kk, d)
        for r0 in range(c * per * BQ, min(s, (c + 1) * per * BQ), DKDV_QUERIES):
            rows = slice(r0, min(s, r0 + DKDV_QUERIES))
            xt = _mm3(k, q[:, :, rows].transpose(-1, -2)).transpose(-1, -2)
            xt = _log2_scores(xt * (scale * LOG2E), vis[:, :, rows], real[:, :, rows])
            dwt = _mm3(v, do[:, :, rows].transpose(-1, -2)).transpose(-1, -2)
            w = torch.exp2(xt - m[:, :, rows]) * (1.0 / l[:, :, rows])
            ds = torch.where(vis[:, :, rows], w * (dwt - delta[:, :, rows]) * scale,
                             torch.zeros(()))
            part_v = part_v + _mm3(w.transpose(-1, -2), do[:, :, rows])
            part_k = part_k + _mm3(ds.transpose(-1, -2), q[:, :, rows])
        dk = dk + part_k
        dv = dv + part_v
    return dq, dk, dv


def _bwd_magnitudes(q, k, v, key_pos, do, scale):
    """Per element of dq, dk, dv the sum of the absolute terms it adds up
    (chip_smoke's small_kv_bwd_magnitudes)."""
    w = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    dw = do @ v.transpose(-1, -2)
    ds = (w * (dw - (dw * w).sum(-1, keepdim=True)) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), w.transpose(-1, -2) @ do.abs()


def _assert_within_bar(got, want, plain, mag, what):
    worst = ((got - want).abs() / (ATOL + RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"{what}: worst |Δ| / (1e-4 + 1e-4 (|plain| + mag)) = {worst:.3f}"


def test_tiles_are_the_kernels():
    """The emulation walks the tiles the CUDA source uses."""
    src = (CSRC / "small_kv_bwd.cu").read_text()
    m = re.search(r"constexpr int tf32_dq_keys\(\) \{\s*return D == 128 \? (\d+) : (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (dq_keys(128), dq_keys(64))
    assert re.search(rf"constexpr int TF32_DKDV_QUERIES = {DKDV_QUERIES};", src)
    assert re.search(rf"constexpr int BQ = {BQ};", src)
    assert re.search(r"constexpr int MAX_KEYS = (\d+);", src)[1] == str(nsa.MAX_KEYS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_plain_fp32(case):
    q, k, v, do, key_pos = _inputs(case, seed=7)
    scale = q.shape[-1] ** -0.5
    got = _tf32x3_backward(q, k, v, key_pos, do, scale)
    want = nsa.small_kv_bwd_reference(q, k, v, key_pos, do, scale)
    mags = _bwd_magnitudes(q, k, v, key_pos, do, scale)
    for name, g, w, mag in zip(("dq", "dk", "dv"), got, want, mags):
        assert torch.isfinite(g).all(), name
        _assert_within_bar(g, w, w, mag, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_jax_grad_fp32(case):
    q, k, v, do, key_pos = _inputs(case, seed=8)
    scale = q.shape[-1] ** -0.5
    pos = jnp.asarray(key_pos.numpy())

    def f(q, k, v):
        out = jnsa.small_kv_attention(q, k, v, pos, impl="interpret", block_q=16)
        return jnp.sum(out * jnp.asarray(do.numpy()))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    got = _tf32x3_backward(q, k, v, key_pos, do, scale)
    plain = nsa.small_kv_bwd_reference(q, k, v, key_pos, do, scale)
    mags = _bwd_magnitudes(q, k, v, key_pos, do, scale)
    for name, g, w, p, mag in zip(("dq", "dk", "dv"), got, want, plain, mags):
        w = torch.from_numpy(np.array(w))
        assert w.shape == g.shape, name
        _assert_within_bar(g, w, p, mag, name)


def test_row_with_no_visible_key_moves_dv_alone():
    """Every key in the future: each row carries the uniform weights into
    dv, and ds is zeroed where the mask was false, so dq and dk are exactly
    0; a padding key gets nothing."""
    q, k, v, do, key_pos = _inputs("future_s64_k40_d64", seed=9)
    dq, dk, dv = _tf32x3_backward(q, k, v, key_pos, do, 64 ** -0.5)
    assert dq.abs().max() == 0 and dk.abs().max() == 0
    mean = do.sum(dim=2, keepdim=True).expand(dv.shape) / k.shape[2]
    _assert_within_bar(dv, mean, mean, do.abs().sum(dim=2, keepdim=True) / k.shape[2], "dv")
    q, k, v, do, key_pos = _inputs("invalid_s128_k96_d64", seed=9)
    _, dk, dv = _tf32x3_backward(q, k, v, key_pos, do, 64 ** -0.5)
    padding = key_pos >= nsa.INVALID_KEY_POS
    assert padding.any()
    for grad in (dk, dv):
        assert grad.transpose(1, 2)[padding].abs().max() == 0
