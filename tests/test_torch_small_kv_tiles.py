"""The arithmetic of the routes of ``csrc/small_kv_fwd.cu`` and the bf16
route of ``csrc/small_kv_bwd.cu``, held to the bars that chip_smoke.py
holds the kernels to on the card.

``_tile_forward`` walks 64-key tiles twice, as the forward's bf16 route
does:
walk 1 keeps each row's running max m and sum l in log2 units (masked
scores -1e9, padding keys -inf); walk 2 forms w = 2^(s - m) / l, rounds it
to bf16 (the TPU's rounding point: w normalised, then rounded) and sums
w v in fp32. ``_tile_backward`` runs the backward's split: the dq kernel's
online m, l and delta = sum(2^(s - m) dw) / l, then ds rounded to bf16 and
dq = ds k; the dk/dv kernel's round(w)^T do and ds^T q summed per chunk of
64-query tiles (the wrapper's own ``dkdv_chunks``), then over the chunks
in order. ``_split_fp32_forward`` runs the forward's fp32 route: the keys
cut into the wrapper's own ``fwd_chunks`` chunks of 64-key tiles, an
online softmax per chunk, the chunks merged in chunk order.

Each is held against the port's plain version run in fp32 on the same
values at phase 3's bars: forward |Δ| <= 1e-4 + 2^-8 (|plain| + mag), mag
= sum_c w_c |v_c| (rounding w moves each term by at most 2^-8 of it,
rounding out the value by 2^-8), and 1e-4 + 1e-5 (|plain| + mag) in fp32;
backward chip_smoke's TOL_SKV_BWD in bf16,
1e-4 + (2^-8 + 1e-4)(|plain| + mag). And against the JAX package's
``small_kv_attention(impl="interpret")`` and its ``jax.grad`` on the same
inputs: the forward at the same bar, the gradients within 2^-6 of the
largest |gradient| (as tests/test_torch_small_kv_bwd.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import nsa_attention as jnsa
from forde_tpu_torch.ops import nsa_attention as nsa

torch.set_num_threads(1)

BLOCK = 64  # keys per tile of both kernels; queries per tile of the backward
LOG2E = 1.4426950408889634
ATOL, RTOL = 1e-4, 2.0 ** -8
BWD_RTOL = 2.0 ** -8 + 1e-4

# (B, H, S, K, D, keys): pools, top-k, ragged K (padded to 8 on the JAX
# side), padding keys (INVALID_KEY_POS), every key in the future (the
# uniform quirk) and D = 128; S ragged against the 64-row tiles.
CASES = {
    "pools_s200_k24_d64": (2, 2, 200, 24, 64, "pools"),
    "pools_s160_k100_d64": (1, 2, 160, 100, 64, "pools"),
    "topk_s200_k64_d64": (2, 2, 200, 64, 64, "topk"),
    "ragged_s150_k13_d64": (2, 1, 150, 13, 64, "pools"),
    "invalid_s128_k96_d64": (2, 2, 128, 96, 64, "invalid"),
    "future_s64_k40_d64": (1, 2, 64, 40, 64, "future"),
    "pools_s100_k70_d128": (1, 2, 100, 70, 128, "pools"),
}


def _inputs(case, seed=0):
    """bf16 q, k, v, do and int32 key_pos of one case."""
    b, h, s, kk, d, kind = CASES[case]
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, kk, d).astype(np.float32) for _ in range(2))
    if kind == "pools":  # pool j visible from position (j + 1) * (S // K)
        key_pos = np.broadcast_to((np.arange(kk) + 1) * max(s // kk, 1), (b, kk))
    elif kind == "topk":  # selected token indices
        key_pos = np.stack([rng.permutation(s)[:kk] for _ in range(b)])
    elif kind == "invalid":  # a row's pools past its length
        key_pos = np.broadcast_to((np.arange(kk) + 1) * 2, (b, kk)).copy()
        key_pos[0, kk // 2:] = nsa.INVALID_KEY_POS
        key_pos[1, 5:] = nsa.INVALID_KEY_POS
    else:  # every key in the future
        key_pos = np.full((b, kk), s + 10)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    return (*bf, torch.from_numpy(np.ascontiguousarray(key_pos, np.int32)))


def _scores(q, k, key_pos, scale):
    """(B, H, S, K) fp32 scores in log2 units with the kernels' masks, and
    the mask (visible keys)."""
    x = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    pos = torch.arange(q.shape[2])[None, None, :, None]
    kpos = key_pos.to(torch.int64)[:, None, None, :]
    real = kpos < nsa.INVALID_KEY_POS
    vis = (pos >= kpos) & real
    x = torch.where(vis, x, torch.full_like(x, nsa.NEG_BIG))
    return torch.where(real, x, torch.full_like(x, -float("inf"))), vis


def _row_stats(x, dw=None):
    """Walk 1 over the key tiles: the online max m and sum l of 2^(x - m)
    and, with dw, the sum u of 2^(x - m) dw, rescaled as m grows."""
    m = torch.full(x.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    u = torch.zeros_like(m)
    for k0 in range(0, x.shape[-1], BLOCK):
        xt = x[..., k0:k0 + BLOCK]
        mn = torch.maximum(m, xt.amax(-1, keepdim=True))
        ms = torch.where(mn == -float("inf"), torch.zeros_like(mn), mn)
        alpha = torch.exp2(m - ms)
        p = torch.exp2(xt - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        if dw is not None:
            u = u * alpha + (p * dw[..., k0:k0 + BLOCK]).sum(-1, keepdim=True)
        m = mn
    return m, l, u


def _tile_forward(q, k, v, key_pos, scale):
    """The forward's bf16 route: out (B, H, S, D) bf16."""
    x, _ = _scores(q, k, key_pos, scale)
    m, l, _ = _row_stats(x)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], BLOCK):
        w = torch.exp2(x[..., k0:k0 + BLOCK] - m) * (1.0 / l)
        acc = acc + w.to(torch.bfloat16).float() @ v[:, :, k0:k0 + BLOCK].float()
    return acc.to(torch.bfloat16)


def _tile_backward(q, k, v, key_pos, do, scale):
    """The backward's bf16 route: (dq, dk, dv) bf16."""
    b, h, s, d = q.shape
    kk = k.shape[2]
    x, vis = _scores(q, k, key_pos, scale)
    dw = do.float() @ v.float().transpose(-1, -2)
    # dq kernel: walk 1 (m, l, delta), walk 2 (ds rounded, dq = ds k).
    m, l, u = _row_stats(x, dw)
    delta = u / l
    w = torch.exp2(x - m) * (1.0 / l)
    ds = torch.where(vis, w * (dw - delta) * scale, torch.zeros(()))
    ds = ds.to(torch.bfloat16).float()
    dq = torch.zeros(b, h, s, d)
    for k0 in range(0, kk, BLOCK):
        dq = dq + ds[..., k0:k0 + BLOCK] @ k[:, :, k0:k0 + BLOCK].float()
    # dk/dv kernel: per chunk of query tiles, then the chunks in order.
    wr = w.to(torch.bfloat16).float()
    tiles = -(-s // BLOCK)
    chunks = nsa.dkdv_chunks(b, h, s, kk)
    per = -(-tiles // chunks)
    dk = torch.zeros(b, h, kk, d)
    dv = torch.zeros(b, h, kk, d)
    for c in range(chunks):
        part_k = torch.zeros(b, h, kk, d)
        part_v = torch.zeros(b, h, kk, d)
        for it in range(c * per, min(tiles, (c + 1) * per)):
            rows = slice(it * BLOCK, (it + 1) * BLOCK)
            part_v = part_v + wr[:, :, rows].transpose(-1, -2) @ do[:, :, rows].float()
            part_k = part_k + ds[:, :, rows].transpose(-1, -2) @ q[:, :, rows].float()
        dk = dk + part_k
        dv = dv + part_v
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _fwd_magnitude(q, k, v, key_pos, scale):
    """sum_c w_c |v_c| per element of out, fp32 weights."""
    w = torch.softmax(nsa._masked_scores(q.float(), k.float(), key_pos, scale), dim=-1)
    return w @ v.float().abs()


def _bwd_magnitudes(q, k, v, key_pos, do, scale):
    """Per element of dq, dk, dv the sum of the absolute terms it adds up."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    w = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    dw = do @ v.transpose(-1, -2)
    ds = (w * (dw - (dw * w).sum(-1, keepdim=True)) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), w.transpose(-1, -2) @ do.abs()


def _assert_within_bar(got, want, plain, mag, rtol=RTOL):
    """|got - want| <= atol + rtol (|plain| + mag) per element."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / (ATOL + rtol * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"worst |Δ| / (atol + rtol (|plain| + mag)) = {worst:.3f}"


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_plain_fp32(case):
    q, k, v, _, key_pos = _inputs(case)
    scale = q.shape[-1] ** -0.5
    out = _tile_forward(q, k, v, key_pos, scale)
    plain = nsa.small_kv_fwd_reference(q.float(), k.float(), v.float(), key_pos, scale)
    _assert_within_bar(out, plain, plain, _fwd_magnitude(q, k, v, key_pos, scale))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_jax_kernel_bf16(case):
    """The same bf16 values through the Pallas kernel (interpret mode),
    which rounds w at the same point."""
    q, k, v, _, key_pos = _inputs(case, seed=1)
    scale = q.shape[-1] ** -0.5
    want = jnsa.small_kv_attention(_jax(q), _jax(k), _jax(v), jnp.asarray(key_pos.numpy()),
                                   impl="interpret")
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    out = _tile_forward(q, k, v, key_pos, scale)
    plain = nsa.small_kv_fwd_reference(q.float(), k.float(), v.float(), key_pos, scale)
    assert want.shape == out.shape
    _assert_within_bar(out, want, plain, _fwd_magnitude(q, k, v, key_pos, scale))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_backward_matches_plain_fp32(case):
    q, k, v, do, key_pos = _inputs(case, seed=2)
    scale = q.shape[-1] ** -0.5
    got = _tile_backward(q, k, v, key_pos, do, scale)
    want = nsa.small_kv_bwd_reference(q.float(), k.float(), v.float(), key_pos, do.float(),
                                      scale)
    mags = _bwd_magnitudes(q, k, v, key_pos, do, scale)
    for g, w, m in zip(got, want, mags):
        _assert_within_bar(g, w, w, m, rtol=BWD_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_backward_matches_jax_grad_bf16(case):
    q, k, v, do, key_pos = _inputs(case, seed=3)
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        out = jnsa.small_kv_attention(q, k, v, jnp.asarray(key_pos.numpy()), impl="interpret",
                                      block_q=16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do.float().numpy()))

    want = jax.grad(f, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    got = _tile_backward(q, k, v, key_pos, do, scale)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= 2.0 ** -6 * np.abs(w).max(), f"d{name}"


def test_row_with_no_visible_key_is_uniform():
    """The uniform quirk on both routes' arithmetic: every key in the
    future gives out = the mean of v (w = 1/K rounded to bf16), and ds
    zeroed where the mask was false, so dq and dk are exactly 0."""
    q, k, v, do, key_pos = _inputs("future_s64_k40_d64", seed=4)
    scale = q.shape[-1] ** -0.5
    out = _tile_forward(q, k, v, key_pos, scale)
    mean = v.float().mean(dim=2, keepdim=True).expand(out.shape)
    _assert_within_bar(out, mean, mean, _fwd_magnitude(q, k, v, key_pos, scale))
    dq, dk, dv = _tile_backward(q, k, v, key_pos, do, scale)
    assert dq.abs().max() == 0 and dk.abs().max() == 0
    assert dv.abs().max() > 0


@pytest.mark.parametrize("shape", [
    (8, 8, 2048, 192), (8, 8, 2048, 64), (1, 8, 8192, 960), (2, 4, 2048, 200),
    (4, 8, 512, 96), (2, 4, 64, 40), (2, 2, 256, 100), (1, 1, 1000, 13),
])
def test_dkdv_chunks_depend_on_shape_and_cover_s(shape):
    """The chunk count is a function of (B, H, S, K) alone; the kernel's
    split of the query tiles into that many chunks covers S once, with no
    chunk empty, and starts about TARGET_BLOCKS blocks where S has the
    tiles for it."""
    b, h, s, kk = shape
    chunks = nsa.dkdv_chunks(b, h, s, kk)
    assert chunks == nsa.dkdv_chunks(b, h, s, kk)
    tiles = -(-s // 64)
    per = -(-tiles // chunks)  # the kernel's chunk_tiles
    spans = [range(c * per, min(tiles, (c + 1) * per)) for c in range(chunks)]
    assert all(len(r) > 0 for r in spans)
    assert [i for r in spans for i in r] == list(range(tiles))
    blocks = -(-kk // 64) * b * h
    assert blocks * chunks >= min(nsa.TARGET_BLOCKS, blocks * tiles) * 0.5
    if blocks >= nsa.TARGET_BLOCKS:
        assert chunks == 1


def test_kernel_args_reject_unaligned_pointers():
    """The bf16 kernels copy with 16-byte cp.async: a tensor that starts
    off a 16-byte boundary (a view into a cache) is refused before any
    launch."""
    n = 2 * 64 * 64
    buf = torch.empty(8 + n, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte aligned do"):
        nsa._check_aligned("small_kv_bwd", do=buf[1:1 + n].view(1, 2, 64, 64))
    nsa._check_aligned("small_kv_bwd", do=buf[8:].view(1, 2, 64, 64))


FP32_ATOL, FP32_RTOL = 1e-4, 1e-5


def _split_fp32_forward(q, k, v, key_pos, scale):
    """The fp32 route: the keys cut into ``fwd_chunks`` chunks of whole
    64-key tiles; per chunk one walk over its tiles with an online softmax
    in natural units (running max m_c, a max still -inf taken as 0; sum l_c
    of exp(s - m_c); acc_c = sum exp(s - m_c) v); then the chunks in order:
    m = max m_c, out = sum e^(m_c - m) acc_c / sum e^(m_c - m) l_c. Returns
    out and the chunks' m_c."""
    b, h, s, _ = q.shape
    kk = k.shape[2]
    x = nsa._masked_scores(q, k, key_pos, scale)
    tiles = -(-kk // BLOCK)
    chunks = nsa.fwd_chunks(b, h, s, kk)
    per = -(-tiles // chunks)
    neg_inf = -float("inf")

    def finite(m):
        return torch.where(m == neg_inf, torch.zeros_like(m), m)

    parts = []
    for c in range(chunks):
        m = torch.full((b, h, s, 1), neg_inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape)
        spans = range(c * per, min(tiles, (c + 1) * per))
        assert len(spans) > 0
        for t in spans:
            keys = slice(t * BLOCK, (t + 1) * BLOCK)
            xt = x[..., keys]
            mn = torch.maximum(m, xt.amax(-1, keepdim=True))
            ms = finite(mn)
            alpha = torch.exp(m - ms)
            p = torch.exp(xt - ms)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ v[:, :, keys]
            m = mn
        parts.append((m, l, acc))
    ms = finite(torch.stack([m for m, _, _ in parts]).amax(0))
    num, den = torch.zeros(q.shape), torch.zeros(b, h, s, 1)
    for m, l, acc in parts:
        w = torch.exp(m - ms)
        num = num + w * acc
        den = den + w * l
    return num / den, [m for m, _, _ in parts]


# (B, H, S, K, keys) of the fp32 route: decode_scaling's decode pools at
# 16,384 positions; K past 1,024 and not a multiple of the tile, with and
# without padding keys; the default serve's decode pools (8 rows of 8
# heads, 256 pools); a decode row that sees no key (the uniform quirk
# across chunks); padding keys that fill whole chunks; K = FWD_MAX_KEYS;
# a few query rows (one block each); a prefill whose query tiles fill the
# card (one chunk).
FP32_CASES = [
    (1, 4, 1, 4096, "decode_pools"),
    (2, 2, 70, 1100, "pools"),
    (2, 2, 70, 1100, "invalid"),
    (8, 8, 1, 256, "decode_pools"),
    (1, 4, 1, 4096, "future"),
    (2, 4, 1, 4096, "padded"),
    (1, 4, 1, 8192, "decode_pools"),
    (1, 2, 5, 300, "pools"),
    (8, 4, 512, 192, "pools"),
]


def _fp32_inputs(b, h, s, kk, kind, seed):
    """fp32 q, k, v (D = 64) and int32 key_pos of one FP32_CASES entry."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, h, s, 64).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(b, h, kk, 64).astype(np.float32)) for _ in range(2))
    j = np.arange(kk)
    if kind in ("decode_pools", "padded"):  # pool p joins once cur >= 4 (p + 1) + 511
        cur = rng.randint(515, 511 + 4 * kk, size=(b, 1))
        key_pos = 4 * (j + 1) + 511 - cur
        if kind == "padded":  # a row's pools past its count
            key_pos[j[None, :] >= np.array([1000, 70])[:b, None]] = nsa.INVALID_KEY_POS
    elif kind == "future":
        key_pos = np.full((b, kk), s + 10)
    else:
        key_pos = np.broadcast_to((j + 1) * 2, (b, kk)).copy()
        if kind == "invalid":
            key_pos[1, 700:] = nsa.INVALID_KEY_POS
    return q, k, v, torch.from_numpy(np.ascontiguousarray(key_pos, np.int32))


def _assert_fp32_bar(got, want, plain, mag):
    diff = (got - want).abs()
    worst = (diff / (FP32_ATOL + FP32_RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"worst |Δ| / (1e-4 + 1e-5 (|plain| + mag)) = {worst:.3f}"


@pytest.mark.parametrize("b,h,s,kk,kind", FP32_CASES)
def test_long_fp32_forward_matches_plain(b, h, s, kk, kind):
    """The fp32 route (csrc/small_kv_fwd.cu ``small_kv_fwd_split_kernel``
    and ``small_kv_fwd_merge_kernel``) held to phase 3's fp32 bar against
    the plain version, for every K up to ``FWD_MAX_KEYS`` (the backward
    stays at ``MAX_KEYS``). A chunk of padding adds nothing; a row that
    sees no key averages v over the real keys, whatever the chunks."""
    q, k, v, key_pos = _fp32_inputs(b, h, s, kk, kind, seed=5)
    scale = 64 ** -0.5
    got, maxes = _split_fp32_forward(q, k, v, key_pos, scale)
    want = nsa.small_kv_fwd_reference(q, k, v, key_pos, scale)
    mag = _fwd_magnitude(q, k, v, key_pos, scale)
    assert torch.isfinite(got).all()
    _assert_fp32_bar(got, want, want, mag)
    assert kk <= nsa.FWD_MAX_KEYS and nsa.MAX_KEYS == 1024
    if kind == "future":
        assert len(maxes) > 1
        mean = v.mean(dim=2, keepdim=True).expand(got.shape)
        _assert_fp32_bar(got, mean, mean, mag)
    if kind == "padded":  # row 1's chunks past its 70 pools hold padding alone
        padding = [m[1].amax().item() == -float("inf") for m in maxes]
        assert sum(padding) >= len(maxes) // 2


@pytest.mark.parametrize("b,h,s,kk,kind", FP32_CASES)
def test_long_fp32_forward_matches_jax_kernel(b, h, s, kk, kind):
    """The same fp32 values through the Pallas kernel (interpret mode):
    one straight softmax per block of queries over all the keys."""
    q, k, v, key_pos = _fp32_inputs(b, h, s, kk, kind, seed=6)
    scale = 64 ** -0.5
    want = jnsa.small_kv_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v, key_pos)),
                                   impl="interpret")
    want = torch.from_numpy(np.array(want))
    got, _ = _split_fp32_forward(q, k, v, key_pos, scale)
    plain = nsa.small_kv_fwd_reference(q, k, v, key_pos, scale)
    assert want.shape == got.shape
    _assert_fp32_bar(got, want, plain, _fwd_magnitude(q, k, v, key_pos, scale))


@pytest.mark.parametrize("shape,want", [
    ((1, 4, 1, 4096), 64),  # decode_scaling at 16,384 positions
    ((1, 4, 1, 512), 8),  # and at 2,048
    ((8, 8, 1, 256), 4),  # the default serve's decode pools
    ((8, 8, 1, 64), 1),  # its kept rows: one tile
    ((1, 8, 1, 256), 4),
    ((1, 4, 1, 8192), 64),
    ((2, 4, 1, 4096), 32),
    ((1, 2, 5, 300), 5),
    ((8, 8, 2048, 192), 1),  # the default serve's prefill pools
    ((8, 4, 512, 192), 1),
    ((2, 2, 70, 1100), 18),
])
def test_fwd_chunks_depend_on_shape_and_cover_k(shape, want):
    """The fp32 forward's chunk count is a function of (B, H, S, K) alone;
    its split of the key tiles covers K once with no chunk empty, gives 1
    chunk where the query tiles reach TARGET_BLOCKS blocks and more than 1
    at a decode step with more than one tile."""
    b, h, s, kk = shape
    chunks = nsa.fwd_chunks(b, h, s, kk)
    assert chunks == nsa.fwd_chunks(b, h, s, kk) == want
    tiles = -(-kk // 64)
    per = -(-tiles // chunks)  # the kernel's tiles per chunk
    spans = [range(c * per, min(tiles, (c + 1) * per)) for c in range(chunks)]
    assert all(len(r) > 0 for r in spans)
    assert [i for r in spans for i in r] == list(range(tiles))
    blocks = (s if s <= nsa.FWD_ROW_MAX_S else -(-s // 32)) * b * h
    assert blocks * chunks >= min(nsa.TARGET_BLOCKS, blocks * tiles) * 0.5
    if blocks >= nsa.TARGET_BLOCKS:
        assert chunks == 1
    if s == 1 and tiles > 1:
        assert chunks > 1


def test_decode_pools_at_16384_positions_fit_the_forward():
    """decode_scaling's longer length: 4,096 pools at ratio 4 (the JAX
    package's test config), within the forward kernel's key limit."""
    from forde_tpu_torch.core.config import create_default_config
    from forde_tpu_torch.nn.attention import NativeSparseAttention

    cfg = create_default_config().replace(max_seq_len=16384, window_size=512)
    attn = NativeSparseAttention(cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.window_size,
                                 cfg.compression_ratio, cfg.top_k_global,
                                 max_decode_len=cfg.max_seq_len, device="meta")
    assert attn.max_pools() == 4096 <= nsa.FWD_MAX_KEYS
