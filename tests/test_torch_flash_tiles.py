"""The index arithmetic and the rounding points of the bf16 tensor-core
routes of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (its dq and dk/dv
kernels), held to the bars that chip_smoke.py holds the kernels to on the
card.

Tile walks. ``_fwd_walk`` and ``_dkv_walk`` mirror the kernels' bounds in
plain Python: the key tiles a block of query rows walks (``key_tiles`` of
``common.cuh``, which the forward and the dq kernel share) and, per warp of
16 rows, the interior tiles that skip the mask or the select
(``interior_tiles``, the JAX package's ``_loop_bounds`` split); the query
tiles a block of 64 keys walks (``query_tiles``) and, per warp of 16 keys,
the interior tiles that skip the select (``interior_query_tiles``). Over
every S, window, causal and kv_len of the grid below, every visible (query,
key) pair must lie in a walked tile, and every pair of an interior tile
must be visible. Both are exact.

Rounding points. ``_tile_forward`` is the forward route's arithmetic in
plain torch: the walk above, 64-key tiles, scores in log2 units, masked
scores and the running max's start at -1e30, p = 2^(s - m) rounded to bf16
against the running max, l summed from the unrounded p, o = acc / l
rounded to bf16 at the end. ``_tile_dkv`` is the dk/dv route's: per key
block, the walked query tiles in order, each in two chunks of 32 queries,
p = 2^(s log2(e) scale - lse log2(e)) selected to 0 where masked,
dv += round(p)^T do and dk += round(p (dp - delta) scale)^T q in fp32.
``_tile_dq`` is the dq route's: per 64-row block, the walked key tiles in
order, p as for dk/dv, dq += round(p (dp - delta) scale) k in fp32, then
rounded to bf16.

On bf16 inputs from a numpy seed they are held against the port's plain
versions run in fp32 on the same values (``flash_fwd_reference``,
``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``) and against the
JAX package's Pallas kernels
in interpret mode (``flash_attention(impl="interpret")`` for the forward,
``_bwd_pallas(interpret=True)`` on the same q, k, v, o, lse and do for the
backward), per element at |Δ| <= 1e-4 + 2^-8 (|plain| + mag): chip_smoke's
TOL_ATTN and TOL_BWD in bf16. mag is the sum of the absolute terms the
element adds up (softmax weights times |v| for o; |ds|^T |q| for dk,
p^T |do| for dv): rounding p or ds to bf16 moves each term by at most 2^-9
of it, rounding the output its value by 2^-9, and the two sides sum in
other orders. For dq, mag is |ds| |k|. lse within 1e-4 (TOL_LSE): fp32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import flash_attention as jfa
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

BLOCK = 64      # keys per tile; query rows per block (64-row blocks) and per tile
WARP = 16       # query rows (forward) or keys (dk/dv) per warp
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASK = -1e30
ATOL, RTOL = 1e-4, 2.0 ** -8


# ---------------------------------------------------------------------------
# The tile walks
# ---------------------------------------------------------------------------


def _key_tiles(q0, rows, s, causal, window, kv_len):
    """flash_fwd.cu ``key_tiles``: [j_begin, j_end) of the block of ``rows``
    query rows at q0, at least one tile."""
    j_end = -(-kv_len // BLOCK) if kv_len is not None else s // BLOCK
    if causal:
        j_end = min(j_end, (q0 + rows - 1) // BLOCK + 1)
    j_begin = max(0, q0 - window + 1) // BLOCK if window is not None else 0
    if j_end <= j_begin:
        j_end = j_begin + 1
    return j_begin, j_end


def _interior_tiles(r0, rows, j_begin, j_end, causal, window, kv_len):
    """flash_fwd.cu ``interior_tiles``: [fs, fe), the tiles with every pair
    of rows [r0, r0 + rows) visible."""
    fs, fe = j_begin, j_end
    if window is not None:
        fs = max(fs, -((window - r0 - rows) // BLOCK))
    if causal:
        fe = min(fe, (r0 - BLOCK + 1) // BLOCK + 1)
    if kv_len is not None:
        fe = min(fe, kv_len // BLOCK)
    fs = min(max(fs, j_begin), j_end)
    return fs, min(max(fe, fs), j_end)


def _query_tiles(k0, s, keys, causal, window):
    """flash_bwd.cu ``query_tiles``: [i_begin, i_end) of the key block at
    k0."""
    i_begin = k0 // BLOCK if causal else 0
    i_end = s // BLOCK if k0 < keys else 0
    if window is not None:
        i_end = min(i_end, (k0 + BLOCK - 1 + window - 1) // BLOCK + 1)
    return i_begin, i_end


def _interior_query_tiles(c0, cols, i_begin, i_end, keys, causal, window):
    """flash_bwd.cu ``interior_query_tiles``: [fs, fe), the query tiles
    with every pair of keys [c0, c0 + cols) visible."""
    fs, fe = i_begin, i_end
    if causal:
        fs = max(fs, -(-(c0 + cols - 1) // BLOCK))
    if window is not None:
        fe = min(fe, (c0 + window - BLOCK) // BLOCK + 1)
    if c0 + cols > keys:
        fe = fs
    fs = min(max(fs, i_begin), i_end)
    return fs, min(max(fe, fs), i_end)


def _visible(s, causal, window, kv_len):
    pos = np.arange(s)
    vis = np.ones((s, s), bool)
    if causal:
        vis &= pos[:, None] >= pos[None, :]
    if window is not None:
        vis &= pos[:, None] - pos[None, :] < window
    if kv_len is not None:
        vis &= pos[None, :] < kv_len
    return vis


def _fwd_walk(s, causal, window, kv_len, rows):
    """(walked, interior): (S, S) masks of the (query, key) pairs in a tile
    the forward (or the dq kernel, at 64 rows) walks, and in a tile it walks
    without the mask."""
    walked = np.zeros((s, s), bool)
    interior = np.zeros((s, s), bool)
    for q0 in range(0, s, rows):
        j_begin, j_end = _key_tiles(q0, rows, s, causal, window, kv_len)
        assert j_end > j_begin
        walked[q0:q0 + rows, j_begin * BLOCK:j_end * BLOCK] = True
        for r0 in range(q0, min(q0 + rows, s), WARP):
            fs, fe = _interior_tiles(r0, WARP, j_begin, j_end, causal, window, kv_len)
            interior[r0:r0 + WARP, fs * BLOCK:fe * BLOCK] = True
    return walked, interior


def _dkv_walk(s, causal, window, kv_len):
    """(walked, interior) of the dk/dv kernel, per key block of 64."""
    keys = s if kv_len is None else min(kv_len, s)
    walked = np.zeros((s, s), bool)
    interior = np.zeros((s, s), bool)
    for k0 in range(0, s, BLOCK):
        i_begin, i_end = _query_tiles(k0, s, keys, causal, window)
        walked[i_begin * BLOCK:i_end * BLOCK, k0:k0 + BLOCK] = True
        for c0 in range(k0, k0 + BLOCK, WARP):
            fs, fe = _interior_query_tiles(c0, WARP, i_begin, i_end, keys, causal, window)
            interior[fs * BLOCK:fe * BLOCK, c0:c0 + WARP] = True
    return walked, interior


WALK_S = (64, 192, 1024, 2048)
WALK_WINDOWS = (None, 1, 63, 64, 65, 66, 100, 128, 512, 513)


@pytest.mark.parametrize("with_kv_len", [False, True], ids=["no_kv_len", "kv_len"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("window", WALK_WINDOWS, ids=lambda w: f"window{w}")
@pytest.mark.parametrize("s", WALK_S, ids=lambda s: f"s{s}")
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_tile_walk_covers_visible_pairs_and_interior_is_visible(
        kernel, s, window, causal, with_kv_len):
    kv_len = max(1, s - 37) if with_kv_len else None
    vis = _visible(s, causal, window, kv_len)
    walks = {"fwd": lambda: [_fwd_walk(s, causal, window, kv_len, rows) for rows in (64, 128)],
             "dq": lambda: [_fwd_walk(s, causal, window, kv_len, BLOCK)],
             "dkv": lambda: [_dkv_walk(s, causal, window, kv_len)]}[kernel]()
    for walked, interior in walks:
        assert not (vis & ~walked).any(), "a visible pair lies outside the walked tiles"
        assert not (interior & ~vis).any(), "an interior tile holds a masked pair"
        assert not (interior & ~walked).any()


def test_window512_masks_two_tiles_per_warp():
    """At the serving prefill's mask a 64-row block walks 9 key tiles and
    each of its warps masks 2 of them (the first and the diagonal one);
    a dk/dv warp selects in 2 of its block's 9 query tiles."""
    s, window = 2048, 512
    for q0 in range(window, s, BLOCK):
        j_begin, j_end = _key_tiles(q0, BLOCK, s, True, window, None)
        assert j_end - j_begin == 9
        for r0 in range(q0, q0 + BLOCK, WARP):
            fs, fe = _interior_tiles(r0, WARP, j_begin, j_end, True, window, None)
            assert (fs - j_begin) + (j_end - fe) == 2
    for k0 in range(0, s - window - BLOCK, BLOCK):
        i_begin, i_end = _query_tiles(k0, s, s, True, window)
        assert i_end - i_begin == 9
        for c0 in range(k0, k0 + BLOCK, WARP):
            fs, fe = _interior_query_tiles(c0, WARP, i_begin, i_end, s, True, window)
            assert (fs - i_begin) + (i_end - fe) == 2


# ---------------------------------------------------------------------------
# The rounding points
# ---------------------------------------------------------------------------

# (B, H, S, D, causal, window): S and D as the caller gives them
# (flash_attention pads S to 64 and D to 64; a non-causal padded S gets the
# kv_len bound). The new chip_smoke case (window 100, not a multiple of the
# tile), the dense causal mask at D = 128, the padded non-causal tail with
# a padded D, and the narrowest window.
CASES = {
    "s1024_d64_causal_window100": (1, 2, 1024, 64, True, 100),
    "s192_d64_causal_window65": (2, 2, 192, 64, True, 65),
    "s256_d128_causal": (1, 2, 256, 128, True, None),
    "s200_d48_noncausal_kv_len": (2, 2, 200, 48, False, None),
    "s128_d64_window1": (1, 2, 128, 64, True, 1),
}


def _inputs(case, seed):
    """bf16 q, k, v, do as the caller gives them; the same padded as
    flash_attention pads them; kv_len and the scale."""
    b, h, s, d, causal, window = CASES[case]
    rng = np.random.RandomState(seed)
    raw = [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)).to(torch.bfloat16)
           for _ in range(4)]
    s_pad, d_pad = -(-s // BLOCK) * BLOCK, max(-(-d // 64) * 64, 64)
    padded = [torch.nn.functional.pad(t, (0, d_pad - d, 0, s_pad - s)) for t in raw]
    kv_len = s if (not causal and s_pad != s) else None
    return raw, padded, kv_len, d ** -0.5


def _mask(s, causal, window, kv_len):
    return torch.from_numpy(_visible(s, causal, window, kv_len))


def _tile_forward(q, k, v, scale, window, causal, kv_len):
    """The bf16 forward route in plain torch: o bf16, lse (B, H, S, 1)."""
    b, h, s, d = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    vis = _mask(s, causal, window, kv_len)
    walk = torch.zeros(s, s // BLOCK, dtype=torch.bool)  # row -> tiles its block walks
    for q0 in range(0, s, BLOCK):
        j_begin, j_end = _key_tiles(q0, BLOCK, s, causal, window, kv_len)
        walk[q0:q0 + BLOCK, j_begin:j_end] = True
    m = torch.full((b, h, s, 1), MASK)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    for j in range(s // BLOCK):
        cols = slice(j * BLOCK, (j + 1) * BLOCK)
        x = (qf @ kf[:, :, cols].transpose(-1, -2)) * (scale * LOG2E)
        x = x.masked_fill(~vis[:, cols], MASK)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        on = walk[:, j][:, None]
        l = torch.where(on, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(on, acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, cols], acc)
        m = torch.where(on, m_new, m)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(m > MASK * 0.5, m * LN2, m) + torch.log(l_safe)
    return (acc * (1.0 / l_safe)).to(torch.bfloat16), lse


def _fwd_magnitude(q, k, v, scale, window, causal, kv_len):
    """Softmax weights of the visible keys times |v| (fp32)."""
    x = (q.float() @ k.float().transpose(-1, -2)) * scale
    x = x.masked_fill(~_mask(q.shape[2], causal, window, kv_len), MASK)
    return torch.softmax(x, dim=-1) @ v.float().abs()


def _assert_within_bar(got, want, plain, mag):
    """|got - want| <= atol + rtol (|plain| + mag) per element."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / (ATOL + RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"worst |Δ| / (atol + rtol (|plain| + mag)) = {worst:.3f}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_plain_fp32(case):
    _, (q, k, v, _), kv_len, scale = _inputs(case, seed=0)
    _, _, _, _, causal, window = CASES[case]
    o, lse = _tile_forward(q, k, v, scale, window, causal, kv_len)
    o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(), scale, window,
                                            causal, kv_len)
    _assert_within_bar(o, o_ref, o_ref, _fwd_magnitude(q, k, v, scale, window, causal, kv_len))
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_jax_kernel_bf16(case):
    """The same bf16 values through the JAX package's flash_attention in
    interpret mode (its own padding and blocks)."""
    (q, k, v, _), padded, kv_len, scale = _inputs(case, seed=1)
    _, _, s, d, causal, window = CASES[case]
    want = jfa.flash_attention(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                 for t in (q, k, v)),
                               causal=causal, window_size=window, scale=scale, impl="interpret")
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    o, _ = _tile_forward(*padded[:3], scale, window, causal, kv_len)
    o_ref, _ = fa.flash_fwd_reference(*(t.float() for t in padded[:3]), scale, window, causal,
                                      kv_len)
    mag = _fwd_magnitude(*padded[:3], scale, window, causal, kv_len)
    assert want.shape == (q.shape[0], q.shape[1], s, d)
    _assert_within_bar(o[:, :, :s, :d], want, o_ref[:, :, :s, :d], mag[:, :, :s, :d])


def _tile_dkv(q, k, v, do, lse, delta, scale, window, causal, kv_len, chunk=32):
    """The bf16 dk/dv route in plain torch: (dk, dv) bf16."""
    b, h, s, d = q.shape
    keys = s if kv_len is None else min(kv_len, s)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    vis = _mask(s, causal, window, kv_len)
    dk = torch.zeros(b, h, s, d)
    dv = torch.zeros(b, h, s, d)
    for k0 in range(0, s, BLOCK):
        kc = slice(k0, k0 + BLOCK)
        i_begin, i_end = _query_tiles(k0, s, keys, causal, window)
        for it in range(i_begin, i_end):
            for c0 in range(it * BLOCK, (it + 1) * BLOCK, chunk):
                qc = slice(c0, c0 + chunk)
                st = kf[:, :, kc] @ qf[:, :, qc].transpose(-1, -2)  # s^T: keys x queries
                lq = lse[:, :, qc, 0][:, :, None, :] * LOG2E
                p = torch.exp2(st * (scale * LOG2E) - lq)
                p = torch.where(vis[qc, kc].T, p, torch.zeros(()))
                dp = vf[:, :, kc] @ dof[:, :, qc].transpose(-1, -2)
                ds = p * (dp - delta[:, :, qc, 0][:, :, None, :]) * scale
                dv[:, :, kc] += p.to(torch.bfloat16).float() @ dof[:, :, qc]
                dk[:, :, kc] += ds.to(torch.bfloat16).float() @ qf[:, :, qc]
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _bwd_inputs(case, seed):
    """Padded bf16 q, k, v, do; the forward's o (bf16) and lse from the
    plain version; delta; kv_len and the scale."""
    _, (q, k, v, do), kv_len, scale = _inputs(case, seed)
    _, _, s, d, causal, window = CASES[case]
    do = do.clone()
    do[:, :, s:] = 0  # the padded rows get no gradient
    o, lse = fa.flash_fwd_reference(q, k, v, scale, window, causal, kv_len)
    return q, k, v, do, o, lse, fa._delta(o, do, None), kv_len, scale


def _bwd_magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """|ds| |k|, |ds|^T |q| and p^T |do| (fp32), from the plain version's p
    and ds."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    p = torch.where(_mask(q.shape[2], causal, window, kv_len), p, torch.zeros(()))
    ds = (p * (do @ v.transpose(-1, -2) - delta) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), p.transpose(-1, -2) @ do.abs()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_dkv_matches_plain_fp32(case):
    q, k, v, do, o, lse, delta, kv_len, scale = _bwd_inputs(case, seed=2)
    _, _, _, _, causal, window = CASES[case]
    got = _tile_dkv(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    want = fa.flash_bwd_dkv_reference(*(t.float() for t in (q, k, v, do)), lse, delta, scale,
                                      window, causal, kv_len)
    mags = _bwd_magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len)[1:]
    for g, w, m in zip(got, want, mags):
        _assert_within_bar(g, w, w, m)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_dkv_matches_jax_kernel_bf16(case):
    """The same bf16 q, k, v, o, lse and do through the JAX package's
    backward kernels in interpret mode (``_bwd_pallas``, 64-row blocks),
    which compute delta from o and do as the wrapper does."""
    q, k, v, do, o, lse, delta, kv_len, scale = _bwd_inputs(case, seed=3)
    _, _, _, _, causal, window = CASES[case]
    bf = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, o)]
    _, jdk, jdv = jfa._bwd_pallas(*bf, jnp.asarray(lse.numpy()),
                                  jnp.asarray(do.float().numpy()).astype(jnp.bfloat16),
                                  scale, window, causal, BLOCK, BLOCK, True, kv_len)
    want = [torch.from_numpy(np.array(t.astype(jnp.float32))) for t in (jdk, jdv)]
    got = _tile_dkv(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    plain = fa.flash_bwd_dkv_reference(*(t.float() for t in (q, k, v, do)), lse, delta, scale,
                                       window, causal, kv_len)
    mags = _bwd_magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len)[1:]
    for g, w, p, m in zip(got, want, plain, mags):
        _assert_within_bar(g, w, p, m)


def _tile_dq(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """The bf16 dq route in plain torch: dq bf16."""
    b, h, s, d = q.shape
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    vis = _mask(s, causal, window, kv_len)
    dq = torch.zeros(b, h, s, d)
    for q0 in range(0, s, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        lq = lse[:, :, rows] * LOG2E
        j_begin, j_end = _key_tiles(q0, BLOCK, s, causal, window, kv_len)
        for j in range(j_begin, j_end):
            cols = slice(j * BLOCK, (j + 1) * BLOCK)
            x = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            p = torch.exp2(x * (scale * LOG2E) - lq)
            p = torch.where(vis[rows, cols], p, torch.zeros(()))
            dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows]) * scale
            dq[:, :, rows] += ds.to(torch.bfloat16).float() @ kf[:, :, cols]
    return dq.to(torch.bfloat16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_dq_matches_plain_fp32(case):
    q, k, v, do, o, lse, delta, kv_len, scale = _bwd_inputs(case, seed=4)
    _, _, _, _, causal, window = CASES[case]
    got = _tile_dq(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    want = fa.flash_bwd_dq_reference(*(t.float() for t in (q, k, v, do)), lse, delta, scale,
                                     window, causal, kv_len)
    mag = _bwd_magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len)[0]
    _assert_within_bar(got, want, want, mag)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_dq_matches_jax_kernel_bf16(case):
    """The same bf16 q, k, v, o, lse and do through the JAX package's
    backward kernels in interpret mode (``_bwd_pallas``): its dq."""
    q, k, v, do, o, lse, delta, kv_len, scale = _bwd_inputs(case, seed=5)
    _, _, _, _, causal, window = CASES[case]
    bf = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v, o)]
    jdq, _, _ = jfa._bwd_pallas(*bf, jnp.asarray(lse.numpy()),
                                jnp.asarray(do.float().numpy()).astype(jnp.bfloat16),
                                scale, window, causal, BLOCK, BLOCK, True, kv_len)
    want = torch.from_numpy(np.array(jdq.astype(jnp.float32)))
    got = _tile_dq(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    plain = fa.flash_bwd_dq_reference(*(t.float() for t in (q, k, v, do)), lse, delta, scale,
                                      window, causal, kv_len)
    mag = _bwd_magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len)[0]
    _assert_within_bar(got, want, plain, mag)
