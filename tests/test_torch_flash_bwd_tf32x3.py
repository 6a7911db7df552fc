"""The arithmetic of the fp32 route of ``csrc/flash_bwd.cu`` (its dq and
dk/dv kernels): every product three TF32 passes on the tensor cores, held
to the bar that chip_smoke.py holds the kernels to on the card.

Each fp32 operand is split as x = hi + lo (``split_tf32`` of
``csrc/mma.cuh``; ``_split`` of tests/test_torch_flash_mha_tf32x3.py), and
a product a b is taken as tf32(lo_a) hi_b + hi_a tf32(lo_b) + hi_a hi_b in
fp32 (``_mm3``). The emulation walks the kernels' tiles:

  * ``_tf32x3_dq``: per block of 64 query rows, the 64-key tiles of
    ``key_tiles`` (common.cuh) in order, each in pieces of 32 keys (16 at
    D = 128); s = q k^T and dp = do v^T in three passes, p = 2^(s scale
    log2(e) - lse log2(e)) selected to 0 where masked on a warp's edge
    tiles (``interior_tiles``, per 16 rows), ds = p (dp - delta) scale,
    split as it stands, and dq += ds k;
  * ``_tf32x3_dkv``: per block of 64 keys, the 64-query tiles of
    ``query_tiles`` (flash_bwd.cu) in order, each in pieces of 16 queries;
    s^T = k q^T and dp^T = v do^T, p^T selected on a warp's edge tiles
    (``interior_query_tiles``, per 16 keys), ds^T = p^T (dp^T - delta)
    scale, dv += p^T do with p unrounded, dk += ds^T q.

Each step's update is a product of its own, added to the running sum in
fp32 (the kernels sum a step apart from the running sum and add it on the
CUDA cores). The walks themselves are the ones
tests/test_torch_flash_tiles.py holds to the mask. lse comes from the
port's plain forward and delta = rowsum(do o) - dlse from the wrapper's
``_delta``, as the kernels get them on the card.
The emulation is held against the port's plain versions
(``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``) in fp32 and
against ``jax.grad`` of the JAX package's ``flash_attention(impl=
"interpret")`` (the resident ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``, and
the streaming ``_bwd_dq_stream_kernel`` / ``_bwd_dkv_stream_kernel`` with
the threshold lowered), at phase 3's fp32 bar ``TOL_BWD["float32"]``:
|Δ| <= 1e-4 + 1e-5 (|plain| + mag) per element, mag the sum of the
absolute terms the element adds up.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from forde_tpu.ops import flash_attention as jfa
from forde_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_mha_tf32x3 import _split, _tf32
from tests.test_torch_flash_tiles import (
    _interior_query_tiles,
    _interior_tiles,
    _key_tiles,
    _query_tiles,
    _visible,
)

torch.set_num_threads(1)

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
LOG2E = 1.4426950408889634
ATOL, RTOL = 1e-4, 1e-5  # chip_smoke's TOL_BWD["float32"]
BLOCK = 64  # query rows of a dq block, keys of a dk/dv block, and their tiles
WARP = 16  # query rows (dq) or keys (dk/dv) per warp
DKV_QUERIES = 16  # queries per step of the dk/dv kernel


def dq_keys(d):
    """Keys per step of the dq kernel."""
    return 16 if d == 128 else 32


# (B, H, S, D, causal, window, dlse): S and D as the caller gives them
# (flash_attention pads S to 64 and D to 64; a non-causal padded S gets the
# kv_len bound). A window on the causal mask, the plain causal mask, the
# non-causal padded tail (kv_len), a padded D, D = 128, a window that is
# not a multiple of the tile, and an lse cotangent.
CASES = {
    "s512_d64_causal_window128": (1, 2, 512, 64, True, 128, False),
    "s384_d64_causal": (1, 2, 384, 64, True, None, False),
    "s600_d64_noncausal_kv_len": (1, 2, 600, 64, False, None, False),
    "s576_d48_causal": (1, 2, 576, 48, True, None, False),
    "s512_d128_causal_window128": (1, 2, 512, 128, True, 128, False),
    "s512_d64_causal_window100": (1, 2, 512, 64, True, 100, False),
    "s512_d64_causal_window128_dlse": (1, 2, 512, 64, True, 128, True),
}
JAX_BLOCK = 128  # the JAX kernels' blocks: several per row, edge and interior loops


def _inputs(case, seed):
    """fp32 q, k, v, do as the caller gives them; the same padded as
    flash_attention pads them (do zero on the padded rows); kv_len, the
    scale and the lse cotangent (padded rows 0)."""
    b, h, s, d, causal, window, with_dlse = CASES[case]
    rng = np.random.RandomState(seed)
    raw = [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)) for _ in range(4)]
    dlse = torch.from_numpy(rng.randn(b, h, s, 1).astype(np.float32)) if with_dlse else None
    s_pad, d_pad = -(-s // BLOCK) * BLOCK, max(-(-d // 64) * 64, 64)
    padded = [F.pad(t, (0, d_pad - d, 0, s_pad - s)) for t in raw]
    kv_len = s if (not causal and s_pad != s) else None
    dlse_pad = None if dlse is None else F.pad(dlse, (0, 0, 0, s_pad - s))
    return raw, padded, kv_len, d ** -0.5, dlse, dlse_pad


def _mm3(a, b):
    """a @ b in three TF32 passes, summed in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return _tf32(al) @ bh + ah @ _tf32(bl) + ah @ bh


def _edge_rows(r0, rows, j_begin, j_end, tile, interior):
    """(rows, 1) bool: True for the rows of a warp for which key tile
    ``tile`` is an edge tile (needs the select)."""
    edge = torch.zeros(rows, 1, dtype=torch.bool)
    for w0 in range(0, rows, WARP):
        fs, fe = interior(r0 + w0, WARP, j_begin, j_end)
        edge[w0:w0 + WARP] = tile < fs or tile >= fe
    return edge


def _tf32x3_dq(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """The dq kernel's arithmetic on padded fp32 inputs: dq (B, H, S, D)."""
    b, h, s, d = q.shape
    vis = torch.from_numpy(_visible(s, causal, window, kv_len))
    kt = dq_keys(d)
    dq = torch.zeros(b, h, s, d)
    for q0 in range(0, s, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        lq = lse[:, :, rows] * LOG2E
        j_begin, j_end = _key_tiles(q0, BLOCK, s, causal, window, kv_len)
        acc = torch.zeros(b, h, BLOCK, d)
        for k0 in range(j_begin * BLOCK, j_end * BLOCK, kt):
            cols = slice(k0, k0 + kt)
            edge = _edge_rows(q0, BLOCK, j_begin, j_end, k0 // BLOCK, lambda r0, n, jb, je:
                              _interior_tiles(r0, n, jb, je, causal, window, kv_len))
            x = _mm3(q[:, :, rows], k[:, :, cols].transpose(-1, -2))
            dp = _mm3(do[:, :, rows], v[:, :, cols].transpose(-1, -2))
            p = torch.exp2(x * (scale * LOG2E) - lq)
            p = torch.where(edge & ~vis[rows, cols], torch.zeros(()), p)
            ds = p * (dp - delta[:, :, rows]) * scale
            acc = acc + _mm3(ds, k[:, :, cols])
        dq[:, :, rows] = acc
    return dq


def _tf32x3_dkv(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """The dk/dv kernel's arithmetic on padded fp32 inputs: (dk, dv)."""
    b, h, s, d = q.shape
    vis_t = torch.from_numpy(_visible(s, causal, window, kv_len)).T  # keys x queries
    keys = s if kv_len is None else min(kv_len, s)
    dk = torch.zeros(b, h, s, d)
    dv = torch.zeros(b, h, s, d)
    lse_t = (lse * LOG2E).transpose(-1, -2)
    delta_t = delta.transpose(-1, -2)
    for k0 in range(0, s, BLOCK):
        kr = slice(k0, k0 + BLOCK)
        i_begin, i_end = _query_tiles(k0, s, keys, causal, window)
        acc_k = torch.zeros(b, h, BLOCK, d)
        acc_v = torch.zeros(b, h, BLOCK, d)
        for q0 in range(i_begin * BLOCK, i_end * BLOCK, DKV_QUERIES):
            cols = slice(q0, q0 + DKV_QUERIES)
            edge = _edge_rows(k0, BLOCK, i_begin, i_end, q0 // BLOCK, lambda c0, n, ib, ie:
                              _interior_query_tiles(c0, n, ib, ie, keys, causal, window))
            xt = _mm3(k[:, :, kr], q[:, :, cols].transpose(-1, -2))
            dpt = _mm3(v[:, :, kr], do[:, :, cols].transpose(-1, -2))
            pt = torch.exp2(xt * (scale * LOG2E) - lse_t[..., cols])
            pt = torch.where(edge & ~vis_t[kr, cols], torch.zeros(()), pt)
            dst = pt * (dpt - delta_t[..., cols]) * scale
            acc_v = acc_v + _mm3(pt, do[:, :, cols])
            acc_k = acc_k + _mm3(dst, q[:, :, cols])
        dk[:, :, kr] = acc_k
        dv[:, :, kr] = acc_v
    return dk, dv


def _backward(q, k, v, do, scale, window, causal, kv_len, dlse=None):
    """The forward's lse (plain version), delta as the wrapper computes it,
    the emulated (dq, dk, dv), the plain (dq, dk, dv) and the magnitudes."""
    o, lse = fa.flash_fwd_reference(q, k, v, scale, window, causal, kv_len)
    delta = fa._delta(o, do, dlse)
    args = (q, k, v, do, lse, delta, scale, window, causal, kv_len)
    got = (_tf32x3_dq(*args), *_tf32x3_dkv(*args))
    plain = (fa.flash_bwd_dq_reference(*args), *fa.flash_bwd_dkv_reference(*args))
    return got, plain, _magnitudes(*args)


def _magnitudes(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """|ds| |k|, |ds|^T |q| and p^T |do| (fp32), from the plain version's p
    and ds (chip_smoke's flash_bwd_magnitudes)."""
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    p = torch.where(torch.from_numpy(_visible(q.shape[2], causal, window, kv_len)), p,
                    torch.zeros(()))
    ds = (p * (do @ v.transpose(-1, -2) - delta) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), p.transpose(-1, -2) @ do.abs()


def _assert_within_bar(got, want, plain, mag, what):
    assert torch.isfinite(got).all(), what
    worst = ((got - want).abs() / (ATOL + RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"{what}: worst |Δ| / (1e-4 + 1e-5 (|plain| + mag)) = {worst:.3f}"


def _jax_grads(raw, causal, window, dlse):
    """jax.grad of the JAX package's flash_attention (interpret mode) on the
    unpadded fp32 inputs; with an lse cotangent, the vjp of
    flash_attention_with_lse."""
    q, k, v, do = (jnp.asarray(t.numpy()) for t in raw)
    kw = dict(causal=causal, window_size=window, impl="interpret", block_q=JAX_BLOCK,
              block_k=JAX_BLOCK)
    if dlse is None:
        def f(q, k, v):
            return jnp.sum(jfa.flash_attention(q, k, v, **kw) * do)

        want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    else:
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(q, k, v, **kw), q, k, v)
        want = vjp((do, jnp.asarray(dlse.numpy())))
    return [torch.from_numpy(np.array(w)) for w in want]


def test_tiles_are_the_kernels():
    """The emulation walks the tiles the CUDA source uses."""
    src = (CSRC / "flash_bwd.cu").read_text()
    m = re.search(r"constexpr int tf32_dq_keys\(\) \{\s*return D == 128 \? (\d+) : (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (dq_keys(128), dq_keys(64))
    assert re.search(rf"constexpr int TF32_DKV_QUERIES = {DKV_QUERIES};", src)
    assert re.search(rf"constexpr int BQ = {BLOCK};", src)
    assert re.search(r"constexpr int TC_THREADS = (\d+);", src)[1] == str(32 * BLOCK // WARP)
    common = (CSRC / "common.cuh").read_text()
    assert re.search(rf"constexpr int FLASH_BK = {BLOCK};", common)
    # No CUDA-core fp32 kernel is left: both fp32 entry points launch the
    # TF32 kernels.
    for name in ("dq", "dkv"):
        for d in (64, 128):
            assert f"if (dtype == 0 && head_dim == {d}) return launch_{name}_tf32<{d}>" in src
    assert "__launch_bounds__(THREADS" not in src


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_plain_fp32(case):
    _, _, s, d, causal, window, _ = CASES[case]
    _, (q, k, v, do), kv_len, scale, _, dlse = _inputs(case, seed=5)
    do[:, :, s:] = 0  # the padded rows get no gradient
    got, plain, mags = _backward(q, k, v, do, scale, window, causal, kv_len, dlse)
    for name, g, p, m in zip(("dq", "dk", "dv"), got, plain, mags):
        _assert_within_bar(g, p, p, m, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_jax_grad_fp32(case):
    _, _, s, d, causal, window, _ = CASES[case]
    raw, (q, k, v, do), kv_len, scale, dlse, dlse_pad = _inputs(case, seed=6)
    do[:, :, s:] = 0
    want = _jax_grads(raw, causal, window, dlse)
    got, plain, mags = _backward(q, k, v, do, scale, window, causal, kv_len, dlse_pad)
    for name, g, w, p, m in zip(("dq", "dk", "dv"), got, want, plain, mags):
        cut = (slice(None), slice(None), slice(0, s), slice(0, d))
        assert w.shape == g[cut].shape, name
        _assert_within_bar(g[cut], w, p[cut], m[cut], name)


@pytest.mark.parametrize("window", [128, None])
def test_tf32x3_backward_matches_jax_stream_kernels(monkeypatch, window):
    """S past the (lowered) threshold: the JAX package runs its streaming
    backward kernels; the one pair of CUDA kernels serves it with the same
    walks."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 256)
    rng = np.random.RandomState(7)
    raw = [torch.from_numpy(rng.randn(1, 2, 512, 64).astype(np.float32)) for _ in range(4)]
    want = _jax_grads(raw, True, window, None)
    got, plain, mags = _backward(*raw, 0.125, window, True, None)
    for name, g, w, p, m in zip(("dq", "dk", "dv"), got, want, plain, mags):
        _assert_within_bar(g, w, p, m, name)


def test_row_with_no_visible_key():
    """Non-causal with a window and a key bound: rows q >= kv_len + window
    - 1 see no key (their lse is -1e30, so p would be inf), and p is
    selected to 0 there, never multiplied by 0: their dq is exactly 0, no
    value is NaN, and the emulation agrees with the plain version and with
    the JAX package's backward kernels (``_bwd_pallas`` in interpret mode)
    on the same q, k, v, o, lse and do."""
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
                   for _ in range(4))
    window, kv_len, scale = 32, 100, 0.125
    o, lse = fa.flash_fwd_reference(q, k, v, scale, window, False, kv_len)
    blind = torch.arange(256) >= kv_len + window - 1
    assert (lse[0, 0, blind] < -1e29).all() and not (lse[0, 0, ~blind] < -1e29).any()
    got, plain, mags = _backward(q, k, v, do, scale, window, False, kv_len)
    assert got[0][:, :, blind].abs().max() == 0
    jq = [jnp.asarray(t.numpy()) for t in (q, k, v, o, lse, do)]
    want = jfa._bwd_pallas(*jq[:5], jq[5], scale, window, False, BLOCK, BLOCK, True, kv_len)
    for name, g, w, p, m in zip(("dq", "dk", "dv"), got, want, plain, mags):
        _assert_within_bar(g, p, p, m, f"{name} against the plain version")
        _assert_within_bar(g, torch.from_numpy(np.array(w)), p, m, f"{name} against JAX")
