"""The arithmetic of the fp32 route of ``csrc/flash_fwd.cu``
(``flash_fwd_tf32_tc_kernel``): every product three TF32 passes on the
tensor cores, held to the bars that chip_smoke.py holds the kernel to on
the card.

Each fp32 operand is split as x = hi + lo (``split_tf32`` of
``csrc/mma.cuh``; ``_split`` of tests/test_torch_flash_mha_tf32x3.py), and
a product a b is taken as tf32(lo_a) hi_b + hi_a tf32(lo_b) + hi_a hi_b in
fp32 (``_mm3``). ``_tf32x3_forward`` walks the kernel's tiles: per block of
64 query rows, the 64-key tiles of ``key_tiles`` (common.cuh) in order,
each in pieces of ``TF32_KEYS`` keys; s = q k^T in three passes, in log2
units, masked to -1e30 on a warp's edge tiles only (``interior_tiles``, per
16 rows), the running max starting at -1e30, p = 2^(s - m) summed into l
unrounded and split as it stands for p v; each piece's p v is a product of
its own, added to the rescaled running o in fp32 (the kernel sums it apart
from o and adds it on the CUDA cores); o = acc (1 / l), lse = m ln 2 +
log l on a row that saw a key and m + log l on one that did not.
The walks themselves are the ones tests/test_torch_flash_tiles.py holds to
the mask.

The emulation is held against the port's plain version
(``flash_fwd_reference``) in fp32 and against the JAX package's
``flash_attention(impl="interpret")`` (the resident ``_fwd_kernel``, and the
streaming ``_fwd_stream_kernel`` with the threshold lowered), at phase 10's
fp32 bars: o per element within 1e-4 + 1e-5 (|plain| + mag), mag the
softmax weights times |v| (``TOL_ATTN["float32"]``), and lse within 1e-4
(``TOL_LSE``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from forde_tpu.ops import flash_attention as jfa
from forde_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_bwd_tf32x3 import _assert_within_bar, _edge_rows
from tests.test_torch_flash_mha_tf32x3 import _mm3
from tests.test_torch_flash_tiles import _fwd_magnitude, _interior_tiles, _key_tiles, _visible

torch.set_num_threads(1)

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
MASK = -1e30
LSE_TOL = 1e-4  # chip_smoke's TOL_LSE; o's bar is TOL_ATTN["float32"] (_assert_within_bar)
BLOCK = 64  # query rows of a block, and keys of a tile
WARP = 16  # query rows per warp
KEYS = 32  # keys per step: a piece of a 64-key tile


# (B, H, S, D, causal, window): S and D as the caller gives them
# (flash_attention pads S to 64 and D to 64; a non-causal padded S gets the
# kv_len bound). A window on the causal mask, the plain causal mask, the
# non-causal padded tail (kv_len), a padded D, D = 128, a window that is not
# a multiple of the tile, and padded rows that see no key (non-causal,
# window 16, kv_len 100 of 128: rows 115-127).
CASES = {
    "s512_d64_causal_window128": (1, 2, 512, 64, True, 128),
    "s384_d64_causal": (1, 2, 384, 64, True, None),
    "s600_d64_noncausal_kv_len": (1, 2, 600, 64, False, None),
    "s576_d48_causal": (1, 2, 576, 48, True, None),
    "s512_d128_causal_window128": (1, 2, 512, 128, True, 128),
    "s512_d64_causal_window100": (1, 2, 512, 64, True, 100),
    "s100_d64_noncausal_window16_blind_rows": (2, 2, 100, 64, False, 16),
}
JAX_BLOCK = 128  # the JAX kernels' blocks: several per row, edge and interior loops


def _inputs(case, seed):
    """fp32 q, k, v as the caller gives them; the same padded as
    flash_attention pads them; kv_len and the scale."""
    b, h, s, d, causal, _ = CASES[case]
    rng = np.random.RandomState(seed)
    raw = [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)) for _ in range(3)]
    s_pad, d_pad = -(-s // BLOCK) * BLOCK, max(-(-d // 64) * 64, 64)
    padded = [F.pad(t, (0, d_pad - d, 0, s_pad - s)) for t in raw]
    kv_len = s if (not causal and s_pad != s) else None
    return raw, padded, kv_len, d ** -0.5


def _tf32x3_forward(q, k, v, scale, window, causal, kv_len):
    """The fp32 kernel's arithmetic on padded fp32 inputs: o (B, H, S, D),
    lse (B, H, S, 1)."""
    b, h, s, d = q.shape
    vis = torch.from_numpy(_visible(s, causal, window, kv_len))
    o = torch.zeros(b, h, s, d)
    lse = torch.zeros(b, h, s, 1)
    for q0 in range(0, s, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        j_begin, j_end = _key_tiles(q0, BLOCK, s, causal, window, kv_len)
        m = torch.full((b, h, BLOCK, 1), MASK)
        l = torch.zeros(b, h, BLOCK, 1)
        acc = torch.zeros(b, h, BLOCK, d)
        for k0 in range(j_begin * BLOCK, j_end * BLOCK, KEYS):
            cols = slice(k0, k0 + KEYS)
            edge = _edge_rows(q0, BLOCK, j_begin, j_end, k0 // BLOCK, lambda r0, n, jb, je:
                              _interior_tiles(r0, n, jb, je, causal, window, kv_len))
            x = _mm3(q[:, :, rows], k[:, :, cols].transpose(-1, -2)) * (scale * LOG2E)
            x = torch.where(edge & ~vis[rows, cols], torch.tensor(MASK), x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mm3(p, v[:, :, cols])
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, :, rows] = acc * (1.0 / l_safe)
        lse[:, :, rows] = torch.where(m > MASK * 0.5, m * LN2, m) + torch.log(l_safe)
    return o, lse


def _jax_forward(raw, scale, causal, window):
    """The JAX package's flash_attention in interpret mode on the unpadded
    fp32 inputs (its own padding and blocks)."""
    out = jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in raw), causal=causal,
                              window_size=window, scale=scale, impl="interpret",
                              block_q=JAX_BLOCK, block_k=JAX_BLOCK)
    return torch.from_numpy(np.array(out))


def test_tiles_are_the_kernels():
    """The emulation walks the tiles the CUDA source uses, and no CUDA-core
    fp32 kernel is left: both fp32 entry points launch the TF32 kernel,
    which sums each piece's p v apart (the one copy of mma_step_tf32x3 in
    mma.cuh, shared with flash_bwd.cu)."""
    src = (CSRC / "flash_fwd.cu").read_text()
    assert re.search(rf"constexpr int TF32_KEYS = {KEYS};", src)
    assert re.search(rf"constexpr int BQ = {BLOCK};", src)
    assert re.search(r"constexpr int TC_THREADS = (\d+);", src)[1] == str(32 * BLOCK // WARP)
    common = (CSRC / "common.cuh").read_text()
    assert re.search(rf"constexpr int FLASH_BK = {BLOCK};", common)
    for d in (64, 128):
        assert re.search(rf"if \(dtype == 0 && head_dim == {d}\)\s*return launch_tf32<{d}>", src)
    assert "flash_fwd_kernel" not in src and "__launch_bounds__(THREADS" not in src
    assert "mma_step_tf32x3<D, NJ>(acc, ph, pl, v_t, lane)" in src
    # Both routes start the running max at the -1e30 sentinel, not -inf.
    assert src.count("float m0 = MASK_VALUE, m1 = MASK_VALUE;") == 2
    mma = (CSRC / "mma.cuh").read_text()
    assert mma.count("void mma_step_tf32x3(") == 1
    assert "void mma_step_tf32x3(" not in (CSRC / "flash_bwd.cu").read_text()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_forward_matches_plain_fp32(case):
    _, (q, k, v), kv_len, scale = _inputs(case, seed=0)
    _, _, _, _, causal, window = CASES[case]
    o, lse = _tf32x3_forward(q, k, v, scale, window, causal, kv_len)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, window, causal, kv_len)
    _assert_within_bar(o, o_ref, o_ref, _fwd_magnitude(q, k, v, scale, window, causal, kv_len), "o")
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_forward_matches_jax_kernel_fp32(case):
    """The same fp32 values through the JAX package's resident kernel."""
    raw, padded, kv_len, scale = _inputs(case, seed=1)
    _, _, s, d, causal, window = CASES[case]
    want = _jax_forward(raw, scale, causal, window)
    o, _ = _tf32x3_forward(*padded, scale, window, causal, kv_len)
    o_ref, _ = fa.flash_fwd_reference(*padded, scale, window, causal, kv_len)
    mag = _fwd_magnitude(*padded, scale, window, causal, kv_len)
    cut = (slice(None), slice(None), slice(0, s), slice(0, d))
    assert want.shape == o[cut].shape
    _assert_within_bar(o[cut], want, o_ref[cut], mag[cut], "o")


@pytest.mark.parametrize("window", [128, None])
def test_tf32x3_forward_matches_jax_stream_kernel(monkeypatch, window):
    """S past the (lowered) threshold: the JAX package runs its streaming
    kernel; the one CUDA kernel serves it with the same walk."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 256)
    rng = np.random.RandomState(2)
    raw = [torch.from_numpy(rng.randn(1, 2, 512, 64).astype(np.float32)) for _ in range(3)]
    want = _jax_forward(raw, 0.125, True, window)
    o, lse = _tf32x3_forward(*raw, 0.125, window, True, None)
    o_ref, lse_ref = fa.flash_fwd_reference(*raw, 0.125, window, True, None)
    _assert_within_bar(o, want, o_ref, _fwd_magnitude(*raw, 0.125, window, True, None), "o")
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=0.0)


def test_row_with_no_visible_key():
    """Non-causal with window 16 and kv_len 100 of 128 padded keys: rows q >=
    kv_len + window - 1 = 115 see no key. Their scores are all -1e30, as is
    their running max, so each walked key weighs 2^0 = 1: o is the mean of
    the walked v and lse = -1e30 + log l. Both of the blocks walk every key
    tile, so that is the plain version's mean of all v, and the JAX
    package's resident kernel with 64-row blocks (``_fwd_pallas`` in
    interpret mode on the same padded inputs) walks the same tiles."""
    _, (q, k, v), kv_len, scale = _inputs("s100_d64_noncausal_window16_blind_rows", seed=3)
    window = 16
    o, lse = _tf32x3_forward(q, k, v, scale, window, False, kv_len)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, window, False, kv_len)
    blind = torch.arange(128) >= kv_len + window - 1
    assert (lse[:, :, blind] < -1e29).all() and not (lse[:, :, ~blind] < -1e29).any()
    assert (lse_ref[:, :, blind] < -1e29).all()
    mean_v = v.mean(dim=2, keepdim=True).expand_as(v)
    mag = _fwd_magnitude(q, k, v, scale, window, False, kv_len)
    _assert_within_bar(o[:, :, blind], mean_v[:, :, blind], mean_v[:, :, blind],
                       mag[:, :, blind], "blind rows against the mean of v")
    _assert_within_bar(o, o_ref, o_ref, mag, "o against the plain version")
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL, rtol=0.0)
    jo, jlse = jfa._fwd_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v)), scale, window,
                               False, BLOCK, BLOCK, True, kv_len)
    _assert_within_bar(o, torch.from_numpy(np.array(jo)), o_ref, mag, "o against JAX")
    torch.testing.assert_close(lse, torch.from_numpy(np.array(jlse)), atol=LSE_TOL, rtol=0.0)

