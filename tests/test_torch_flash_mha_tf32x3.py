"""The arithmetic of the fp32 route of ``csrc/flash_mha_fwd.cu`` and
``csrc/flash_mha_bwd.cu``: fp32 products on the tensor cores as three TF32
passes, held to the bars that chip_smoke.py holds the kernels to on the
card.

Each fp32 operand is split as x = hi + lo (``split_tf32`` of
``csrc/mma.cuh``): hi = _rna(x), x rounded to TF32 (10 mantissa bits, to
nearest, ties away from 0), and lo = x - hi exactly. A TF32 product reads
the top 19 bits of a 32-bit operand (``_tf32``: the low 13 cleared), so a
product a b is taken as tf32(lo_a) hi_b + hi_a tf32(lo_b) + hi_a hi_b,
summed in fp32: x is held to 2^-21 |x| with an error of either sign, a
product to 2^-19 |a b|. Both roundings work on the int32 view, as the
kernels do. (Rounding lo with ``cvt.rna.tf32.f32`` too would cost 4-5
instructions an operand more on the H100: PERF.md.)
``_tf32x3_forward`` walks the forward kernel's key tiles
with a running max and splits p = exp(s - m) before p v;
``_tf32x3_backward`` walks the dq kernel's key tiles (delta first, then
ds split before ds k) and the dk/dv kernel's query tiles (p and ds split
before p^T do and ds^T q). Both are held against the port's plain fp32
versions and against the JAX package's Pallas kernels in interpret mode
(the forward, and ``jax.vjp`` of it) on the same fp32 inputs, at phase 3's
fp32 bars: o and lse within 1e-4; dqkv per element within
1e-4 + 1e-5 (|plain| + mag), mag the sum of the absolute terms the element
adds up.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from forde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
FWD_ATOL = 1e-4  # o (rtol 0) and lse
BWD_ATOL, BWD_RTOL = 1e-4, 1e-5
FWD_KEYS = 32  # keys per tile of the forward kernel


DKDV_QUERIES = 16  # queries per tile of the dk/dv kernel


def dq_keys(d):
    """Keys per tile of the dq kernel."""
    return 16 if d == 128 else 32


# (B, S, H, D, kv_lens, causal, window): the vision shape at a small batch
# and the mask cases of chip_smoke's CHECK_CASES.
CASES = {
    "s200_d128": (2, 200, 2, 128, None, False, None),
    "s64_d128_lens_0_1": (4, 64, 2, 128, [0, 1, 17, 64], False, None),
    "s197_d64_kv_bound": (2, 197, 2, 64, None, False, None),
    "s128_d64_causal_window32": (2, 128, 2, 64, None, True, 32),
    "s200_d128_causal_window32_lens": (3, 200, 2, 128, [200, 0, 5], True, 32),
    "s8_d128_lens": (3, 8, 2, 128, [8, 0, 3], False, None),
}


def _tf32(x):
    """The TF32 value a tensor core reads of fp32 x: its low 13 bits
    cleared (10 mantissa bits kept, toward 0)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _rna(x):
    """x rounded to TF32, to nearest with ties away from 0: half of the
    unit of the 13 dropped bits added to the bit pattern (a 32-bit
    addition), then those bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return bits.view(torch.float32)


def _split(x):
    """(hi, lo) with hi + lo = x exactly; a product reads lo as tf32(lo)."""
    hi = _rna(x)
    return hi, x - hi


def _mm3(a, b):
    """a @ b in three TF32 passes, summed in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return _tf32(al) @ bh + ah @ _tf32(bl) + ah @ bh


def _inputs(case, seed=0):
    """fp32 qkv and do (padded to a multiple of 8 as ``flash_mha`` pads
    them), their unpadded copies, kv_bound, the lens and the static
    arguments."""
    b, s, h, d, lens, causal, window = CASES[case]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(b, s, 3 * h * d) * 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32))
    s_pad = -(-s // 8) * 8
    kv_bound = s if (s_pad != s and not causal and lens is None) else None
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    args = (h, d, d ** -0.5, window, causal, kv_bound)
    return (x, g, F.pad(x, (0, 0, 0, s_pad - s)), F.pad(g, (0, 0, 0, s_pad - s)),
            lens_t, args)


def _heads(qkv, num_heads, head_dim):
    b, s, _ = qkv.shape
    return qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)


def _tf32x3_forward(qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound):
    """The fp32 forward kernel's arithmetic: o (B, S, H*D), lse (B, H, S, 1)."""
    b, s, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads, head_dim)
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    m = torch.full((b, num_heads, s, 1), -float("inf"))
    l = torch.zeros(b, num_heads, s, 1)
    acc = torch.zeros(b, num_heads, s, head_dim)
    for k0 in range(0, s, FWD_KEYS):
        cols = slice(k0, min(k0 + FWD_KEYS, s))
        sc = _mm3(q, k[:, :, cols].transpose(-1, -2)) * scale
        if mask is not None:
            sc = sc.masked_fill(~mask[..., cols], fa.MASK_VALUE)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(p, v[:, :, cols])
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l_safe * (m > fa.MASK_VALUE * 0.5).float()
    return o.transpose(1, 2).reshape(b, s, num_heads * head_dim), m + torch.log(l_safe)


def _probs(q, k, lse, mask, scale):
    p = torch.exp(_mm3(q, k.transpose(-1, -2)) * scale - lse)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros(()))
    return p


def _tf32x3_backward(qkv, lens, lse, do, num_heads, head_dim, scale, window, causal,
                     kv_bound):
    """The fp32 backward kernels' arithmetic: dqkv (B, S, 3*H*D)."""
    b, s, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads, head_dim)
    dof = do.reshape(b, s, num_heads, head_dim).transpose(1, 2)
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        mask = mask.expand(b, num_heads, s, s)
    key_tiles = [slice(c0, min(c0 + dq_keys(head_dim), s))
                 for c0 in range(0, s, dq_keys(head_dim))]
    query_tiles = [slice(r0, min(r0 + DKDV_QUERIES, s)) for r0 in range(0, s, DKDV_QUERIES)]

    def tile_mask(rows, cols):
        return None if mask is None else mask[:, :, rows, cols]

    # dq: walk 1 sums delta over the key tiles; walk 2 forms ds and dq.
    every = slice(0, s)
    delta = torch.zeros(b, num_heads, s, 1)
    for cols in key_tiles:
        p = _probs(q, k[:, :, cols], lse, tile_mask(every, cols), scale)
        delta = delta + (p * _mm3(dof, v[:, :, cols].transpose(-1, -2))).sum(-1, keepdim=True)
    dq = torch.zeros(b, num_heads, s, head_dim)
    for cols in key_tiles:
        p = _probs(q, k[:, :, cols], lse, tile_mask(every, cols), scale)
        ds = p * (_mm3(dof, v[:, :, cols].transpose(-1, -2)) - delta) * scale
        dq = dq + _mm3(ds, k[:, :, cols])
    # dk/dv: the query tiles, each giving p^T and ds^T of every key.
    dk = torch.zeros(b, num_heads, s, head_dim)
    dv = torch.zeros(b, num_heads, s, head_dim)
    for rows in query_tiles:
        p = _probs(q[:, :, rows], k, lse[:, :, rows], tile_mask(rows, every), scale)
        ds = p * (_mm3(dof[:, :, rows], v.transpose(-1, -2)) - delta[:, :, rows]) * scale
        dv = dv + _mm3(p.transpose(-1, -2), dof[:, :, rows])
        dk = dk + _mm3(ds.transpose(-1, -2), q[:, :, rows])
    dqkv = torch.stack([dq, dk, dv], dim=2)  # (B, H, 3, S, D)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * num_heads * head_dim)


def _bwd_magnitude(qkv, lens, lse, do, num_heads, head_dim, scale, window, causal,
                   kv_bound):
    """(B, S, 3*H*D): per element of dq, dk, dv the sum of the absolute
    terms it adds up (|ds| |k|, |ds|^T |q|, |p|^T |do|), plain fp32."""
    b, s, _ = qkv.shape
    q, k, v = _heads(qkv, num_heads, head_dim)
    dof = do.reshape(b, s, num_heads, head_dim).transpose(1, 2)
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros(()))
    dp = dof @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).abs()
    mag = torch.stack([ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(),
                       p.transpose(-1, -2) @ dof.abs()], dim=2)
    return mag.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * num_heads * head_dim)


def _assert_bwd_within_bar(got, want, plain, mag):
    worst = ((got - want).abs() / (BWD_ATOL + BWD_RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"worst |Δ| / (atol + rtol (|plain| + mag)) = {worst:.3f}"


def _jax_forward_and_grad(x, g, lens, num_heads, head_dim, causal, window):
    def f(qkv):
        return jax_flash_mha(
            qkv, num_heads, head_dim, causal=causal, window_size=window,
            kv_lens=None if lens is None else jnp.asarray(lens.numpy()), impl="interpret",
        )

    o, vjp = jax.vjp(f, jnp.asarray(x.numpy()))
    (dqkv,) = vjp(jnp.asarray(g.numpy()))
    return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(dqkv))


def test_tf32_keeps_the_top_19_bits_and_rna_rounds_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 1.5 * ulp, 3.0, -0.0, 0.0, float("inf"), -float("inf")])
    cases = ((_tf32, [one, -one, one, one + ulp, 3.0, -0.0, 0.0, float("inf"), -float("inf")]),
             (_rna, [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, -0.0, 0.0,
                     float("inf"), -float("inf")]))
    for rounding, want in cases:
        got, want = rounding(x), torch.tensor(want)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)
    # A NaN reaches the products through lo, whatever the rounding makes
    # of its bits.
    for bits in (0x7FC00000, 0x7FFFFFFF, -1):
        nan = torch.tensor([bits], dtype=torch.int32).view(torch.float32)
        hi, lo = _split(nan)
        assert torch.isnan(_tf32(lo)).all()


SPLIT_VALUES = {
    "normal": lambda rng: rng.randn(4096) * 10.0 ** rng.randint(-6, 7, 4096),
    "signed_zeros": lambda rng: np.array([0.0, -0.0]),
    "subnormal": lambda rng: rng.uniform(-1, 1, 4096) * 2.0 ** -126,
    "smallest_normals": lambda rng: rng.uniform(1, 2, 4096) * 2.0 ** rng.randint(-126, -112, 4096),
    "large_exponents": lambda rng: (rng.uniform(1, 1.7, 4096) * 2.0 ** 127
                                    * rng.choice([-1, 1], 4096)),
}


@pytest.mark.parametrize("kind", sorted(SPLIT_VALUES))
def test_split_reconstructs_to_2_pow_minus_21(kind):
    """hi + lo = x exactly, |lo| <= 2^-11 |x| (half of hi's unit), and what
    a product reads, hi + tf32(lo), is within 2^-21 |x|: lo's own unit is
    2^-21 of |x| at most. Below the normal range the TF32 grid keeps fp32's
    subnormal spacing times 2^13, 2^-136: there lo is within half of it and
    what is read within all of it. The error takes either sign. A product of two TF32 values is exact in fp32
    wherever it lands in fp32's normal range."""
    x = torch.from_numpy(SPLIT_VALUES[kind](np.random.RandomState(3)).astype(np.float32))
    hi, lo = _split(x)
    assert torch.all(torch.isfinite(hi)) and torch.all(torch.isfinite(lo))
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.equal(hi.double() + lo.double(), x.double())
    floor = torch.full_like(x.double(), 2.0 ** -137)
    assert torch.all(lo.double().abs() <= torch.maximum(2.0 ** -11 * x.double().abs(), floor))
    err = x.double() - hi.double() - _tf32(lo).double()
    assert torch.all(err.abs() <= torch.maximum(2.0 ** -21 * x.double().abs(), 2 * floor))
    if kind == "normal":
        assert (err * x.double() > 0).any() and (err * x.double() < 0).any()
    if kind == "signed_zeros":
        assert torch.all(hi == 0) and torch.all(lo == 0)
    a = hi[torch.randperm(len(hi), generator=torch.Generator().manual_seed(0))]
    exact = hi.double() * a.double()
    normal = (exact == 0) | ((exact.abs() >= 2.0 ** -126) & (exact.abs() < 2.0 ** 127))
    assert torch.equal((hi * a)[normal].double(), exact[normal])


def test_tiles_are_the_kernels():
    """The emulation walks the tiles the CUDA sources use."""
    fwd = (CSRC / "flash_mha_fwd.cu").read_text()
    bwd = (CSRC / "flash_mha_bwd.cu").read_text()
    assert re.search(rf"constexpr int F32_BK = {FWD_KEYS};", fwd)
    m = re.search(r"constexpr int f32_dq_keys\(\) \{\s*return D == 128 \? (\d+) : (\d+);", bwd)
    assert m and (int(m[1]), int(m[2])) == (dq_keys(128), dq_keys(64))
    assert re.search(rf"constexpr int F32_DKDV_QUERIES = {DKDV_QUERIES};", bwd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_forward_matches_plain_fp32(case):
    _, _, qkv, _, lens, args = _inputs(case)
    o, lse = _tf32x3_forward(qkv, lens, *args)
    o_ref, lse_ref = fa.flash_mha_fwd_reference(qkv, lens, *args)
    torch.testing.assert_close(o, o_ref, atol=FWD_ATOL, rtol=0.0)
    torch.testing.assert_close(lse, lse_ref, atol=FWD_ATOL, rtol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_forward_matches_jax_kernel_fp32(case):
    x, g, qkv, _, lens, args = _inputs(case, seed=1)
    h, d, _, window, causal, _ = args
    s = x.shape[1]
    want, _ = _jax_forward_and_grad(x, g, lens, h, d, causal, window)
    o, _ = _tf32x3_forward(qkv, lens, *args)
    assert want.shape == o[:, :s].shape
    torch.testing.assert_close(o[:, :s], want, atol=FWD_ATOL, rtol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_plain_fp32(case):
    """From the emulated forward's lse, as the kernels chain on the card."""
    _, _, qkv, do, lens, args = _inputs(case, seed=2)
    _, lse = _tf32x3_forward(qkv, lens, *args)
    dqkv = _tf32x3_backward(qkv, lens, lse, do, *args)
    want = fa.flash_mha_bwd_reference(qkv, lens, lse, do, *args)
    assert torch.all(torch.isfinite(dqkv))
    _assert_bwd_within_bar(dqkv, want, want, _bwd_magnitude(qkv, lens, lse, do, *args))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32x3_backward_matches_jax_kernel_fp32(case):
    x, g, qkv, do, lens, args = _inputs(case, seed=3)
    h, d, _, window, causal, _ = args
    s = x.shape[1]
    _, want = _jax_forward_and_grad(x, g, lens, h, d, causal, window)
    _, lse = _tf32x3_forward(qkv, lens, *args)
    dqkv = _tf32x3_backward(qkv, lens, lse, do, *args)[:, :s]
    plain = fa.flash_mha_bwd_reference(qkv, lens, lse, do, *args)[:, :s]
    mag = _bwd_magnitude(qkv, lens, lse, do, *args)[:, :s]
    assert want.shape == dqkv.shape
    _assert_bwd_within_bar(dqkv, want, plain, mag)
    if lens is not None and 0 in lens.tolist():
        assert torch.all(dqkv[lens == 0] == 0)
