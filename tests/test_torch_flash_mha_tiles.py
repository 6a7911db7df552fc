"""The rounding points of the bf16 tensor-core route of
``csrc/flash_mha_fwd.cu``, held to the bar that chip_smoke.py holds the
kernel to on the card.

The route walks 64-key tiles with a running max, rounds p = exp(s - m) to
bf16 before the product with v, sums in fp32, divides by l at the end and
rounds o to bf16, where the TPU kernel rounds the normalised p / l
(forde_tpu/ops/flash_attention.py:1024). ``_tile_forward`` does exactly
that in plain torch. It is held against the port's plain version in fp32
(``flash_mha_fwd_reference``) and against the JAX package's Pallas kernel
in interpret mode on the same bf16 inputs, per element at
|Δ| <= 1e-4 + 2^-8 (|plain| + mag), mag = sum_c (p_c / l) |v_c|: rounding p
moves each term by at most 2^-9 of it, rounding o the value by 2^-9.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from forde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 2.0 ** -8
BLOCK = 64  # keys per tile of the kernel

# (B, S, H, D, kv_lens, causal, window): the mask cases of chip_smoke's
# CHECK_CASES at a small batch.
CASES = {
    "s64_d128_lens_0_1": (4, 64, 2, 128, [0, 1, 17, 64], False, None),
    "s197_d64_kv_bound": (2, 197, 2, 64, None, False, None),
    "s128_d64_causal_window32": (2, 128, 2, 64, None, True, 32),
    "s200_d128_causal_window32_lens": (3, 200, 2, 128, [200, 0, 5], True, 32),
    "s8_d128_lens": (3, 8, 2, 128, [8, 0, 3], False, None),
}


def _inputs(case, seed=0):
    """bf16 qkv (padded to a multiple of 8 as ``flash_mha`` pads it), its
    kv_bound, the lens and the static arguments."""
    b, s, h, d, lens, causal, window = CASES[case]
    x = (np.random.RandomState(seed).randn(b, s, 3 * h * d) * 0.5).astype(np.float32)
    qkv = torch.from_numpy(x).to(torch.bfloat16)
    s_pad = -(-s // 8) * 8
    kv_bound = s if (s_pad != s and not causal and lens is None) else None
    qkv_pad = F.pad(qkv, (0, 0, 0, s_pad - s))
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    args = (h, d, d ** -0.5, window, causal, kv_bound)
    return qkv, qkv_pad, lens_t, args


def _tile_forward(qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound):
    """The bf16 route's arithmetic in plain torch: o (B, S, H*D) bf16 and
    lse (B, H, S, 1) fp32."""
    b, s, _ = qkv.shape
    q, k, v = (t.float() for t in qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4))
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    m = torch.full((b, num_heads, s, 1), -float("inf"))
    l = torch.zeros(b, num_heads, s, 1)
    acc = torch.zeros(b, num_heads, s, head_dim)
    for k0 in range(0, s, BLOCK):
        cols = slice(k0, min(k0 + BLOCK, s))
        sc = q @ k[:, :, cols].transpose(-1, -2) * scale
        if mask is not None:
            sc = sc.masked_fill(~mask[..., cols], fa.MASK_VALUE)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ v[:, :, cols]
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = acc / l_safe * (m > fa.MASK_VALUE * 0.5).float()
    o = o.to(torch.bfloat16).transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o, m + torch.log(l_safe)


def _magnitude(qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound):
    """sum_c (p_c / l) |v_c| per element of o, fp32 weights."""
    b, s, _ = qkv.shape
    q, k, v = (t.float() for t in qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4))
    sc = q @ k.transpose(-1, -2) * scale
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        sc = sc.masked_fill(~mask, fa.MASK_VALUE)
    mag = torch.softmax(sc, dim=-1) @ v.abs()
    return mag.transpose(1, 2).reshape(b, s, num_heads * head_dim)


def _assert_within_bar(got, want, plain, mag):
    """|got - want| <= atol + rtol (|plain| + mag) per element."""
    diff = (got.float() - want).abs()
    worst = (diff / (ATOL + RTOL * (plain.abs() + mag))).max().item()
    assert worst <= 1.0, f"worst |Δ| / (atol + rtol (|plain| + mag)) = {worst:.3f}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_plain_fp32(case):
    _, qkv, lens, args = _inputs(case)
    o, lse = _tile_forward(qkv, lens, *args)
    o_ref, lse_ref = fa.flash_mha_fwd_reference(qkv.float(), lens, *args)
    _assert_within_bar(o, o_ref, o_ref, _magnitude(qkv, lens, *args))
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_forward_matches_jax_kernel_bf16(case):
    """The same bf16 values through the Pallas kernel (interpret mode),
    which rounds p / l to bf16 instead of p."""
    qkv, qkv_pad, lens, args = _inputs(case, seed=1)
    h, d, _, window, causal, _ = args
    s = qkv.shape[1]
    want = jax_flash_mha(
        jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16), h, d, causal=causal,
        window_size=window, kv_lens=None if lens is None else jnp.asarray(lens.numpy()),
        impl="interpret",
    )
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    o, _ = _tile_forward(qkv_pad, lens, *args)
    o_ref, _ = fa.flash_mha_fwd_reference(qkv_pad.float(), lens, *args)
    mag = _magnitude(qkv_pad, lens, *args)
    assert want.shape == o[:, :s].shape
    _assert_within_bar(o[:, :s], want, o_ref[:, :s], mag[:, :s])


def test_tile_forward_empty_sample_is_zero():
    """A kv_lens == 0 sample: o exactly 0 and lse -1e30, as the kernel
    writes them."""
    _, qkv, lens, args = _inputs("s64_d128_lens_0_1", seed=2)
    o, lse = _tile_forward(qkv, lens, *args)
    empty = lens == 0
    assert bool(empty.any())
    assert torch.all(o[empty] == 0)
    assert torch.all(lse[empty] == fa.MASK_VALUE)
    assert torch.all(torch.isfinite(lse[~empty]))


def test_kernel_args_reject_unaligned_pointers():
    """The bf16 route copies with 16-byte cp.async: a tensor that starts
    off a 16-byte boundary is refused before any launch."""
    n = 2 * 64 * 3 * 2 * 64
    buf = torch.empty(8 + n, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte aligned qkv"):
        fa._check_aligned("flash_mha_fwd", qkv=buf[1:1 + n].view(2, 64, -1))
    fa._check_aligned("flash_mha_fwd", qkv=buf[8:].view(2, 64, -1))
