"""The port's 4-D flash-attention forward (forde_tpu_torch.ops.
flash_attention: ``flash_attention`` and the kernel's plain version
``flash_fwd_reference``) against the JAX package's ``flash_attention``
with ``impl="interpret"``: the resident Pallas kernel ``_fwd_kernel`` run
in interpret mode, and the streaming kernel ``_fwd_stream_kernel`` when
the JAX threshold is lowered to 256 (as tests/test_ops_attention.py does).

On the CPU the port runs the kernel's plain version. Inputs come from
numpy with a seed. fp32 within atol = rtol = 2e-5 (fp32 products summed
in other orders, and the online softmax's rescaling against one
softmax; observed ~1e-6). bf16 within 2^-7 of the largest |o| per
element: the Pallas kernel rounds p to bf16 relative to the running max
of its 128-key blocks and the plain version relative to the row's max,
each a relative 2^-9 of a term, and both round o to bf16 (2^-9).
The CUDA kernel is held against the plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import flash_attention as jfa
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

# (B, H, S, D, causal, window): windows, odd S, padded D, non-causal with
# the kv_len bound of a padded tail.
CASES = {
    "s128_d64_causal": (2, 2, 128, 64, True, None),
    "s256_d64_causal_window48": (1, 2, 256, 64, True, 48),
    "s200_d128_causal_window64": (1, 2, 200, 128, True, 64),
    "s77_d48_causal": (2, 1, 77, 48, True, None),
    "s100_d32_noncausal_kv_len": (2, 2, 100, 32, False, None),
    "s64_d64_noncausal": (1, 2, 64, 64, False, None),
}


def _qkv(b, h, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, causal, window, dtype=jnp.float32):
    out = jfa.flash_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal,
        window_size=window, impl="interpret",
    )
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, causal, window, dtype=torch.float32, impl="auto"):
    out = fa.flash_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal,
        window_size=window, impl=impl,
    )
    return out.float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_jax_interpret(case):
    b, h, s, d, causal, window = CASES[case]
    q, k, v = _qkv(b, h, s, d)
    got = _port(q, k, v, causal, window)
    assert got.shape == (b, h, s, d)
    np.testing.assert_allclose(got, _jax(q, k, v, causal, window), **TOL)


@pytest.mark.parametrize("case", ["s256_d64_causal_window48", "s100_d32_noncausal_kv_len"])
def test_flash_attention_matches_jax_interpret_bf16(case):
    b, h, s, d, causal, window = CASES[case]
    q, k, v = _qkv(b, h, s, d, seed=1)
    want = _jax(q, k, v, causal, window, jnp.bfloat16)
    got = _port(q, k, v, causal, window, torch.bfloat16)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_impl_matches_jax_reference(case):
    b, h, s, d, causal, window = CASES[case]
    q, k, v = _qkv(b, h, s, d, seed=2)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window_size=window,
        impl="reference",
    ))
    np.testing.assert_allclose(_port(q, k, v, causal, window, impl="reference"), want, **TOL)


@pytest.mark.parametrize("window", [128, None])
def test_streaming_route_matches_jax_stream_kernel(monkeypatch, window):
    """S past the (lowered) threshold: the JAX package runs its streaming
    kernel; the port's one forward gives the same numbers."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 256)
    q, k, v = _qkv(1, 2, 512, 64, seed=3)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, window_size=window,
        impl="interpret", block_q=128, block_k=128,
    ))
    np.testing.assert_allclose(_port(q, k, v, True, window), want, **TOL)


def test_flash_fwd_reference_lse():
    """lse of the plain version is the log-sum-exp of the visible scores."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 128, 64, seed=4))
    o, lse = fa.flash_fwd_reference(q, k, v, 0.125, 32, True, None)
    scores = (q @ k.transpose(-1, -2)) * 0.125
    pos = torch.arange(128)
    vis = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 32)
    want = torch.logsumexp(scores.masked_fill(~vis, -float("inf")), dim=-1, keepdim=True)
    assert lse.shape == (1, 2, 128, 1) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_flash_attention_cpu_runs_no_kernel_and_has_grad():
    """On the CPU the plain version runs (no launch) and autograd
    differentiates it."""
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(1, 1, 64, 64, seed=5))
    o = fa.flash_attention(q, k, v, causal=True, window_size=16)
    assert o.grad_fn is not None
    o.sum().backward()
    assert q.grad is not None and kernels.launches["flash_fwd"] == 0


def test_flash_attention_on_card_refuses_grad(monkeypatch):
    """The autograd guard: where the kernel would launch, an input that
    requires grad raises before any launch (its backward kernels are not
    ported); under no_grad the call proceeds to the wrapper."""
    monkeypatch.setattr(fa, "_on_card", lambda t: True)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 64, 64, seed=6))
    with pytest.raises(NotImplementedError, match="_bwd_dq_kernel"):
        fa.flash_attention(q.requires_grad_(True), k, v, causal=True)
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, causal=True)
    assert o.shape == q.shape


def test_flash_fwd_rejects_other_devices():
    q = torch.empty(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_fwd(q, q, q, 0.125, None, True, None)


def test_flash_mha_4d_route_matches_jax():
    """flash_mha outside the fused kernel's shapes (head_dim 32; S 520 >
    512) takes the 4-D forward, as the JAX package does."""
    for s, d, causal, window in ((40, 32, True, None), (520, 64, True, 128), (70, 32, False, None)):
        x = (np.random.RandomState(s).randn(1, s, 3 * 2 * d) * 0.5).astype(np.float32)
        want = np.asarray(jfa.flash_mha(jnp.asarray(x), 2, d, causal=causal,
                                        window_size=window, impl="interpret"))
        got = fa.flash_mha(torch.from_numpy(x), 2, d, causal=causal, window_size=window)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_mha(torch.zeros(1, 40, 3 * 2 * 32), 2, 32, kv_lens=torch.tensor([3]))


def test_mha_reference_per_row_mask_matches_jax():
    """mha_reference with the (B, 1, 1, M) per-row mask of the dense and
    ring-buffer decode steps."""
    from forde_tpu.ops import attention_ref as jref
    from forde_tpu_torch.ops import attention_ref as tref

    rng = np.random.RandomState(7)
    q = rng.randn(3, 2, 1, 16).astype(np.float32)
    k, v = (rng.randn(3, 2, 40, 16).astype(np.float32) for _ in range(2))
    mask = np.arange(40)[None, :] <= np.array([0, 17, 39])[:, None]
    mask = mask[:, None, None, :]
    want = np.asarray(jref.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                         mask=jnp.asarray(mask)))
    got = tref.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                             mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
