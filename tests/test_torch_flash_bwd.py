"""The port's 4-D flash-attention backward (forde_tpu_torch.ops.
flash_attention: ``flash_bwd`` and the plain versions of its two kernels,
``flash_bwd_dq_reference`` and ``flash_bwd_dkv_reference``, through the
autograd Function ``FlashAttention``) against ``jax.grad`` of the JAX
package's ``flash_attention`` with ``impl="interpret"``: the resident
Pallas kernels ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` in interpret mode,
and the streaming ``_bwd_dq_stream_kernel`` / ``_bwd_dkv_stream_kernel``
when the JAX threshold is lowered to 256 (as tests/test_ops_attention.py
does). Explicit block sizes give the JAX kernels several blocks, so their
masked edge loops and unmasked interior loops both run. The lse
cotangent (``dlse``) goes through ``flash_attention_with_lse``'s
backward, resident and streaming.

On the CPU the port runs the kernels' plain versions. Inputs come from
numpy with a seed. fp32 gradients within atol = rtol = 5e-5 (fp32 sums in
other orders through the forward's online softmax and three products;
observed below 5e-6). bf16 within 2^-6 of the largest |gradient| per
element: both sides round p and ds to bf16, from fp32 values that differ
in their last bits (the Pallas kernel's lse comes from 128-key blocks),
so a term may round one bf16 ulp (2^-8 relative) apart, and both round
the output (2^-8); observed below 2^-8. The CUDA kernels are held
against these plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import flash_attention as jfa
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(atol=5e-5, rtol=5e-5)

# (B, H, S, D, causal, window, block): S past 512 so that the JAX kernels
# take the explicit blocks; windows, a padded D, a non-causal padded tail
# (the kv_len bound), D = 128.
CASES = {
    "s640_d64_causal_window200_b128": (1, 2, 640, 64, True, 200, 128),
    "s576_d48_causal_b64": (1, 2, 576, 48, True, None, 64),
    "s600_d64_noncausal_kv_len_b128": (1, 2, 600, 64, False, None, 128),
    "s640_d128_window128_b128": (1, 1, 640, 128, True, 128, 128),
}


def _inputs(b, h, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, do, causal, window, block, dtype=jnp.float32):
    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, window_size=window,
                                impl="interpret", block_q=block, block_k=block)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, do, causal, window, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, window_size=window)
    assert o.grad_fn is not None
    o.float().backward(torch.from_numpy(do))
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_grads_match_jax_interpret(case):
    b, h, s, d, causal, window, block = CASES[case]
    q, k, v, do = _inputs(b, h, s, d, seed=0)
    want = _jax_grads(q, k, v, do, causal, window, block)
    got = _port_grads(q, k, v, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("window", [128, None])
def test_streaming_backward_matches_jax_stream_kernels(monkeypatch, window):
    """S past the (lowered) threshold: the JAX package runs its streaming
    backward kernels; the port's one pair of kernels gives the same
    gradients."""
    monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 256)
    q, k, v, do = _inputs(1, 2, 512, 64, seed=1)
    want = _jax_grads(q, k, v, do, True, window, 128)
    got = _port_grads(q, k, v, do, True, window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_flash_attention_grads_match_jax_interpret_bf16():
    q, k, v, do = _inputs(1, 2, 640, 64, seed=2)
    want = _jax_grads(q, k, v, do, True, 200, 128, jnp.bfloat16)
    got = _port_grads(q, k, v, do, True, 200, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max(), f"d{name}"


@pytest.mark.parametrize("stream", [False, True])
def test_flash_bwd_dlse_matches_jax_with_lse(monkeypatch, stream):
    """``flash_bwd(dlse=...)`` against the vjp of the JAX package's
    ``flash_attention_with_lse`` with a cotangent on both o and lse (the
    ring-attention route); ``stream`` lowers the threshold so that the
    streaming kernels run."""
    if stream:
        monkeypatch.setattr(jfa, "LONG_SEQ_THRESHOLD", 256)
    q, k, v, do = _inputs(1, 2, 512, 64, seed=3)
    dlse = np.random.RandomState(4).randn(1, 2, 512, 1).astype(np.float32)
    o_j, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention_with_lse(
            q, k, v, causal=True, window_size=128, impl="interpret", block_q=128, block_k=128),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_fwd_reference(tq, tk, tv, 0.125, 128, True, None)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j[0]), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(o_j[1]), **TOL)
    got = fa.flash_bwd(tq, tk, tv, o, lse, tdo, 0.125, 128, True, None,
                       dlse=torch.from_numpy(dlse))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)
    # dlse moves every gradient: it is not dropped on the way.
    plain = fa.flash_bwd(tq, tk, tv, o, lse, tdo, 0.125, 128, True, None)
    assert not torch.allclose(plain[0], got[0])


def test_plain_backward_is_autograd_of_plain_forward():
    """In fp32 the kernels' plain versions are the exact gradient of the
    forward's plain version (no rounding to differ)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 2, 128, 64, seed=5))
    for causal, window, kv_len in ((True, 32, None), (False, None, 100), (False, 40, None)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = fa.flash_fwd_reference(*leaves, 0.125, window, causal, kv_len)
        want = torch.autograd.grad(o, leaves, do)
        got = fa.flash_bwd_reference(q, k, v, o.detach(), lse.detach(), do, 0.125, window,
                                     causal, kv_len)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_flash_bwd_cpu_runs_no_kernel():
    kernels.reset_launches()
    _port_grads(*_inputs(1, 1, 64, 64, seed=6), True, 16)
    assert kernels.launches["flash_bwd_dq"] == kernels.launches["flash_bwd_dkv"] == 0


@pytest.mark.parametrize("fn", [fa.flash_bwd_dq, fa.flash_bwd_dkv])
def test_flash_bwd_kernels_reject_other_devices(fn):
    q = torch.empty(1, 1, 64, 64, device="meta")
    lse = torch.empty(1, 1, 64, 1, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fn(q, q, q, q, lse, lse, 0.125, None, True, None)
