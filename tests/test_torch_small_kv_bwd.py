"""The port's NSA small-KV attention backward (forde_tpu_torch.ops.
nsa_attention: ``small_kv_bwd`` and its plain version
``small_kv_bwd_reference``, through the autograd Function
``SmallKVAttention``) against ``jax.grad`` of the JAX package's
``small_kv_attention`` with ``impl="interpret"``: its Pallas ``_bwd_kernel``
in interpret mode, with a small ``block_q`` so that dk and dv are summed
over several q blocks. Key sets: pool thresholds, top-k indices, ragged K
(padded to 8 on the JAX side) and D (padded to 64 on both), INVALID_KEY_POS
padding keys, and every key in the future (the uniform quirk: such a row
adds to dv but not to dq or dk).

On the CPU the port runs the kernel's plain version. Inputs come from
numpy with a seed. fp32 gradients within atol = rtol = 2e-5 (fp32 sums in
other orders; observed below 3e-6). bf16 within 2^-6 of the largest
|gradient| per element: both sides round w (for dv) and ds (for dq, dk)
to bf16 from fp32 values that differ in their last bits, a bf16 ulp
(2^-8 relative) apart at most, and round the outputs; observed below
2^-8. The CUDA kernel, which sums dk and dv with fp32 atomics, is held
against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import nsa_attention as jnsa
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import nsa_attention as nsa

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, h, s, kk, d, kind, seed):
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, kk, d).astype(np.float32) for _ in range(2))
    if kind == "pools":  # pool p visible from position (p + 1) * 4
        key_pos = np.broadcast_to((np.arange(kk) + 1) * 4, (b, kk))
    elif kind == "topk":  # selected token indices
        key_pos = np.stack([rng.permutation(s)[:kk] for _ in range(b)])
    elif kind == "invalid":  # a row's pools past its length
        key_pos = np.broadcast_to((np.arange(kk) + 1) * 4, (b, kk)).copy()
        key_pos[0, kk // 2:] = nsa.INVALID_KEY_POS
    else:  # every key in the future
        key_pos = np.full((b, kk), s + 10)
    return q, k, v, np.ascontiguousarray(key_pos, np.int32), do


def _jax_grads(q, k, v, key_pos, do, dtype=jnp.float32):
    def f(q, k, v):
        out = jnsa.small_kv_attention(q, k, v, jnp.asarray(key_pos), impl="interpret",
                                      block_q=16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, key_pos, do, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = nsa.small_kv_attention(*leaves, torch.from_numpy(key_pos))
    assert out.grad_fn is not None
    out.float().backward(torch.from_numpy(do))
    return [t.grad.float().numpy() for t in leaves]


# (B, H, S, K, D, keys)
CASES = {
    "pools_s64_k12_d64": (2, 2, 64, 12, 64, "pools"),
    "topk_s80_k16_d64": (2, 2, 80, 16, 64, "topk"),
    "ragged_s50_k13_d48": (1, 2, 50, 13, 48, "pools"),
    "invalid_s64_k16_d64": (2, 2, 64, 16, 64, "invalid"),
    "future_s32_k10_d64": (1, 2, 32, 10, 64, "future"),
    "pools_s48_k8_d128": (1, 1, 48, 8, 128, "pools"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_small_kv_grads_match_jax_interpret(case):
    inputs = _inputs(*CASES[case], seed=0)
    want = _jax_grads(*inputs)
    got = _port_grads(*inputs)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("case", ["pools_s64_k12_d64", "topk_s80_k16_d64"])
def test_small_kv_grads_match_jax_interpret_bf16(case):
    inputs = _inputs(*CASES[case], seed=1)
    want = _jax_grads(*inputs, dtype=jnp.bfloat16)
    got = _port_grads(*inputs, dtype=torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max(), f"d{name}"


def test_row_with_no_visible_key_moves_dv_only():
    """The uniform quirk in the backward: every key in the future gives
    w = 1/K on every real key, so dv = sum over rows of do / K, while ds
    (and so dq and dk) is zeroed where the mask was false."""
    q, k, v, key_pos, do = _inputs(1, 2, 32, 10, 64, "future", seed=2)
    dq, dk, dv = nsa.small_kv_bwd(*(torch.from_numpy(x) for x in (q, k, v, key_pos, do)), 0.125)
    assert dq.abs().max() == 0 and dk.abs().max() == 0
    want = np.broadcast_to(do.sum(axis=2, keepdims=True) / 10, dv.shape)
    np.testing.assert_allclose(dv.numpy(), want, atol=1e-5)


def test_plain_backward_is_autograd_of_plain_forward():
    """In fp32 the plain backward is the exact gradient of the plain
    forward; padding keys get no gradient at all."""
    q, k, v, key_pos, do = (torch.from_numpy(x) for x in _inputs(2, 2, 64, 16, 64, "invalid", 3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = nsa.small_kv_fwd_reference(*leaves, key_pos, 0.125)
    want = torch.autograd.grad(out, leaves, do)
    got = nsa.small_kv_bwd_reference(q, k, v, key_pos, do, 0.125)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert got[1][0, :, 8:].abs().max() == 0 and got[2][0, :, 8:].abs().max() == 0


def test_small_kv_bwd_cpu_runs_no_kernel():
    kernels.reset_launches()
    _port_grads(*_inputs(1, 1, 32, 8, 64, "pools", seed=4))
    assert kernels.launches["small_kv_fwd"] == kernels.launches["small_kv_bwd"] == 0


def test_small_kv_bwd_rejects_other_devices():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nsa.small_kv_bwd(q, q, q, torch.zeros(1, 8, dtype=torch.int32), q, 0.125)
