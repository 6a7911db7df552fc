"""The gradient of the port's fused-qkv attention against the JAX
package's: ``torch.autograd`` through ``flash_mha`` (``FlashMHAFused``,
whose backward on a CPU tensor is ``flash_mha_bwd_reference``, the plain
version of the CUDA kernel) vs ``jax.vjp`` of ``flash_mha(impl=
"interpret")``, the Pallas backward kernel run in interpret mode.

Inputs and the upstream gradient come from numpy with a seed. fp32 within
atol = rtol = 1e-5 (fp32 products summed in other orders). bf16: both
sides round p and ds to bf16 at the same points, but an fp32 value that
differs in its last bits between the two rounds to a neighbouring bf16
value (2^-8 of the term) and the outputs round once more, so bf16 is held
per element to 2^-7 of the largest gradient of its tensor, two bf16 ulps
of it (observed: at most 0.0019 of it, one ulp).
The CUDA kernel itself is held against its plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = 2.0 ** -7  # of max |grad|, see the module docstring

# (B, S, H, D, kv_lens, causal, window)
CASES = {
    "s200_d128": (2, 200, 2, 128, None, False, None),
    "s64_d128_lens_0_1_17_64": (4, 64, 2, 128, [0, 1, 17, 64], False, None),
    "s197_d64_kv_bound": (2, 197, 2, 64, None, False, None),
    "s200_d128_causal_window32_lens": (3, 200, 2, 128, [200, 0, 5], True, 32),
    "s64_d64": (2, 64, 2, 64, None, False, None),
}


def _inputs(case, seed=0):
    b, s, h, d, lens, causal, window = CASES[case]
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, 3 * h * d) * 0.5).astype(np.float32)
    g = rng.randn(b, s, h * d).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return x, g, lens, h, d, causal, window


def _jax_grad(x, g, lens, h, d, causal, window, dtype):
    def f(qkv):
        return jax_flash_mha(
            qkv, h, d, causal=causal, window_size=window,
            kv_lens=None if lens is None else jnp.asarray(lens), impl="interpret",
        )

    _, vjp = jax.vjp(f, jnp.asarray(x, dtype))
    (dqkv,) = vjp(jnp.asarray(g, dtype))
    return np.asarray(dqkv.astype(jnp.float32))


def _port_grad(x, g, lens, h, d, causal, window, dtype):
    qkv = torch.from_numpy(x).to(dtype).requires_grad_(True)
    o = fa.flash_mha(
        qkv, h, d, causal=causal, window_size=window,
        kv_lens=None if lens is None else torch.from_numpy(lens),
    )
    o.backward(torch.from_numpy(g).to(dtype))
    assert o.grad_fn is not None and qkv.grad.dtype == dtype
    return qkv.grad.float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_mha_grad_matches_jax_interpret_fp32(case):
    args = _inputs(case)
    want = _jax_grad(*args, jnp.float32)
    got = _port_grad(*args, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_mha_grad_matches_jax_interpret_bf16(case):
    args = _inputs(case, seed=1)
    want = _jax_grad(*args, jnp.bfloat16)
    got = _port_grad(*args, torch.bfloat16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_TOL * np.abs(want).max(), rtol=0)


def test_fully_masked_sample_gets_zero_grad():
    """kv_lens == 0: lse is -1e30 on every row, exp(s - lse) is inf on
    every key, and the select (not a multiply by 0) keeps it out."""
    x, g, lens, h, d, causal, window = _inputs("s64_d128_lens_0_1_17_64", seed=2)
    got = _port_grad(x, g, lens, h, d, causal, window, torch.float32)
    assert np.isfinite(got).all()
    assert np.all(got[0] == 0.0)


def test_bwd_wrapper_matches_autograd_of_plain_forward():
    """flash_mha_bwd (plain version on CPU) against autograd through the
    plain forward, in fp32, on the padded S=197 shape with kv_bound."""
    x, g, _, h, d, _, _ = _inputs("s197_d64_kv_bound", seed=3)
    pad = 200 - x.shape[1]
    qkv = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, pad)).requires_grad_(True)
    do = torch.nn.functional.pad(torch.from_numpy(g), (0, 0, 0, pad))
    o, lse = fa.flash_mha_fwd_reference(qkv, None, h, d, d ** -0.5, None, False, 197)
    (o * do).sum().backward()
    got = fa.flash_mha_bwd(qkv.detach(), None, lse.detach(), do, h, d, d ** -0.5, None, False, 197)
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_flash_mha_grad_cpu_runs_no_kernel():
    kernels.reset_launches()
    _port_grad(*_inputs("s64_d64"), torch.float32)
    assert kernels.launches["flash_mha_fwd"] == 0
    assert kernels.launches["flash_mha_bwd"] == 0


def test_flash_mha_bwd_rejects_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: no plain
    fallback for a tensor that is not on the CPU."""
    qkv = torch.empty(2, 64, 3 * 2 * 64, device="meta")
    lse = torch.empty(2, 2, 64, 1, device="meta")
    do = torch.empty(2, 64, 2 * 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_mha_bwd(qkv, None, lse, do, 2, 64, 0.125, None, False, None)
