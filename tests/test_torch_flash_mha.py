"""The port's fused-qkv attention (forde_tpu_torch.ops.flash_attention)
against the JAX package's ``flash_mha``: the Pallas kernel run in
interpret mode, and the plain reference path.

On the CPU the port's ``flash_mha`` runs its kernel's plain version
(``flash_mha_fwd_reference``). Inputs come from numpy with a seed; the
comparison is fp32 with atol = rtol = 1e-5 (both sides sum fp32 products
in different orders; observed differences are ~1e-7).
The CUDA kernel itself is held against its plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forde_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, H, D, kv_lens, causal, window)
CASES = {
    "s64_d64": (2, 64, 2, 64, None, False, None),
    "s200_d128": (2, 200, 2, 128, None, False, None),
    "s197_d64_kv_bound": (3, 197, 2, 64, None, False, None),
    "s197_d128_kv_bound": (2, 197, 2, 128, None, False, None),
    "s64_d128_lens_0_1_S": (4, 64, 2, 128, [0, 1, 17, 64], False, None),
    "s200_d64_lens": (3, 200, 2, 64, [200, 0, 1], False, None),
    "s128_d64_causal_window32": (2, 128, 2, 64, None, True, 32),
    "s197_d128_causal_window32_lens": (3, 197, 2, 128, [197, 0, 1], True, 32),
}


def _inputs(case, seed=0):
    b, s, h, d, lens, causal, window = CASES[case]
    x = (np.random.RandomState(seed).randn(b, s, 3 * h * d) * 0.5).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return x, lens, h, d, causal, window


def _jax(x, lens, h, d, causal, window, impl):
    out = jax_flash_mha(
        jnp.asarray(x), h, d, causal=causal, window_size=window,
        kv_lens=None if lens is None else jnp.asarray(lens), impl=impl,
    )
    return np.asarray(out)


def _port(x, lens, h, d, causal, window, impl="auto"):
    out = fa.flash_mha(
        torch.from_numpy(x), h, d, causal=causal, window_size=window,
        kv_lens=None if lens is None else torch.from_numpy(lens), impl=impl,
    )
    return out.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_mha_matches_jax_kernel(case):
    """Port (kernel's plain version on CPU) vs the Pallas kernel."""
    x, lens, h, d, causal, window = _inputs(case)
    want = _jax(x, lens, h, d, causal, window, "interpret")
    got = _port(x, lens, h, d, causal, window)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if lens is not None:
        for b in np.flatnonzero(lens == 0):
            assert np.abs(got[b]).max() == 0.0  # kv_lens == 0 rows are zero


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_mha_reference_matches_jax_reference(case):
    x, lens, h, d, causal, window = _inputs(case, seed=1)
    want = _jax(x, lens, h, d, causal, window, "reference")
    got = _port(x, lens, h, d, causal, window, impl="reference")
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_mha_fwd_lse_matches_plain_softmax():
    """lse of the kernel's plain version is the row log-sum-exp of the
    visible scores, -1e30 for rows with no visible key."""
    x, lens, h, d, _, _ = _inputs("s64_d128_lens_0_1_S", seed=2)
    qkv = torch.from_numpy(x)
    o, lse = fa.flash_mha_fwd(
        qkv, torch.from_numpy(lens), h, d, d ** -0.5, None, False, None
    )
    b, s, _ = x.shape
    q, k, _ = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) * d ** -0.5
    assert lse.shape == (b, h, s, 1) and lse.dtype == torch.float32
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(lse[i] == fa.MASK_VALUE)
        else:
            want = torch.logsumexp(scores[i, :, :, :n], dim=-1, keepdim=True)
            torch.testing.assert_close(lse[i], want, atol=1e-5, rtol=1e-5)


def test_flash_mha_cpu_runs_no_kernel():
    kernels.reset_launches()
    x, lens, h, d, causal, window = _inputs("s64_d64")
    _port(x, lens, h, d, causal, window)
    assert kernels.launches["flash_mha_fwd"] == 0


def test_flash_mha_outside_fused_shapes_on_cpu_is_reference():
    """head_dim % 64 != 0 takes the plain path of the 4-D kernels on CPU,
    as the JAX package does off the TPU."""
    x = (np.random.RandomState(3).randn(2, 40, 3 * 2 * 32) * 0.5).astype(np.float32)
    want = _jax(x, None, 2, 32, True, None, "reference")
    got = _port(x, None, 2, 32, True, None)
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_mha_fwd_rejects_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: no plain
    fallback for a tensor that is not on the CPU."""
    qkv = torch.empty(2, 64, 3 * 2 * 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_mha_fwd(qkv, None, 2, 64, 0.125, None, False, None)
