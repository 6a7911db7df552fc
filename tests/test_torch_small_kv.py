"""The port's NSA small-KV attention (forde_tpu_torch.ops.nsa_attention)
against the JAX package's ``small_kv_attention`` with
``impl="interpret"`` (its Pallas ``_fwd_kernel`` run in interpret mode),
mirroring tests/test_nsa_attention_kernel.py: ragged S, K and D, the
uniform distribution of a query that sees no key, and INVALID_KEY_POS
padding keys.

On the CPU the port runs the kernel's plain version. Inputs come from
numpy with a seed; fp32 within atol 2e-5 (fp32 products summed in other
orders; observed ~1e-7). bf16 within 2^-7 of the largest |out| per
element (both round the weights and the output to bf16, at different
summation orders). The CUDA kernel is held against the plain version on
the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.ops import nsa_attention as jnsa
from forde_tpu_torch import kernels
from forde_tpu_torch.ops import nsa_attention as nsa

torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(b=2, h=2, s=96, kk=24, d=32, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, h, kk, d).astype(np.float32)
    v = rng.randn(b, h, kk, d).astype(np.float32)
    key_pos = rng.randint(0, s, (b, kk)).astype(np.int32)
    return q, k, v, key_pos


def _jax(q, k, v, key_pos, dtype=jnp.float32, impl="interpret"):
    out = jnsa.small_kv_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(key_pos), impl=impl,
        block_q=32,
    )
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, key_pos, dtype=torch.float32, impl="auto"):
    out = nsa.small_kv_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), torch.from_numpy(key_pos),
        impl=impl,
    )
    return out.float().numpy()


SHAPES = {
    "pools_s96_k24_d32": dict(s=96, kk=24, d=32),
    "ragged_s100_k13_d48": dict(s=100, kk=13, d=48),
    "aligned_s64_k64_d64": dict(s=64, kk=64, d=64),
    "decode_s1_k40_d64": dict(s=1, kk=40, d=64),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_small_kv_matches_jax_interpret(shape):
    q, k, v, key_pos = _inputs(**SHAPES[shape])
    if SHAPES[shape]["s"] == 1:  # decode: thresholds shifted by -cur
        key_pos = key_pos - 20
    got = _port(q, k, v, key_pos)
    np.testing.assert_allclose(got, _jax(q, k, v, key_pos), atol=ATOL)
    np.testing.assert_allclose(_port(q, k, v, key_pos, impl="reference"),
                               _jax(q, k, v, key_pos, impl="reference"), atol=ATOL)


def test_small_kv_matches_jax_interpret_bf16():
    q, k, v, key_pos = _inputs(s=80, kk=20, d=64, seed=1)
    want = _jax(q, k, v, key_pos, jnp.bfloat16)
    got = _port(q, k, v, key_pos, torch.bfloat16)
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_uniform_quirk_excludes_padding():
    """Every key in the future: the uniform distribution over the real
    keys (-1e9 masking), and an INVALID_KEY_POS key outside it."""
    q, k, v, _ = _inputs(b=1, h=1, s=8, kk=3, d=32)
    key_pos = np.full((1, 3), 108, np.int32)
    want = np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 1, 8, 32))
    np.testing.assert_allclose(_port(q, k, v, key_pos), want, atol=1e-5)
    np.testing.assert_allclose(_jax(q, k, v, key_pos), want, atol=1e-5)
    key_pos[0, 2] = nsa.INVALID_KEY_POS
    want = np.broadcast_to(v[:, :, :2].mean(axis=2, keepdims=True), (1, 1, 8, 32))
    np.testing.assert_allclose(_port(q, k, v, key_pos), want, atol=1e-5)
    np.testing.assert_allclose(_jax(q, k, v, key_pos), want, atol=1e-5)


def test_invalid_keys_match_jax():
    q, k, v, key_pos = _inputs(s=64, kk=24, d=64, seed=2)
    key_pos[:, 16:] = nsa.INVALID_KEY_POS  # a row's pools past its length
    np.testing.assert_allclose(_port(q, k, v, key_pos), _jax(q, k, v, key_pos), atol=ATOL)


def test_small_kv_cpu_runs_no_kernel():
    kernels.reset_launches()
    _port(*_inputs())
    assert kernels.launches["small_kv_fwd"] == 0


def test_small_kv_fwd_rejects_other_devices():
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nsa.small_kv_fwd(q, q, q, torch.zeros(1, 8, dtype=torch.int32), 0.125)
