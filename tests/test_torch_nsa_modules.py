"""The standalone NSA branch modules (forde_tpu_torch/nn/nsa_modules.py)
and the composed NSA, mirroring the five tests of tests/test_nsa_modules.py
against the JAX package's modules on carried weights (``interop``):

* NativeSparseAttention (2 heads x 32, window 16, ratio 4, top-k 8) on
  (2, 64, 64): the shape, finite, and the output of JAX's
  ``impl="reference"`` module;
* TopKSelection: the output of JAX's module and the same indices, from
  its own importance scorer, from JAX's distinct provided scores
  (``arange(16)``: {15, 14, 13, 12}) and from a row of tied scores, where
  ``jax.lax.top_k`` takes the lower index first and so must the port;
* CompressedGlobalAttention: zeros for a context no longer than the
  compression ratio, JAX's output otherwise;
* a sequence no longer than the window gates the global branches off:
  the NSA output equals its local branch's.

Tolerance 1e-5 (atol = rtol): fp32 products summed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.nn import attention as jattn
from forde_tpu.nn import nsa_modules as jnsa
from forde_tpu_torch import interop
from forde_tpu_torch.nn.attention import NativeSparseAttention, SlidingWindowAttention
from forde_tpu_torch.nn.nsa_modules import CompressedGlobalAttention, TopKSelection, top_k_indices

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(module, params, without=()):
    """``module`` holding the Flax ``params``; ``without``: its parameters
    that the Flax module never made (Flax creates a layer at its first
    call: a TopKSelection given scores has no importance scorer)."""
    expected = {k: v for k, v in module.state_dict().items() if not k.startswith(without)}
    module.load_state_dict(interop.flax_to_state_dict(
        jax.device_get(params), {}, expected=expected), strict=not without)
    return module.eval()


def test_nsa_shapes_and_values():
    x = _x((2, 64, 64), 0)
    jmod = jattn.NativeSparseAttention(num_heads=2, head_dim=32, window_size=16,
                                       compression_ratio=4, top_k_global=8, impl="reference")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _carry(NativeSparseAttention(64, 2, 32, 16, 4, 8), variables["params"])
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_topk_selection_values_and_indices():
    x = _x((2, 32, 48), 1)
    jmod = jnsa.TopKSelection(num_heads=2, head_dim=24, top_k=8)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, want_idx = jmod.apply(variables, jnp.asarray(x))
    port = _carry(TopKSelection(48, 2, 24, top_k=8), variables["params"])
    with torch.no_grad():
        got, idx = port(torch.from_numpy(x))
    assert tuple(got.shape) == x.shape and tuple(idx.shape) == (2, 8)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scores", ["distinct", "tied"])
def test_topk_selection_with_provided_scores(scores):
    x = _x((2, 16, 32), 2)
    if scores == "distinct":
        s = np.tile(np.arange(16.0, dtype=np.float32), (2, 1))  # highest at the end
    else:
        s = np.stack([np.repeat(np.float32([3.0, 1.0, 2.0, 1.0]), 4),  # 4 runs of ties
                      np.float32([0, 1] * 8)])
    jmod = jnsa.TopKSelection(num_heads=2, head_dim=16, top_k=4)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(s))
    want, want_idx = jmod.apply(variables, jnp.asarray(x), jnp.asarray(s))
    port = _carry(TopKSelection(32, 2, 16, top_k=4), variables["params"],
                  without=("importance_scorer.",))
    with torch.no_grad():
        got, idx = port(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if scores == "distinct":
        assert set(idx.numpy()[0]) == {15, 14, 13, 12}
    else:
        np.testing.assert_array_equal(idx.numpy(), [[0, 1, 2, 3], [1, 3, 5, 7]])
    np.testing.assert_array_equal(top_k_indices(torch.from_numpy(s), 16).numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(s), 16)[1]))


def test_compressed_global_attention_short_context_zeros():
    x = _x((2, 32, 32), 3)
    jmod = jnsa.CompressedGlobalAttention(num_heads=2, head_dim=16, compression_ratio=8)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), 16)
    port = _carry(CompressedGlobalAttention(32, 2, 16, compression_ratio=8), variables["params"])
    with torch.no_grad():
        for start in (0, 4, 8):  # local_window_start <= ratio
            out = port(torch.from_numpy(x), start)
            assert torch.equal(out, torch.zeros_like(out))
        for start in (16, 20, 32):
            got = port(torch.from_numpy(x), start).numpy()
            want = np.asarray(jmod.apply(variables, jnp.asarray(x), start))
            assert np.abs(got).sum() > 0
            np.testing.assert_allclose(got, want, **TOL)


def test_nsa_short_sequence_gates_off_global_branches():
    x = _x((1, 16, 32), 4)
    jmod = jattn.NativeSparseAttention(num_heads=2, head_dim=16, window_size=32,
                                       compression_ratio=4, top_k_global=8, impl="reference")
    variables = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))
    port = _carry(NativeSparseAttention(32, 2, 16, 32, 4, 8), variables["params"])
    local = _carry(SlidingWindowAttention(32, 2, 16, 32), variables["params"]["local_attention"])
    with torch.no_grad():
        out = port(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), local(torch.from_numpy(x)).numpy(), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               **TOL)
