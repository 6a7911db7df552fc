"""The port's training-side StatefulLayer ops against the JAX package's
custom_vjps: the straight-through multiplex gradient, the gradient-stat
tap (``grad_stat_tap``), ``activation_stats`` and ``hoyer_sparsity``.

Inputs come from numpy with a seed; the JAX moment sums run their Pallas
kernel in interpret mode (``FORDE_MOMENT_IMPL=interpret``), the port's
their plain version. The multiplex and its gradient are elementwise with
the same operations on both sides: exact on the relu and binary-step
neurons; on the tanh neurons XLA's tanh and torch's differ in the last
bit, so those are held at 1e-6. The statistics are fp32 sums in other
orders: 1e-6 relative, 1e-6 absolute where a value is near 0 (gini of a
column whose terms nearly cancel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.brain.sensing import hoyer_sparsity as jax_hoyer
from forde_tpu.nn.stateful import activation_stats as jax_activation_stats
from forde_tpu.ops.stateful import grad_stat_tap as jax_grad_stat_tap
from forde_tpu.ops.stateful import stateful_multiplex as jax_multiplex
from forde_tpu_torch.brain.sensing import hoyer_sparsity
from forde_tpu_torch.nn.stateful import StatefulLayer, activation_stats, stateful_layers
from forde_tpu_torch.ops.stateful import grad_stat_tap, stateful_multiplex

torch.set_num_threads(1)

F = 96
TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def _data(seed=0, shape=(3, 11, F)):
    rng = np.random.RandomState(seed)
    z = rng.randn(*shape).astype(np.float32)
    z[0, 0, :4] = 0.0  # z == 0 exercises relu' and the binary step at 0
    g = rng.randn(*shape).astype(np.float32)
    a = rng.randint(0, 3, shape[-1]).astype(np.int32)
    return z, g, a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiplex_forward_and_straight_through_grad_exact(dtype):
    z, g, a = _data()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda v: jax_multiplex(v, jnp.asarray(a), 0.1), jnp.asarray(z, jdt))
    (dz,) = vjp(jnp.asarray(g, jdt))
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    ot = stateful_multiplex(zt, torch.from_numpy(a), 0.1)
    ot.backward(torch.from_numpy(g).to(tdt))
    assert ot.dtype == tdt and zt.grad.dtype == tdt
    tanh = a == 1
    for got, want in (
        (ot.detach().float().numpy(), np.asarray(out.astype(jnp.float32))),
        (zt.grad.float().numpy(), np.asarray(dz.astype(jnp.float32))),
    ):
        np.testing.assert_array_equal(got[..., ~tanh], want[..., ~tanh])
        np.testing.assert_allclose(got[..., tanh], want[..., tanh], **TOL)


def test_specialist_grad_is_straight_through_plus_gate():
    z = torch.tensor([[-2.0, 0.0, 3.0]], requires_grad=True)
    stateful_multiplex(z, torch.tensor([2, 2, 2]), 0.1).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), [[1.1, 1.1, 1.1]], rtol=1e-6)


def test_grad_stat_tap_matches_jax():
    z, g, _ = _data(seed=1)

    def f(v, slot):
        return jax_grad_stat_tap(v, slot)

    out, vjp = jax.vjp(f, jnp.asarray(z), jnp.zeros((F, 2), jnp.float32))
    dz, dslot = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    slot = torch.zeros(F, 2, requires_grad=True)
    ot = grad_stat_tap(zt, slot)
    ot.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ot.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(zt.grad.numpy(), np.asarray(dz))
    np.testing.assert_allclose(slot.grad.numpy(), np.asarray(dslot), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_stats_match_jax(dtype):
    z, _, _ = _data(seed=2)
    want = np.asarray(jax_activation_stats(jnp.asarray(z, getattr(jnp, dtype))))
    got = activation_stats(torch.from_numpy(z).to(getattr(torch, dtype))).numpy()
    assert got.shape == (F, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_activation_gini_is_hoyer_sparsity():
    z, _, _ = _data(seed=3)
    zt = torch.from_numpy(z)
    want = hoyer_sparsity(zt.reshape(-1, F), dim=0)
    torch.testing.assert_close(activation_stats(zt)[:, 0], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 5), (1, 4), (6, 1)])
def test_hoyer_sparsity_matches_jax(shape):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    x[0] = 0.0  # an all-zero row gives 0
    np.testing.assert_allclose(
        hoyer_sparsity(torch.from_numpy(x)).numpy(), np.asarray(jax_hoyer(jnp.asarray(x))), **TOL
    )


def test_sensing_is_chosen_per_call():
    """One layer, one state: an unsensed call leaves act_stats and
    step_count as they are; a sensed call adds one step; the tap slot's
    gradient is the step's gradient statistics."""
    torch.manual_seed(0)
    layer = StatefulLayer(F, 32, sense=True)
    x = torch.randn(2, 5, 32)
    layer(x)
    assert layer.step_count.item() == 0 and layer.act_stats.abs().sum() == 0
    layer.z_tap = torch.zeros(F, 2, requires_grad=True)
    layer(x, sense=True).sum().backward()
    assert layer.step_count.item() == 1
    z = layer.w_in(x)
    torch.testing.assert_close(layer.act_stats, activation_stats(z))
    assert layer.z_tap.grad is not None and layer.z_tap.grad.abs().sum() > 0
    assert list(stateful_layers(torch.nn.ModuleDict({"b": layer, "a": StatefulLayer(4, 4)}))) == ["a", "b"]
