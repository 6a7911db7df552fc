"""``flash_attention_with_lse`` and ring attention
(forde_tpu_torch.parallel.ring_attention) against the JAX package.

* ``flash_attention_with_lse``: o, lse and the gradients of a loss that
  reads both (a nonzero lse cotangent, which the backward folds in as
  delta - dlse) against JAX's, whose Pallas kernels run in interpret mode
  (head_dim 64, S a multiple of 8), causal, windowed and full; S = 40 pads
  to the kernels' tile and cuts the padded rows away.
* Ring, zigzag and the non-causal ring on 4 thread ranks over (context 4)
  and (data 2, context 2) against JAX's ``ring_attention`` on 4 virtual
  devices: o, dq, dk and dv; and the flash calls of each rank (the ring n,
  the zigzag 3 + 2(n - 1), one dq and one dk/dv backward per forward),
  counted on the CPU by wrapping the kernels' wrappers.

Tolerances: fp32 1e-5 for values, 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.ops import flash_attention as jfa
from forde_tpu.parallel import ring_attention as jring
from forde_tpu_torch import kernels
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.ops import flash_attention as tfa
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.parallel import ring_attention as tring

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,causal,window", [(128, True, None), (128, True, 16),
                                             (64, False, None), (40, True, None),
                                             (40, False, None)])
def test_flash_attention_with_lse_matches_jax(s, causal, window):
    shape = (2, 2, s, 64)
    q, k, v = qkv(shape, s)
    rng = np.random.RandomState(1)
    wo = rng.randn(*shape).astype(np.float32)
    wl = rng.randn(2, 2, s, 1).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, window_size=window,
                                              impl="interpret")
        return jnp.sum(o * wo) + jnp.sum(lse * wl), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    for impl in ("auto", "reference"):
        tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal, window_size=window,
                                              impl=impl)
        assert lse.shape == (2, 2, s, 1) and lse.dtype == torch.float32
        (torch.sum(o * torch.from_numpy(wo)) + torch.sum(lse * torch.from_numpy(wl))).backward()
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **VAL)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **VAL)
        for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


def test_row_without_keys_keeps_lse_at_minus_1e30():
    """A query row that sees no key (a window of 0 here) keeps lse about
    -1e30, so it drops out of any merge."""
    q, k, v = (torch.from_numpy(t) for t in qkv((1, 1, 64, 64), 3))
    _, lse = tfa.flash_attention_with_lse(q, k, v, causal=True, window_size=0)
    assert float(lse.max()) < -1e29


def _count_calls(monkeypatch):
    """Wrap the 4-D kernels' wrappers so that a CPU call counts as a
    launch (the plain versions launch nothing)."""
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        inner = getattr(tfa, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            kernels.count(_name)
            return _inner(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)


MESHES = {"context4": dict(context=4), "data2-context2": dict(data=2, context=2)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("schedule,causal", [("ring", True), ("zigzag", True), ("ring", False),
                                             ("auto", True)])
def test_ring_attention_matches_jax(mesh_name, schedule, causal, monkeypatch):
    shape = MESHES[mesh_name]
    b, h, s, d = 2, 2, 128, 32
    q, k, v = qkv((b, h, s, d), 7)
    w = np.random.RandomState(8).randn(b, h, s, d).astype(np.float32)
    jm = jmesh.create_mesh(devices=jax.devices()[:4], **{"data": 1, **shape})

    def jloss(q, k, v):
        o = jring.ring_attention(q, k, v, jm, causal=causal, schedule=schedule)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(t) for t in (q, k, v)))
    _count_calls(monkeypatch)

    def rank_fn(rank, world):
        mesh = tmesh.Mesh(shape, rank, world)
        split = tmesh.Sharding(mesh, ("data", None, "context", None))
        tq, tk, tv = (torch.from_numpy(split(t).copy()).requires_grad_() for t in (q, k, v))
        with kernels.thread_launches() as launches:
            o = tring.ring_attention(tq, tk, tv, mesh, causal=causal, schedule=schedule)
            torch.sum(o * torch.from_numpy(split(w).copy())).backward()
        return o.detach(), tq.grad, tk.grad, tv.grad, dict(launches)

    got = col.run_threads(4, rank_fn)
    meshes = [tmesh.Mesh(shape, r, col.ThreadWorld(4)) for r in range(4)]
    for r, (o, dq, dk, dv, launches) in enumerate(got):
        split = tmesh.Sharding(meshes[r], ("data", None, "context", None))
        np.testing.assert_allclose(o.numpy(), split(np.asarray(jo)), **VAL)
        for g, want in zip((dq, dk, dv), jg):
            np.testing.assert_allclose(g.numpy(), split(np.asarray(want)), **GRAD)
        n = meshes[r].shape["context"]
        zigzag = schedule == "zigzag" or (schedule == "auto" and causal)
        calls = 3 + 2 * (n - 1) if zigzag else n
        assert launches == {"flash_fwd": calls, "flash_bwd_dq": calls,
                            "flash_bwd_dkv": calls}, launches


def test_zigzag_is_causal_only():
    world = col.ThreadWorld(1)
    mesh = tmesh.Mesh({}, 0, world)
    q = torch.zeros(1, 1, 32, 32)
    with pytest.raises(ValueError, match="causal-only"):
        tring.ring_attention(q, q, q, mesh, causal=False, schedule="zigzag")


def test_killed_future_blocks_get_exactly_zero_gradient():
    """Under the causal ring, rank 0's queries see only rank 0's keys: the
    keys of ranks 1-3 get exactly zero gradient from rank 0's loss."""
    q, k, v = qkv((1, 1, 64, 32), 9)

    def rank_fn(rank, world):
        mesh = tmesh.Mesh({"context": 4}, rank, world)
        split = tmesh.Sharding(mesh, (None, None, "context", None))
        tq, tk, tv = (torch.from_numpy(split(t).copy()).requires_grad_() for t in (q, k, v))
        o = tring.ring_attention(tq, tk, tv, mesh, causal=True, schedule="ring")
        (o.sum() * (rank == 0)).backward()
        return tk.grad, tv.grad

    got = col.run_threads(4, rank_fn)
    assert float(got[0][0].abs().sum()) > 0
    for dk, dv in got[1:]:
        assert torch.equal(dk, torch.zeros_like(dk)) and torch.equal(dv, torch.zeros_like(dv))
