"""Explicit expert parallelism (forde_tpu_torch.parallel.expert_parallel)
against the JAX package's on 4 virtual devices, with 4 thread ranks.

* ``expert_parallel_ffn``, variants a2a, psum and auto, over (data 2,
  expert 2), and the psum variant over (expert 2, context 2): outputs and
  the gradients of x, the routing probabilities and the expert bank, at
  capacity factor 4 (no token drops) and 0.5 (drops, decided per source
  shard on both sides).
* ``expert_parallel_moe`` (router included): output, the global-batch aux
  loss and the gradients.
* Without drops every variant equals one process's capacity dispatch.

A value every expert rank holds alike (the tokens, the output) counts once
per rank in the ranks' summed loss, so each rank differentiates its sum
divided by the expert axis' size (parallel/collectives.py).

Tolerances: fp32 1e-5 for values, 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.ops import moe_dispatch as jmd
from forde_tpu.parallel import expert_parallel as jep
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.ops import moe_dispatch as tmd
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.parallel import expert_parallel as tep

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
B, S, D, H, E, K = 4, 8, 16, 32, 4, 2


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _bank(seed):
    return (_rand((E, D, H), seed, D ** -0.5), _rand((E, H), seed + 1, 0.1),
            _rand((E, H, D), seed + 2, H ** -0.5), _rand((E, D), seed + 3, 0.1))


def _routing(seed):
    logits = _rand((B, S, E), seed)
    idx, probs = jmd.top_k_gating(jnp.asarray(logits), K)
    return np.array(idx), np.array(probs)


def _jmesh(shape):
    return jmesh.create_mesh(devices=jax.devices()[:4], **{"data": 1, **shape})


CASES = [("a2a", dict(data=2, expert=2)), ("psum", dict(data=2, expert=2)),
         ("auto", dict(data=2, expert=2)), ("psum", dict(expert=2, context=2)),
         ("auto", dict(expert=2, context=2))]


def _ids(case):
    variant, shape = case
    return variant + "-" + "-".join(f"{k}{v}" for k, v in shape.items())


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_expert_parallel_ffn_matches_jax(case, capacity_factor):
    variant, shape = case
    x, w = _rand((B, S, D), 1), _rand((B, S, D), 2)
    idx, probs = _routing(3)
    bank = _bank(4)
    jm = _jmesh(shape)

    def jloss(x, probs, bank):
        o = jep.expert_parallel_ffn(x, jnp.asarray(idx), probs, bank, jm, num_experts=E,
                                    top_k=K, capacity_factor=capacity_factor, variant=variant)
        return jnp.sum(o * w), o

    (_, jo), (jgx, jgp, jgb) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(x, probs, bank)

    def rank(r, world):
        mesh = tmesh.Mesh(shape, r, world)
        tokens = tmesh.Sharding(mesh, ("data", "context"))
        experts = tmesh.expert_sharding(mesh)
        tx, tp = (torch.from_numpy(np.ascontiguousarray(tokens(a))).requires_grad_()
                  for a in (x, probs))
        tb = [torch.from_numpy(np.ascontiguousarray(experts(a))).requires_grad_() for a in bank]
        o = tep.expert_parallel_ffn(tx, torch.from_numpy(np.ascontiguousarray(tokens(idx))), tp,
                                    tuple(tb), mesh, num_experts=E, top_k=K,
                                    capacity_factor=capacity_factor, variant=variant)
        ep = mesh.shape["expert"]
        (torch.sum(o * torch.from_numpy(np.ascontiguousarray(tokens(w)))) / ep).backward()
        return mesh, o.detach(), tx.grad, tp.grad, [t.grad for t in tb]

    got = col.run_threads(4, rank)
    for mesh, o, gx, gp, gb in got:
        tokens = tmesh.Sharding(mesh, ("data", "context"))
        np.testing.assert_allclose(o.numpy(), tokens(np.asarray(jo)), **VAL)
        # x and the probabilities are held by both expert ranks: their sum
        twin = next(g for g in got if g[0] is not mesh and all(
            g[0].coords[a] == mesh.coords[a] for a in ("data", "context")))
        np.testing.assert_allclose((gx + twin[2]).numpy(), tokens(np.asarray(jgx)), **GRAD)
        np.testing.assert_allclose((gp + twin[3]).numpy(), tokens(np.asarray(jgp)), **GRAD)
    # an expert rank's slice of the bank: summed over the token ranks
    for e in range(2):
        mine = [g for g in got if g[0].coords["expert"] == e]
        experts = tmesh.expert_sharding(mine[0][0])
        for i, want in enumerate(jgb):
            total = sum(g[4][i] for g in mine)
            np.testing.assert_allclose(total.numpy(), experts(np.asarray(want)), **GRAD)


def test_without_drops_every_variant_equals_one_process_capacity_dispatch():
    x = _rand((B, S, D), 5)
    idx, probs = _routing(6)
    bank = [torch.from_numpy(a) for a in _bank(7)]
    tx = torch.from_numpy(x)
    capacity = max(int(E * B * S * K / E), K)
    plan = tmd.capacity_route(torch.from_numpy(idx).reshape(-1, K),
                              torch.from_numpy(probs).reshape(-1, K), E, capacity)
    want = tmd.capacity_combine(tep._experts(tmd.capacity_gather(tx.reshape(-1, D), plan),
                                             *bank), plan).reshape(B, S, D)
    for variant in ("a2a", "psum"):
        def rank(r, world, variant=variant):
            mesh = tmesh.Mesh(dict(data=2, expert=2), r, world)
            rows, experts = tmesh.batch_sharding(mesh), tmesh.expert_sharding(mesh)
            o = tep.expert_parallel_ffn(rows(tx), torch.from_numpy(rows(idx)),
                                        torch.from_numpy(rows(probs)),
                                        tuple(experts(t) for t in bank), mesh, num_experts=E,
                                        top_k=K, capacity_factor=float(E), variant=variant)
            return mesh, o

        for mesh, o in col.run_threads(4, rank):
            np.testing.assert_allclose(o.numpy(), tmesh.batch_sharding(mesh)(want.numpy()),
                                       **VAL)


def test_expert_parallel_moe_matches_jax():
    shape = dict(data=2, expert=2)
    x, w = _rand((B, S, D), 8), _rand((B, S, D), 9)
    w_up, b_up, w_down, b_down = _bank(10)
    params = {"router_kernel": _rand((D, E), 11, 0.5), "router_bias": _rand((E,), 12, 0.1),
              "w_up": w_up, "b_up": b_up, "w_down": w_down, "b_down": b_down}
    jm = _jmesh(shape)

    def jloss(x, params):
        o, aux = jep.expert_parallel_moe(x, params, jm, num_experts=E, top_k=K,
                                         capacity_factor=2.0)
        return jnp.sum(o * w) + 3.0 * aux, (o, aux)

    (_, (jo, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(x, params)

    def rank(r, world):
        mesh = tmesh.Mesh(shape, r, world)
        rows, experts = tmesh.batch_sharding(mesh), tmesh.expert_sharding(mesh)
        tx = torch.from_numpy(np.ascontiguousarray(rows(x))).requires_grad_()
        tp = {k: torch.from_numpy(np.ascontiguousarray(
            experts(v) if k.startswith(("w_", "b_")) else v)).requires_grad_()
            for k, v in params.items()}
        o, aux = tep.expert_parallel_moe(tx, tp, mesh, num_experts=E, top_k=K,
                                         capacity_factor=2.0)
        # o is held by both expert ranks, aux by all four
        loss = torch.sum(o * torch.from_numpy(np.ascontiguousarray(rows(w)))) / 2 + 3.0 * aux / 4
        loss.backward()
        return mesh, o.detach(), aux.detach(), tx.grad, {k: v.grad for k, v in tp.items()}

    got = col.run_threads(4, rank)
    for mesh, o, aux, _, _ in got:
        np.testing.assert_allclose(o.numpy(), tmesh.batch_sharding(mesh)(np.asarray(jo)), **VAL)
        np.testing.assert_allclose(float(aux), float(jaux), **VAL)
    router = sum(g[4]["router_kernel"] for g in got)
    np.testing.assert_allclose(router.numpy(), np.asarray(jgp["router_kernel"]), **GRAD)
    for e in range(2):
        mine = [g for g in got if g[0].coords["expert"] == e]
        total = sum(g[4]["w_up"] for g in mine)
        np.testing.assert_allclose(total.numpy(), tmesh.expert_sharding(mine[0][0])(
            np.asarray(jgp["w_up"])), **GRAD)
    for d in range(2):
        mine = [g for g in got if g[0].coords["data"] == d]
        np.testing.assert_allclose(sum(g[3] for g in mine).numpy(),
                                   tmesh.batch_sharding(mine[0][0])(np.asarray(jgx)), **GRAD)


def test_a2a_refusals():
    def rank(r, world):
        mesh = tmesh.Mesh(dict(expert=2, context=2), r, world)
        x = torch.zeros(1, 4, D)
        bank = tuple(torch.from_numpy(tmesh.expert_sharding(mesh)(a)) for a in _bank(1))
        with pytest.raises(ValueError, match="context parallelism"):
            tep.expert_parallel_ffn(x, torch.zeros(1, 4, K, dtype=torch.int64),
                                    torch.zeros(1, 4, K), bank, mesh, num_experts=E, top_k=K,
                                    variant="a2a")
        return True

    assert all(col.run_threads(4, rank))
