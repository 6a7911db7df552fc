"""NSA under context parallelism (forde_tpu_torch.parallel.nsa_context
and the context-parallel branches of nn.attention.NativeSparseAttention)
against the JAX package on 4 virtual devices, with 4 thread ranks over
(context 4) and (data 2, context 2).

* ``window_attention_cp`` (the halo corner merged by log-sum-exp) and
  ``small_kv_attention_cp`` (key positions shifted by -rank * S_local):
  values and the gradients of q, k, v.
* ``gather_pool_means_cp`` and ``topk_select_cp``: exactly the unsharded
  pool means and rows, and their gradients.
* The NSA module (window 16, ratio 4, top-k 16, S = 128) carrying JAX's
  weights: output, the gradient of its input and the summed gradients of
  its parameters.

Tolerances: fp32 1e-5 for values, 1e-4 for gradients. JAX's flash and
small-KV calls take their reference path on the CPU; the port's take its
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.nn import attention as jattn
from forde_tpu.parallel import nsa_context as jcp
from forde_tpu_torch import interop
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.nn.attention import NativeSparseAttention
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.parallel import nsa_context as tcp

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
MESHES = {"context4": dict(context=4), "data2-context2": dict(data=2, context=2)}
B, H, S, D, W = 2, 2, 128, 32, 16


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jmesh(shape):
    return jmesh.create_mesh(devices=jax.devices()[:4], **{"data": 1, **shape})


def _run(shape, fn):
    return col.run_threads(4, lambda r, world: fn(tmesh.Mesh(shape, r, world)))


def _split4(mesh):
    return tmesh.Sharding(mesh, ("data", None, "context", None))


def _local(split, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(split(a))).requires_grad_() for a in arrays]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("window", [W, 33])
def test_window_attention_cp_matches_jax(mesh_name, window):
    shape = MESHES[mesh_name]
    q, k, v, w = (_rand((B, H, S, D), i) for i in range(4))
    jm = _jmesh(shape)

    def jloss(q, k, v):
        o = jcp.window_attention_cp(q, k, v, jm, window)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    def rank(mesh):
        split = _split4(mesh)
        tq, tk, tv = _local(split, q, k, v)
        o = tcp.window_attention_cp(tq, tk, tv, mesh, window)
        torch.sum(o * torch.from_numpy(np.ascontiguousarray(split(w)))).backward()
        return split, o.detach(), (tq.grad, tk.grad, tv.grad)

    for split, o, grads in _run(shape, rank):
        np.testing.assert_allclose(o.numpy(), split(np.asarray(jo)), **VAL)
        for g, want in zip(grads, jg):
            np.testing.assert_allclose(g.numpy(), split(np.asarray(want)), **GRAD)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_small_kv_attention_cp_matches_jax(mesh_name):
    shape = MESHES[mesh_name]
    kk = 16
    q, w = _rand((B, H, S, D), 1), _rand((B, H, S, D), 2)
    k, v = _rand((B, H, kk, D), 3), _rand((B, H, kk, D), 4)
    key_pos = np.random.RandomState(5).randint(0, S, (B, kk)).astype(np.int32)
    jm = _jmesh(shape)

    def jloss(q, k, v):
        o = jcp.small_kv_attention_cp(q, k, v, jnp.asarray(key_pos), jm)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)

    def rank(mesh):
        split = _split4(mesh)
        rows = tmesh.Sharding(mesh, ("data",))
        (tq,) = _local(split, q)
        tk, tv = _local(rows, k, v)
        pos = torch.from_numpy(np.ascontiguousarray(rows(key_pos)))
        o = tcp.small_kv_attention_cp(tq, tk, tv, pos, mesh)
        torch.sum(o * torch.from_numpy(np.ascontiguousarray(split(w)))).backward()
        return split, rows, o.detach(), tq.grad, tk.grad, tv.grad

    got = _run(shape, rank)
    for split, rows, o, dq, _, _ in got:
        np.testing.assert_allclose(o.numpy(), split(np.asarray(jo)), **VAL)
        np.testing.assert_allclose(dq.numpy(), split(np.asarray(jg[0])), **GRAD)
    # every context rank holds k and v: their gradient is the ranks' sum
    n_data = shape.get("data", 1)
    for i, want in ((4, jg[1]), (5, jg[2])):
        per_data = [sum(g[i] for g in got if g[0].mesh.coords["data"] == c)
                    for c in range(n_data)]
        np.testing.assert_allclose(torch.cat(per_data).numpy(), np.asarray(want), **GRAD)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_gather_pool_means_and_topk_select_are_exact(mesh_name):
    shape = MESHES[mesh_name]
    x = _rand((B, S, 64), 6)
    num_pools, ratio = (S - W) // 4, 4
    idx = np.stack([np.random.RandomState(7 + b).permutation(S)[:16] for b in range(B)])
    jm = _jmesh(shape)
    want_pools = np.asarray(jcp.gather_pool_means_cp(jnp.asarray(x), jm, ratio, num_pools))
    want_rows = np.asarray(jcp.topk_select_cp(jnp.asarray(x), jnp.asarray(idx), jm))
    wp, wr = _rand(want_pools.shape, 8), _rand(want_rows.shape, 9)

    def rank(mesh):
        tokens = tmesh.Sharding(mesh, ("data", "context"))
        rows = tmesh.Sharding(mesh, ("data",))
        (tx,) = _local(tokens, x)
        pools = tcp.gather_pool_means_cp(tx, mesh, ratio, num_pools)
        sel = tcp.topk_select_cp(tx, torch.from_numpy(rows(idx).copy()), mesh)
        # each context rank holds the same pools and rows: each adds its
        # share of the loss (the gradient convention of the collectives)
        n = mesh.shape["context"]
        loss = (torch.sum(pools * torch.from_numpy(rows(wp).copy()))
                + torch.sum(sel * torch.from_numpy(rows(wr).copy()))) / n
        loss.backward()
        return tokens, rows, pools.detach(), sel.detach(), tx.grad

    pooled_ref = x[:, :num_pools * ratio].reshape(B, num_pools, ratio, 64).mean(axis=2)
    grad_ref = np.zeros_like(x)
    for b in range(B):
        for p in range(num_pools):
            grad_ref[b, p * ratio:(p + 1) * ratio] += wp[b, p] / ratio
        for j, i in enumerate(idx[b]):
            grad_ref[b, i] += wr[b, j]
    for tokens, rows, pools, sel, grad in _run(shape, rank):
        np.testing.assert_allclose(pools.numpy(), rows(want_pools), **VAL)
        np.testing.assert_allclose(pools.numpy(), rows(pooled_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(sel.numpy(), rows(want_rows))
        np.testing.assert_array_equal(sel.numpy(), rows(np.take_along_axis(
            x, idx[..., None], axis=1)))
        np.testing.assert_allclose(grad.numpy(), tokens(grad_ref), **GRAD)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_nsa_module_under_context_parallelism_matches_jax(mesh_name):
    shape = MESHES[mesh_name]
    d_model = 64
    x, w = _rand((B, S, d_model), 10), _rand((B, S, d_model), 11)
    jm = _jmesh(shape)
    jmod = jattn.NativeSparseAttention(num_heads=2, head_dim=32, window_size=W,
                                       compression_ratio=4, top_k_global=16, mesh=jm)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(params, x):
        o = jmod.apply({"params": params}, x)
        return jnp.sum(o * w), o

    (_, jo), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    jgp = interop.flatten(jax.device_get(jgp))
    host = jax.device_get(params)

    def rank(mesh):
        module = NativeSparseAttention(d_model, 2, 32, W, 4, 16, mesh=mesh)
        module.load_state_dict(interop.flax_to_state_dict(host, {},
                                                          expected=module.state_dict()))
        tokens = tmesh.Sharding(mesh, ("data", "context"))
        (tx,) = _local(tokens, x)
        o = module(tx)
        torch.sum(o * torch.from_numpy(np.ascontiguousarray(tokens(w)))).backward()
        grads = {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}
        return tokens, o.detach(), tx.grad, grads, module

    got = _run(shape, rank)
    for tokens, o, gx, _, _ in got:
        np.testing.assert_allclose(o.numpy(), tokens(np.asarray(jo)), **VAL)
        np.testing.assert_allclose(gx.numpy(), tokens(np.asarray(jgx)), **GRAD)
    summed = {}
    for _, _, _, grads, _ in got:
        for n, g in grads.items():
            summed[n] = summed.get(n, 0) + g
    flat = interop.flatten(interop.state_dict_to_flax(summed)["params"])
    for key, want in jgp.items():
        if key.startswith("importance_scorer"):
            continue  # picks indices only: no gradient on either side
        top = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(flat[key], np.asarray(want), rtol=1e-4, atol=1e-4 * max(top, 1),
                                   err_msg=key)
