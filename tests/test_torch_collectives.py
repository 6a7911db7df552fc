"""The port's collectives (forde_tpu_torch.parallel.collectives) against
``jax.lax``'s inside ``jax.shard_map`` on 4 of the 8 virtual CPU devices:
values, and gradients against ``jax.grad`` of the global function, on the
thread transport and on 4 gloo processes (``torch.distributed``).

Gradient convention: each rank differentiates its own scalar and the
ranks' scalars add up to the loss. A sharded output (out_specs over the
axis) gives rank r the scalar sum(out_r * w_r); a replicated one
(out_specs P(), a psum or pmean) gives every rank sum(out * w) / n. Under
that convention every collective's backward is its transpose, and the
gradients equal ``jax.grad`` of the global loss.

Tolerance: fp32, 1e-6 (sums of 4 terms in another order).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from forde_tpu_torch.core import mesh as mesh_lib
from forde_tpu_torch.parallel import collectives as col

N = 4
TOL = dict(rtol=1e-6, atol=1e-6)
RING = [(i, (i + 1) % N) for i in range(N)]


def jmesh():
    return JMesh(np.array(jax.devices()[:N]), ("data",))


def inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


# Each case: (JAX body, out_specs sharded?, port body, global x shape, w shape)
def _cases():
    return {
        "ppermute": (lambda x: jax.lax.ppermute(x * x, "data", RING) * 3.0, True,
                     lambda x, g: col.ppermute(x * x, g, RING) * 3.0, (8, 3), (8, 3)),
        "all_gather": (
            lambda x: jax.lax.all_gather(x, "data", tiled=True)
            * (jax.lax.axis_index("data") + 1.0), True,
            lambda x, g: col.all_gather(x, g) * (col.axis_index(g) + 1.0), (8, 3), (32, 3)),
        "psum": (lambda x: jax.lax.psum(x * x, "data"), False,
                 lambda x, g: col.psum(x * x, g), (8, 3), (2, 3)),
        "pmean": (lambda x: jax.lax.pmean(jnp.sin(x), "data"), False,
                  lambda x, g: col.pmean(torch.sin(x), g), (8, 3), (2, 3)),
        "all_to_all": (
            lambda x: jax.lax.all_to_all(x * (jax.lax.axis_index("data") + 1.0), "data", 0, 0),
            True,
            lambda x, g: col.all_to_all(x * (col.axis_index(g) + 1.0), g, 0, 0), (16, 3),
            (16, 3)),
        "all_to_all_axes": (
            lambda x: jax.lax.all_to_all(x * x, "data", 1, 0, tiled=True), True,
            lambda x, g: col.all_to_all(x * x, g, 1, 0), (8, 8), (32, 2)),
        "psum_scatter": (
            lambda x: jax.lax.psum_scatter(x * x, "data", scatter_dimension=0, tiled=True),
            True, lambda x, g: col.psum_scatter(x * x, g, 0), (32, 3), (8, 3)),
    }


def jax_result(name, x, w):
    body, sharded, _, _, _ = _cases()[name]
    f = jax.shard_map(body, mesh=jmesh(), in_specs=P("data"),
                      out_specs=P("data") if sharded else P())
    out = f(jnp.asarray(x))
    grad = jax.grad(lambda x: jnp.sum(f(x) * w))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


def port_rank(name, rank, world, x, w):
    _, sharded, body, _, _ = _cases()[name]
    mesh = mesh_lib.create_mesh(data=N, rank=rank, world=world)
    g = mesh.group("data")
    xr = torch.from_numpy(mesh_lib.batch_sharding(mesh)(x).copy()).requires_grad_()
    out = body(xr, g)
    if sharded:
        loss = torch.sum(out * torch.from_numpy(mesh_lib.batch_sharding(mesh)(w).copy()))
    else:
        loss = torch.sum(out * torch.from_numpy(w)) / N
    loss.backward()
    return out.detach().numpy(), xr.grad.numpy()


@pytest.mark.parametrize("name", list(_cases()))
def test_collective_on_threads_matches_shard_map(name):
    shape, wshape = _cases()[name][3:]
    x, _ = inputs(1, shape)
    w = np.random.RandomState(2).randn(*wshape).astype(np.float32)
    want_out, want_grad = jax_result(name, x, w)
    got = col.run_threads(N, lambda r, world: port_rank(name, r, world, x, w))
    sharded = _cases()[name][1]
    out = np.concatenate([o for o, _ in got]) if sharded else got[0][0]
    np.testing.assert_allclose(out, want_out, **TOL)
    if not sharded:  # every rank holds the same bits
        for o, _ in got[1:]:
            np.testing.assert_array_equal(o, got[0][0])
    np.testing.assert_allclose(np.concatenate([g for _, g in got]), want_grad, **TOL)


def test_megatron_operators_match_shard_map():
    """A column-parallel then row-parallel pair, tanh(x W) V, with x
    replicated and W's columns / V's rows split over the group:
    ``copy_to_model`` at the input and ``reduce_from_model`` at the output
    against ``jax.grad`` through ``shard_map`` (x P(), W P(None, data), V
    P(data, None), out P()). Every rank holds the same share of x's
    cotangent, and the shares add up to JAX's."""
    rng = np.random.RandomState(5)
    x, wc, wr = (rng.randn(*s).astype(np.float32) for s in ((6, 5), (5, 8), (8, 3)))
    w = rng.randn(6, 3).astype(np.float32)
    f = jax.shard_map(lambda x, a, b: jax.lax.psum(jnp.tanh(x @ a) @ b, "data"), mesh=jmesh(),
                      in_specs=(P(), P(None, "data"), P("data", None)), out_specs=P())
    want_out = f(x, wc, wr)
    want = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(x, wc, wr)

    def rank(r, world):
        g = mesh_lib.create_mesh(data=N, rank=r, world=world).group("data")
        cols = slice(2 * r, 2 * r + 2)
        xt = torch.from_numpy(x.copy()).requires_grad_()
        a = torch.from_numpy(wc[:, cols].copy()).requires_grad_()
        b = torch.from_numpy(wr[cols].copy()).requires_grad_()
        out = col.reduce_from_model(torch.tanh(col.copy_to_model(xt, g) @ a) @ b, g)
        (torch.sum(out * torch.from_numpy(w)) / N).backward()
        return out.detach().numpy(), xt.grad.numpy(), a.grad.numpy(), b.grad.numpy()

    got = col.run_threads(N, rank)
    for out, gx, _, _ in got:
        np.testing.assert_allclose(out, np.asarray(want_out), **TOL)
        np.testing.assert_array_equal(gx, got[0][1])
    np.testing.assert_allclose(sum(g[1] for g in got), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(np.concatenate([g[2] for g in got], 1), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(np.concatenate([g[3] for g in got]), np.asarray(want[2]), **TOL)


def test_axis_index_and_size():
    def rank_fn(r, world):
        mesh = mesh_lib.create_mesh(data=2, context=2, rank=r, world=world)
        g = mesh.group("context")
        return col.axis_index(g), col.axis_size(g), mesh.group("data").ranks

    got = col.run_threads(N, rank_fn)
    assert [g[:2] for g in got] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    assert [g[2] for g in got] == [(0, 2), (1, 3), (0, 2), (1, 3)]


def test_a_failing_rank_breaks_the_barrier():
    """A rank that raises does not leave the others waiting forever."""
    def rank_fn(r, world):
        g = mesh_lib.create_mesh(data=N, rank=r, world=world).group("data")
        if r == 2:
            raise RuntimeError("rank 2 failed")
        return g.all_reduce(torch.ones(1))

    with pytest.raises(RuntimeError, match="rank 2 failed"):
        col.run_threads(N, rank_fn)


# ---------------------------------------------------------------------------
# 4 gloo processes (torch.distributed)
# ---------------------------------------------------------------------------

# The ranks import only torch, numpy and the port.
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from forde_tpu_torch.core import mesh as mesh_lib
    from forde_tpu_torch.parallel import collectives as col

    rank, n, init, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n)
    mesh = mesh_lib.create_mesh(data=n)
    g = mesh.group("data")
    ring = [(i, (i + 1) % n) for i in range(n)]
    cases = json.load(open(out_dir + "/cases.json"))
    result = {}
    for name, (x, w, sharded) in cases.items():
        x, w = np.asarray(x, np.float32), np.asarray(w, np.float32)
        xr = torch.from_numpy(mesh_lib.batch_sharding(mesh)(x).copy()).requires_grad_()
        if name == "ppermute":
            out = col.ppermute(xr * xr, g, ring) * 3.0
        elif name == "all_gather":
            out = col.all_gather(xr, g) * (col.axis_index(g) + 1.0)
        elif name == "psum":
            out = col.psum(xr * xr, g)
        elif name == "pmean":
            out = col.pmean(torch.sin(xr), g)
        elif name == "all_to_all":
            out = col.all_to_all(xr * (col.axis_index(g) + 1.0), g, 0, 0)
        elif name == "psum_scatter":
            out = col.psum_scatter(xr * xr, g, 0)
        else:
            out = col.all_to_all(xr * xr, g, 1, 0)
        if sharded:
            loss = torch.sum(out * torch.from_numpy(mesh_lib.batch_sharding(mesh)(w).copy()))
        else:
            loss = torch.sum(out * torch.from_numpy(w)) / n
        loss.backward()
        result[name] = [out.detach().tolist(), xr.grad.tolist()]
    json.dump(result, open(f"{out_dir}/rank{rank}.json", "w"))
    dist.destroy_process_group()
""")


def test_collectives_on_gloo_processes_match_shard_map(tmp_path):
    cases, want = {}, {}
    for i, (name, case) in enumerate(_cases().items()):
        x, _ = inputs(10 + i, case[3])
        w = np.random.RandomState(20 + i).randn(*case[4]).astype(np.float32)
        cases[name] = (x.tolist(), w.tolist(), case[1])
        want[name] = jax_result(name, x, w)
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    (tmp_path / "worker.py").write_text(WORKER)
    init = f"file://{tmp_path}/rendezvous"
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"), str(r), str(N), init,
                               str(tmp_path)], env=env) for r in range(N)]
    assert [p.wait(timeout=120) for p in procs] == [0] * N
    got = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(N)]
    for name, (want_out, want_grad) in want.items():
        sharded = cases[name][2]
        outs = [np.asarray(g[name][0], np.float32) for g in got]
        out = np.concatenate(outs) if sharded else outs[0]
        np.testing.assert_allclose(out, want_out, **TOL, err_msg=name)
        grads = np.concatenate([np.asarray(g[name][1], np.float32) for g in got])
        np.testing.assert_allclose(grads, want_grad, **TOL, err_msg=name)
