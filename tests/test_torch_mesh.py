"""The port's mesh (forde_tpu_torch.core.mesh) against the JAX package's
(forde_tpu.core.mesh) on the 8 virtual CPU devices: rank coordinates in
JAX's device order, the blocks the slicing helpers give each rank against
the shards of JAX's NamedShardings, ``create_mesh_for_batch``'s data axis,
the expert rule, and the torchrun environment handling."""

import os
import socket
import warnings

import jax
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.parallel.collectives import ThreadWorld

SHAPES = [dict(data=2, context=2), dict(data=2, expert=2), dict(expert=2, context=2),
          dict(data=4), dict(data=2, expert=2, context=2)]


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.create_mesh(devices=jax.devices()[:n], **{"data": 1, **shape})


def _port_meshes(shape):
    n = int(np.prod(list(shape.values())))
    world = ThreadWorld(n)
    return [tmesh.Mesh(shape, r, world) for r in range(n)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_rank_coordinates_follow_jax_device_order(shape):
    jm = _jax_mesh(shape)
    devices = list(jm.devices.flat)
    for rank, m in enumerate(_port_meshes(shape)):
        where = np.argwhere(jm.devices == devices[rank])[0]
        assert tuple(m.coords[a] for a in jmesh.ALL_AXES) == tuple(where)
        assert m.shape == dict(jm.shape)
        for axes in (("data",), ("context",), ("expert",), ("data", "context")):
            ranks = m.ranks_along(axes)
            assert m.rank in ranks and len(ranks) == int(np.prod([m.shape[a] for a in axes]))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_slices_equal_jax_shards(shape):
    jm = _jax_mesh(shape)
    x = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
    stacked = np.arange(2 * 8 * 5, dtype=np.float32).reshape(2, 8, 5)
    cases = [(jmesh.tokens_sharding, tmesh.tokens_sharding, x),
             (jmesh.batch_sharding, tmesh.batch_sharding, x),
             (jmesh.stacked_batch_sharding, tmesh.stacked_batch_sharding, stacked),
             (jmesh.expert_sharding, tmesh.expert_sharding, x)]
    for jax_sharding, port_sharding, arr in cases:
        placed = jax.device_put(arr, jax_sharding(jm))
        shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
        devices = list(jm.devices.flat)
        for rank, m in enumerate(_port_meshes(shape)):
            np.testing.assert_array_equal(port_sharding(m)(arr), shards[devices[rank]])
            got = port_sharding(m)(torch.from_numpy(arr))
            np.testing.assert_array_equal(got.numpy(), shards[devices[rank]])
    m = _port_meshes(shape)[-1]
    batch = tmesh.shard_batch({"a": x}, m)
    np.testing.assert_array_equal(batch["a"], tmesh.batch_sharding(m)(x))


@pytest.mark.parametrize("batch,expert,context", [(8, 1, 1), (6, 1, 1), (4, 2, 1), (2, 1, 2),
                                                  (3, 1, 1), (12, 2, 2), (1, 1, 1), (5, 2, 1)])
def test_create_mesh_for_batch_data_axis(batch, expert, context):
    with warnings.catch_warnings():  # JAX's note that devices sit idle
        warnings.simplefilter("ignore")
        jm = jmesh.create_mesh_for_batch(batch, expert=expert, context=context)
    assert tmesh.data_axis_for_batch(batch, 8, expert * context) == jm.shape["data"]
    world = ThreadWorld(jm.devices.size)
    m = tmesh.create_mesh_for_batch(batch, expert=expert, context=context, rank=0, world=world)
    assert m.shape == dict(jm.shape)
    # where the JAX package leaves devices idle, the port's ranks would be
    # idle processes: it raises instead
    if jm.devices.size < 8:
        with pytest.raises(ValueError, match="ranks"):
            tmesh.create_mesh_for_batch(batch, expert=expert, context=context, rank=0,
                                        world=ThreadWorld(8))


def test_model_and_pipe_axes_wait_for_slice_11():
    """The model and pipe axes are ported: their ranks take JAX's
    row-major coordinates (data, expert, context, model, pipe)."""
    for axis in ("model", "pipe"):
        jm = jmesh.create_mesh(data=2, **{axis: 2}, devices=jax.devices()[:4])
        ids = np.vectorize(lambda d: d.id)(jm.devices).reshape(-1)
        for r in range(4):
            m = tmesh.Mesh({"data": 2, axis: 2}, r, ThreadWorld(4))
            want = dict(zip(jm.axis_names, np.unravel_index(list(ids).index(
                jax.devices()[r].id), jm.devices.shape)))
            assert {a: m.coords[a] for a in jm.axis_names} == {
                a: int(c) for a, c in want.items()}
    assert tmesh.single_device_mesh().shape == dict(jmesh.single_device_mesh().shape)
    with pytest.raises(ValueError, match="process group or thread ranks"):
        tmesh.Mesh({"data": 2}, 0)


def test_expert_rule_of_param_shardings():
    m = _port_meshes(dict(data=2, expert=2))[3]
    named = {"layers.0.moe.moe_layer.experts.w_up": torch.zeros(4, 8, 16),
             "layers.0.moe.moe_layer.experts.b_up": torch.zeros(4, 16),
             "layers.0.moe.moe_layer.router.router_linear.weight": torch.zeros(4, 8),
             "lm_head.weight": torch.zeros(10, 8),
             "x.experts.odd": torch.zeros(3, 2)}
    got = tmesh.param_shardings(named, m)
    assert got["layers.0.moe.moe_layer.experts.w_up"].spec == ("expert",)
    assert got["layers.0.moe.moe_layer.experts.b_up"].spec == ("expert",)
    for name in ("layers.0.moe.moe_layer.router.router_linear.weight", "lm_head.weight",
                 "x.experts.odd"):
        assert got[name].spec == ()
    w = torch.arange(4 * 8 * 16.0).reshape(4, 8, 16)
    np.testing.assert_array_equal(got["layers.0.moe.moe_layer.experts.w_up"](w), w[2:])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_environment_handling(monkeypatch):
    import torch.distributed as dist

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    assert tmesh.maybe_initialize_distributed("cpu") is False  # one process, no group
    assert tmesh.create_mesh().shape == dict(jmesh.single_device_mesh().shape)
    assert tmesh.local_device("cuda") == torch.device("cuda")
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tmesh.local_device("cuda") == torch.device("cuda", 0)
    assert tmesh.local_device("cpu") == torch.device("cpu")
    try:
        assert tmesh.maybe_initialize_distributed("cpu") is True
        assert dist.get_backend() == "gloo"
        assert tmesh.maybe_initialize_distributed("cpu") is True  # already up
        m = tmesh.create_mesh()
        assert m.distributed and m.size == 1
        g = m.group("data")
        assert g.all_reduce(torch.ones(3)).tolist() == [1.0, 1.0, 1.0]
    finally:
        dist.destroy_process_group()
    assert os.environ["WORLD_SIZE"] == "1"
