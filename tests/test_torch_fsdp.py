"""FSDP (``param_sharding="fsdp"``): the port's data-axis layout against
the JAX package's ``state_shardings``, and training steps on 4 thread
ranks against JAX's jitted steps (tests/test_parallel_wiring.py:355-502)
and against replicated parameters.

* The FSDP dim of every parameter at (data 4) and, with TP, at (data 2,
  model 2), against JAX's after the layout transpose: the largest free
  dim in the Flax layout, a square kernel taking Flax's dim 0 (the torch
  weight's dim 1). At least 10 data-split parameters and moments.
* Two LM steps at (data 4) and at (data 2, model 2) with fsdp, capacity
  dispatch: losses against JAX's and against replicated at atol 2e-5,
  then Adam's first moment gathered whole against JAX's.
* One sensed dual-encoder step at (data 2, model 2) with fsdp: the loss at
  atol 5e-5 against one device (JAX's claim), and the whole state against
  JAX's (test_torch_clip_step.compare).
* The backward of the gather is a ``psum_scatter``, and the whole
  parameter is not kept from the forward to the backward: the saved
  tensors of a step hold only shards.
"""

import jax
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.train import clip_step as jclip
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import batch as clip_batch
from test_torch_clip_step import compare
from test_torch_tensor_parallel import (
    LR, NSA, WD, _jax_leaves, _port_spec_of_jax, assert_matches_jax, batches, clip_config,
    clip_tp_ranks, jax_init, jax_steps, lm_config, port_config, port_lm, port_lm_steps,
)

SHAPES = {"data4": dict(data=4), "data2-model2": dict(data=2, model=2)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_fsdp_dims_match_jax_state_shardings(name):
    shape = SHAPES[name]
    cfg = lm_config(**NSA)  # NSA's gates are square (d, d) kernels: the tie
    jm = jmesh.create_mesh(devices=jax.devices()[:4], **shape)
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD, init_batch_shape=(1, 16))
    jshard = jstate.state_shardings(js, jm, "fsdp")
    want = _jax_leaves(jshard.params)
    model = FORDEDecoderLM(port_config(cfg))
    layouts = tstate.param_layouts(model, tmesh.Mesh(shape, 0, col.ThreadWorld(4)), "fsdp")
    keys = interop.flax_keys(layouts)
    ties = 0
    for n, sh in layouts.items():
        key, transposed = keys[n]
        jspec = tuple(want[key.removeprefix("params/")].spec)
        jspec = jspec + (None,) * (len(sh.spec) - len(jspec))
        assert sh.spec == _port_spec_of_jax(jspec, transposed), (n, sh.spec, jspec)
        t = dict(model.named_parameters())[n]
        if transposed and t.ndim == 2 and t.shape[0] == t.shape[1] and sh.dim_of("data") == 1:
            ties += 1
    assert ties >= 2  # gate_compressed and gate_top_k of each layer
    data_split = sum(sh.dim_of("data") is not None for sh in layouts.values())
    assert data_split >= 10
    moments = [leaf for leaf in jax.tree.leaves(jshard.opt_state)
               if "data" in jax.tree.leaves(tuple(leaf.spec))]
    assert len(moments) >= 10


@pytest.fixture(scope="module")
def fsdp_runs():
    cfg = lm_config()
    host = batches(2, 8, 32, cfg.vocab_size)
    one, _ = jax_steps(cfg, jmesh.create_mesh(data=1, devices=jax.devices()[:1]), host)
    out = {}
    for name, shape in SHAPES.items():
        losses, js = jax_steps(cfg, jmesh.create_mesh(devices=jax.devices()[:4], **shape),
                               host, "fsdp")
        out[name] = (losses, js)
    return cfg, host, one, out


@pytest.mark.parametrize("name", list(SHAPES))
def test_fsdp_steps_match_jax_and_replicated(fsdp_runs, name):
    cfg, host, jax_one, runs = fsdp_runs
    jax_losses, js = runs[name]
    np.testing.assert_allclose(jax_losses, jax_one, rtol=0, atol=2e-5)  # JAX's own claim
    params, stats = jax_init(cfg)
    shape = SHAPES[name]
    got = port_lm_steps(cfg, params, stats, shape, host, "fsdp")
    replicated = port_lm_steps(cfg, params, stats, shape, host)
    for r, rep in zip(got, replicated):
        np.testing.assert_allclose(r[0], jax_losses, rtol=0, atol=2e-5)
        np.testing.assert_allclose(r[0], rep[0], rtol=0, atol=2e-5)
    layouts = got[0][3]
    assert sum(sh.dim_of("data") is not None for sh in layouts.values()) >= 10
    qkv = layouts["layers.0.causal_attention.qkv_proj.weight"]
    if "model" in shape:
        assert qkv.dim_of("model") == 0 and qkv.dim_of("data") == 1
    assert_matches_jax(got[0], js)


def test_fsdp_state_holds_shards_and_drops_the_gathered_whole():
    """Per rank the parameters and moments are ~1/data of the whole; a
    step's saved tensors hold no gathered whole weight (the gather runs
    again in the backward); the shards' gradients are reduce-scattered."""
    cfg = lm_config()
    params, stats = jax_init(cfg)
    ids = batches(1, 8, 32, cfg.vocab_size)[0]
    whole = sum(p.numel() for p in port_lm(cfg, params, stats).parameters())

    def rank(r, world):
        mesh = tmesh.Mesh(dict(data=4), r, world)
        state = tstate.create_train_state(port_config(cfg), None, LR, WD,
                                          model=port_lm(cfg, params, stats, mesh))
        tstate.shard_train_state(state, mesh, "fsdp")
        held = sum(p.numel() for p in state.optimizer.params)
        held_mu = sum(m.numel() for m in state.optimizer.mu)
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tstep.loss_fn(state.model, tstep.lm_batch(torch.from_numpy(ids), mesh), 0.01)
        return held, held_mu, saved, [tuple(p.shape) for p in state.optimizer.params]

    got = col.run_threads(4, rank)
    for held, held_mu, saved, shapes in got:
        assert held < 0.3 * whole and held_mu == held
        gathered = {(s[0] * 4,) + s[1:] for s in shapes if len(s) == 2} | {
            s[:1] + (s[1] * 4,) for s in shapes if len(s) == 2}
        big = [s for s in saved if s in gathered and np.prod(s) >= 32 * 64]
        assert not big, big


def test_clip_tp_fsdp_step_matches_jax():
    """The dual encoder at (data 2, model 2) with fsdp: the loss against
    one device at 5e-5 (tests/test_parallel_wiring.py:497), and the whole
    state against JAX's step on the same mesh."""
    cfg = clip_config(64)
    b1, b2 = clip_batch(1), clip_batch(2)
    global_batch = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    js0 = jclip.create_clip_train_state(cfg, jax.random.PRNGKey(0), 1e-3, 0.01, batch_size=8,
                                        text_len=b1["input_ids"].shape[1])
    host = {k: jax.device_get(getattr(js0, k)) for k in ("params", "brain", "stats_buffer",
                                                           "grad_stats")}
    one = jclip.clip_train_step(js0, {k: jax.numpy.asarray(v) for k, v in global_batch.items()})
    jm = jmesh.create_mesh(data=2, model=2, devices=jax.devices()[:4])
    js = jstate.shard_train_state(
        jclip.create_clip_train_state(cfg, jax.random.PRNGKey(0), 1e-3, 0.01, batch_size=8,
                                      text_len=b1["input_ids"].shape[1]), jm, "fsdp")
    js, jmetrics = jclip.clip_train_step(
        js, {k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in global_batch.items()})
    got = clip_tp_ranks(cfg, host, global_batch, dict(data=2, model=2), "fsdp")
    for _, metrics in got:
        np.testing.assert_allclose(float(metrics["loss/contrastive"]),
                                   float(one[1]["loss/contrastive"]), rtol=0, atol=5e-5)
    compare(js, got[0][0], jmetrics, got[0][1], {})
