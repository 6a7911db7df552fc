"""Tensor parallelism (the ``model`` mesh axis): the port's Megatron
layout against the JAX package's ``tp_param_spec``, and training steps on
4 thread ranks against the JAX package's jitted steps on 4 of the 8
virtual CPU devices (GSPMD over its sharded state) and against one rank.

* ``tp_param_spec`` of every parameter of the tiny decoder LM (dense and
  capacity MoE, NSA on), the int8 LM and the dual encoder, against JAX's
  for the same Flax leaf, after the layout transpose (a torch weight is
  (out, in)): the split dims, and for the whole state (expert and model
  axes) ``train.state.param_layouts`` against ``state_shardings``. A fused
  ``qkv_proj`` splits by head in the port (``Sharding.blocks``), so its
  per-rank bytes differ from a JAX device's; the split dim is the same
  and the gathered whole is compared.
* Two LM steps at (data 2, model 2), capacity dispatch, dense-causal and
  NSA: the losses against JAX's at atol 2e-5 and against one rank
  (tests/test_parallel_wiring.py:291-351), then Adam's first moment and
  the stat buffers gathered whole against JAX's; the same at (model 4)
  with 8 heads of 4, two a rank.
* One sensed dual-encoder step at (data 2, model 2): loss, metrics,
  parameters, Adam's moments, the all-gathered ``act_stats`` and the
  gradient statistics against JAX's (test_torch_clip_step.compare).

Tolerances: losses 2e-5 absolute (the JAX tests'); tensors as
test_torch_parallel_step.py holds them (1e-4 relative with a floor of 1e-4
of the largest value: fp32 sums in another order through two layers and a
backward).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.core import mesh as jmesh
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JDecoderLM
from forde_tpu.models.dual_encoder import FORDEDualEncoder as JDualEncoder
from forde_tpu.ops.quant import quantize_params as jquantize
from forde_tpu.train import clip_step as jclip
from forde_tpu.train import state as jstate
from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
from forde_tpu_torch.ops.quant import quantize_params
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.train import clip_step as tclip
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close, compare
from test_torch_clip_step import batch as clip_batch
from test_torch_clip_step import small_config


def clip_config(head_dim):
    """test_torch_clip_step's dual encoder, its JAX side on the reference
    attention and moment sums (the Pallas interpreter under GSPMD is what
    would take the time)."""
    return small_config(head_dim).replace(attention_kernel_impl="reference",
                                          stateful_kernel_impl="reference")

LR, WD, AUX = 1e-2, 0.0, 0.01


def lm_config(**kw):
    """tests/test_parallel_wiring.py's decoder."""
    base = dict(
        vocab_size=128, d_model=32, num_layers=2, num_heads=2, head_dim=16, max_seq_len=64,
        use_moe=True, num_experts=4, top_k_experts=2, expert_hidden_dim=64,
        use_sparse_attention=False, use_hyper_connections=True, num_streams=2,
        sinkhorn_iterations=3, dropout_rate=0.0, attention_impl="reference",
        dtypes=jcfg.DTypePolicy.fp32(), moe_capacity_factor=4.0, moe_dispatch="capacity",
    )
    base.update(kw)
    return jcfg.LLMConfig(**base)


NSA = dict(use_sparse_attention=True, window_size=16, compression_ratio=4, top_k_global=8)


def batches(n, b, s, vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (b, s)).astype(np.int32) for _ in range(n)]


def port_config(cfg):
    return tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_impl="auto")


def jax_init(cfg):
    variables = JDecoderLM(config=cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 16), jnp.int32))
    return jax.device_get(variables["params"]), jax.device_get(variables["stats_buffer"])


def port_lm(cfg, params, stats, mesh=None):
    """The port's decoder holding JAX's weights."""
    model = FORDEDecoderLM(port_config(cfg), mesh=mesh)
    model.load_state_dict(interop.flax_to_state_dict(
        interop.split_scan_layers(params), {}, expected=model.state_dict(),
        stats_buffer=interop.split_scan_layers(stats)))
    return model


def jax_steps(cfg, mesh, host_batches, param_sharding="replicated"):
    """JAX's steps (tests/test_parallel_wiring.py's _run_steps): (losses,
    final state)."""
    state = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD,
                                      init_batch_shape=(1, 16))
    state = jstate.shard_train_state(state, mesh, param_sharding)
    losses = []
    for ids in host_batches:
        batch = {"input_ids": jax.device_put(ids, jmesh.tokens_sharding(mesh))}
        state, metrics = jstep.train_step(state, batch, aux_loss_weight=AUX)
        losses.append(float(metrics["loss/total"]))
    return losses, state


def gathered(state):
    """{name: (whole parameter, whole Adam mu)} of a state on a mesh (every
    rank calls it)."""
    names = [n for n, _ in state.model.named_parameters()]
    return {n: (sh.gather(p.detach()), sh.gather(m))
            for n, p, m, sh in zip(names, state.optimizer.params, state.optimizer.mu,
                                   state.layouts)}


def port_lm_steps(cfg, params, stats, shape, host_batches, param_sharding="replicated"):
    """The port's steps on thread ranks of ``shape`` (or one rank, for
    ``shape`` None): per rank (losses, whole {name: (param, mu)}, buffers,
    layouts by name)."""
    def run(mesh):
        model = port_lm(cfg, params, stats, mesh)
        state = tstate.create_train_state(port_config(cfg), None, LR, WD, model=model)
        tstate.shard_train_state(state, mesh, param_sharding)
        losses = []
        for ids in host_batches:
            batch = tstep.lm_batch(torch.from_numpy(ids), mesh)
            state, metrics = tstep.train_step(state, batch, aux_loss_weight=AUX)
            losses.append(float(metrics["loss/total"]))
        names = [n for n, _ in state.model.named_parameters()]
        layouts = dict(zip(names, state.layouts or [None] * len(names)))
        whole = gathered(state) if mesh is not None else {
            n: (p.detach(), m) for n, p, m in zip(names, state.optimizer.params,
                                                  state.optimizer.mu)}
        buffers = {n: b.clone() for n, b in state.model.named_buffers()}
        return losses, whole, buffers, layouts

    if shape is None:
        return [run(None)]
    n = int(np.prod(list(shape.values())))
    return col.run_threads(n, lambda r, world: run(tmesh.Mesh(shape, r, world)))


def assert_matches_jax(got, js, with_stats=True):
    """A gathered port state (``port_lm_steps``' rank) against JAX's."""
    _, whole, buffers, _ = got
    names = list(whole)
    mu = interop.flatten(interop.state_dict_to_flax({n: whole[n][1] for n in names})["params"])
    want_mu = interop.flatten(jax.device_get(_adam_moments(js.opt_state)[0]))
    assert sorted(mu) == sorted(want_mu)
    top = max(np.abs(np.asarray(w)).max() for w in want_mu.values())
    for k, want in want_mu.items():
        _close(mu[k], want, f"adam mu {k}", extra=1e-6 * top)
    if with_stats:
        want_stats = interop.flatten(jax.device_get(js.stats_buffer))
        port_stats = interop.flatten(interop.state_dict_to_flax(buffers)["stats_buffer"])
        for k, want in want_stats.items():
            _close(port_stats[k], want, k, rtol=1e-5, floor=1e-6)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


def _jax_leaves(tree):
    return {"/".join(str(getattr(p, "key", "")) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_spec_of_jax(spec, transposed):
    """A JAX spec (tuple) in the torch layout."""
    spec = list(spec)
    if transposed and len(spec) >= 2:
        spec[-1], spec[-2] = spec[-2], spec[-1]
    return tuple(spec)


def _models(kind):
    if kind == "dual":
        cfg = clip_config(64)
        jtree = JDualEncoder(config=cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            jnp.ones((1, 16), jnp.int32))["params"]
        tcfg_ = tcfg.config_from_dict(jcfg.config_to_dict(cfg))
        return jtree, FORDEDualEncoder(tcfg_)
    cfg = lm_config(**(NSA if kind.endswith("nsa") else {}),
                    moe_dispatch="dense" if "dense" in kind else "capacity")
    params, _ = jax_init(cfg)
    model = FORDEDecoderLM(port_config(cfg))
    if kind.startswith("int8"):
        cfg = cfg.replace(use_sparse_attention=False)
        params, _ = jax_init(cfg)
        model = quantize_params(FORDEDecoderLM(port_config(cfg),
                                               generator=torch.Generator().manual_seed(0)))
        params = jquantize(params)
    return params, model


@pytest.mark.parametrize("kind", ["lm-dense-nsa", "lm-capacity", "int8-lm", "dual"])
def test_tp_param_spec_matches_jax(kind):
    jtree, model = _models(kind)
    want = _jax_leaves(jtree)
    keys = interop.flax_keys(n for n, _ in model.named_parameters())
    named = dict(model.named_parameters())
    split = 0
    for name, (key, transposed) in keys.items():
        jpath = key.removeprefix("params/")
        leaf = want[jpath.replace("layers/", "")] if jpath not in want else want[jpath]
        jnames = jpath.split("/")
        jspec = jmesh.tp_param_spec(jnames, leaf)
        got = tmesh.tp_param_spec(name.split("."), named[name])
        if jspec is None:
            assert got is None, (name, got)
            continue
        assert got == _port_spec_of_jax(jspec, transposed), (name, got, jspec)
        split += 1
    assert split >= (6 if kind == "int8-lm" else 10), split


@pytest.mark.parametrize("shape", [dict(data=2, model=2), dict(expert=2, model=2)],
                         ids=["data2-model2", "expert2-model2"])
def test_state_layouts_match_jax_state_shardings(shape):
    """Every parameter's split axes and dims, expert rule and TP together,
    against JAX's ``state_shardings`` after the transpose."""
    cfg = lm_config(**NSA)
    jm = jmesh.create_mesh(devices=jax.devices()[:4], **{"data": 1, **shape})
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD, init_batch_shape=(1, 16))
    jshard = _jax_leaves(jstate.state_shardings(js, jm).params)
    model = FORDEDecoderLM(port_config(cfg))
    mesh = tmesh.Mesh(shape, 0, col.ThreadWorld(4))
    layouts = tstate.param_layouts(model, mesh)
    keys = interop.flax_keys(layouts)
    for name, sh in layouts.items():
        key, transposed = keys[name]
        jspec = tuple(jshard[key.removeprefix("params/")].spec)
        jspec = jspec + (None,) * (sh and len(sh.spec) - len(jspec))
        assert sh.spec == _port_spec_of_jax(jspec, transposed), (name, sh.spec, jspec)
        assert sh.blocks[sh.dim_of("model")] == 3 if (sh.dim_of("model") is not None and
                                                     name.endswith("qkv_proj.weight")) else True


def test_qkv_splits_by_head_and_gathers_whole():
    """A rank's qkv rows are the q, k and v rows of its heads; the gather
    rebuilds JAX's [q | k | v] whole."""
    heads, hd, d = 4, 3, 5
    w = torch.arange(3 * heads * hd * d, dtype=torch.float32).reshape(3 * heads * hd, d)
    mesh_shape = dict(model=2)

    def rank(r, world):
        mesh = tmesh.Mesh(mesh_shape, r, world)
        sh = tmesh.Sharding(mesh, ("model", None), (3, 1))
        mine = sh(w)
        return mine, sh.gather(mine)

    got = col.run_threads(2, rank)
    for r, (mine, whole) in enumerate(got):
        q, k, v = w.reshape(3, heads, hd, d).unbind(0)
        own = slice(r * heads // 2, (r + 1) * heads // 2)
        want = torch.cat([t[own].reshape(-1, d) for t in (q, k, v)])
        assert torch.equal(mine, want)
        assert torch.equal(whole, w)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_runs():
    """JAX's two steps at (data 2, model 2) and on one device, for the
    dense-causal and the NSA decoder (computed once for the module)."""
    out = {}
    for name, kw in (("causal", {}), ("nsa", NSA)):
        cfg = lm_config(**kw)
        host = batches(2, 4, 32, cfg.vocab_size)
        tp_losses, js = jax_steps(cfg, jmesh.create_mesh(data=2, model=2,
                                                         devices=jax.devices()[:4]), host)
        one_losses, _ = jax_steps(cfg, jmesh.create_mesh(data=1, devices=jax.devices()[:1]),
                                  host)
        out[name] = (cfg, host, tp_losses, one_losses, js)
    return out


@pytest.mark.parametrize("name", ["causal", "nsa"])
def test_tp_lm_steps_match_jax_and_one_rank(lm_runs, name):
    cfg, host, tp_losses, one_losses, js = lm_runs[name]
    np.testing.assert_allclose(tp_losses, one_losses, rtol=0, atol=2e-5)  # JAX's own claim
    params, stats = jax_init(cfg)
    got = port_lm_steps(cfg, params, stats, dict(data=2, model=2), host)
    (one,) = port_lm_steps(cfg, params, stats, None, host)
    for r in got:
        np.testing.assert_allclose(r[0], tp_losses, rtol=0, atol=2e-5)
        np.testing.assert_allclose(r[0], one[0], rtol=0, atol=2e-5)
    layouts = got[0][3]
    assert tuple(layouts["layers.0.moe.moe_layer.experts.w_up"].spec)[-1] == "model"
    attn = "sparse_attention.local_attention" if name == "nsa" else "causal_attention"
    assert layouts[f"layers.0.{attn}.qkv_proj.weight"].spec[0] == "model"
    assert_matches_jax(got[0], js)
    top = max(float(m.abs().max()) for _, m in one[1].values())
    for n, (_, m) in got[0][1].items():
        _close(m, one[1][n][1], f"adam mu {n}", extra=1e-6 * top)


MODEL4 = dict(d_model=32, num_heads=8, head_dim=4)


@pytest.mark.parametrize("name", ["causal", "nsa"])
def test_tp_model4_lm_steps_match_jax_and_one_rank(name):
    """The model axis at 4 (8 heads of 4: 2 a rank), capacity dispatch,
    2 steps: the losses against JAX's ``create_mesh(model=4)`` and one
    rank, Adam's first moment against both. On the card phase 32's
    LM step over model 4 read 3.1e-03 relative L2 in its gradients; this
    holds the layout at the same axis here."""
    cfg = lm_config(**MODEL4, **(NSA if name == "nsa" else {}))
    host = batches(2, 4, 32, cfg.vocab_size)
    tp_losses, js = jax_steps(cfg, jmesh.create_mesh(data=1, model=4,
                                                     devices=jax.devices()[:4]), host)
    params, stats = jax_init(cfg)
    got = port_lm_steps(cfg, params, stats, dict(model=4), host)
    (one,) = port_lm_steps(cfg, params, stats, None, host)
    layouts = got[0][3]
    attn = "sparse_attention.local_attention" if name == "nsa" else "causal_attention"
    assert layouts[f"layers.0.{attn}.qkv_proj.weight"].spec[0] == "model"
    for r in got:
        np.testing.assert_allclose(r[0], tp_losses, rtol=0, atol=2e-5)
        np.testing.assert_allclose(r[0], one[0], rtol=0, atol=2e-5)
    assert_matches_jax(got[0], js)
    top = max(float(m.abs().max()) for _, m in one[1].values())
    for n, (_, m) in got[0][1].items():
        _close(m, one[1][n][1], f"adam mu {n}", extra=1e-6 * top)


def test_tp_clip_step_matches_jax():
    """One sensed step of the dual encoder at (data 2, model 2): heads and
    hidden columns split, ``act_stats`` gathered whole."""
    cfg = clip_config(64)
    b1, b2 = clip_batch(1), clip_batch(2)
    global_batch = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    js = jclip.create_clip_train_state(cfg, jax.random.PRNGKey(0), 1e-3, 0.01, batch_size=8,
                                       text_len=b1["input_ids"].shape[1])
    rng = np.random.RandomState(100)
    js = js.replace(brain=jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randint(0, 3, a.shape), jnp.int32), js.brain))
    host = {k: jax.device_get(getattr(js, k)) for k in ("params", "brain", "stats_buffer",
                                                          "grad_stats")}
    jm = jmesh.create_mesh(data=2, model=2, devices=jax.devices()[:4])
    js = jstate.shard_train_state(js, jm)
    js, jmetrics = jclip.clip_train_step(
        js, {k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in global_batch.items()})
    got = clip_tp_ranks(cfg, host, global_batch, dict(data=2, model=2), "replicated")
    compare(js, got[0][0], jmetrics, got[0][1], {})
    for other, _ in got[1:]:
        for n, g in got[0][0].grad_stats.items():
            assert torch.equal(g, other.grad_stats[n]), n


def clip_tp_ranks(cfg, host, global_batch, shape, param_sharding):
    """One sensed dual-encoder step on thread ranks of ``shape``: per rank
    (the state made whole, its metrics)."""
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_kernel_impl="auto")

    def rank(r, world):
        mesh = tmesh.Mesh(shape, r, world)
        model = FORDEDualEncoder(t_cfg)
        model.load_state_dict(interop.flax_to_state_dict(
            host["params"], host["brain"], expected=model.state_dict(),
            stats_buffer=host["stats_buffer"]))
        state = tclip.create_clip_train_state(t_cfg, None, 1e-3, 0.01, model=model)
        state.grad_stats = interop.grad_stats_from_flax(host["grad_stats"])
        tstate.shard_train_state(state, mesh, param_sharding)
        assert any(sh.dim_of("model") is not None for sh in state.layouts)
        local = tmesh.shard_batch({k: torch.from_numpy(v) for k, v in global_batch.items()},
                                  mesh)
        state, metrics = tclip.clip_train_step(state, local)
        return whole_clip_state(state, t_cfg), metrics

    return col.run_threads(int(np.prod(list(shape.values()))), rank)


def whole_clip_state(state, t_cfg):
    """The dual-encoder state with every tensor gathered whole (each rank
    calls it), in the form test_torch_clip_step.compare reads."""
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer
    parts = [[sh.gather(t.detach()) for t, sh in zip(ts, state.layouts)]
             for ts in (opt.params, opt.mu, opt.nu)]
    model = FORDEDualEncoder(t_cfg)
    sd = dict(state.model.state_dict())
    sd.update(zip(names, parts[0]))
    model.load_state_dict(sd)
    return types.SimpleNamespace(
        model=model, optimizer=types.SimpleNamespace(mu=parts[1], nu=parts[2],
                                                     moment_dtype=opt.moment_dtype),
        grad_stats=state.grad_stats, grad_step_count=state.grad_step_count)
