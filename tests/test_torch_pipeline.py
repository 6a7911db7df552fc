"""GPipe pipeline parallelism (parallel/pipeline.py): the port's stages on
thread ranks against the JAX package's ``pp_forward`` and
``make_pp_train_step`` on the virtual CPU devices
(tests/test_pipeline.py:64-240), on the same weights.

* ``pp_forward`` at (pipe 2) with 2 microbatches, (pipe 4) with 4 and
  (data 2, pipe 2) with 2: the logits at 2e-5, the aux loss (the mean of
  the microbatches' own) at 1e-5, the expert-usage deltas at atol 1e-4 /
  rtol 1e-5 against JAX's, and the unpipelined model's logits.
* ``merge_stats``: usage adds, ``step_count`` advances by 1.
* The gradients of the pipelined loss against ``jax.grad`` of JAX's
  (atol 5e-5 / rtol 5e-4), and one ``make_pp_train_step`` step against
  JAX's: its metrics and Adam's first moment (each stage's layers from
  their owner).
* The dense decoder without mHC or MoE (no stats).
* The state at rest: a stage holds only its layers' parameters and
  moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from forde_tpu.core import mesh as jmesh
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JDecoderLM
from forde_tpu.parallel import pipeline as jpipe
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.parallel import pipeline as tpipe
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close
from test_torch_tensor_parallel import lm_config, port_config, port_lm


def pp_config(**kw):
    """tests/test_pipeline.py's decoder."""
    return lm_config(**{"num_layers": 4, "scan_layers": True, **kw})


def setup(cfg, batch=8, seq=32):
    variables = JDecoderLM(config=cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return jax.device_get(dict(variables)), ids


def jax_mesh(**shape):
    n = int(np.prod(list(shape.values())))
    return jmesh.create_mesh(devices=jax.devices()[:n], **{"data": 1, **shape})


def port_ranks(cfg, variables, shape, fn):
    """``fn(state, mesh)`` on thread ranks of ``shape``, each holding its
    stage of the JAX weights."""
    n = int(np.prod(list(shape.values())))

    def rank(r, world):
        mesh = tmesh.Mesh(shape, r, world)
        model = port_lm(cfg, variables["params"], variables.get("stats_buffer", {}), mesh)
        state = tstate.create_train_state(port_config(cfg), None, 1e-3, 0.0, model=model)
        tstate.shard_train_state(state, mesh)
        return fn(state, mesh)

    return col.run_threads(n, rank)


def _usage_deltas(delta, num_layers):
    """{layer: usage delta} of a port stats delta."""
    return {int(n.split(".")[1]): d for n, d in delta.items() if n.endswith("expert_usage")}


CASES = {"pipe2": (dict(pipe=2), 2), "pipe4": (dict(pipe=4), 4),
         "data2-pipe2": (dict(data=2, pipe=2), 2)}


@pytest.fixture(scope="module")
def forward_runs():
    cfg = pp_config()
    variables, ids = setup(cfg)
    out = {}
    for name, (shape, m) in CASES.items():
        mesh = jax_mesh(**shape)
        logits, aux, delta = jax.jit(
            lambda v, i, mesh=mesh, m=m: jpipe.pp_forward(cfg, v, i, mesh, m))(
                variables, jnp.asarray(ids))
        out[name] = tuple(jax.device_get(x) for x in (logits, aux, delta))
    ref, _ = JDecoderLM(config=cfg).apply(variables, jnp.asarray(ids), mutable=["stats_buffer"])
    return cfg, variables, ids, out, np.asarray(ref[0])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_forward_matches_jax(forward_runs, name):
    cfg, variables, ids, runs, plain = forward_runs
    shape, m = CASES[name]
    want_logits, want_aux, want_delta = runs[name]
    data = shape.get("data", 1)

    def fn(state, mesh):
        batch = tstep.lm_batch(torch.from_numpy(ids), mesh, m)
        with torch.no_grad():
            logits, aux, delta = tpipe.pp_forward(state.model, batch["input_ids"], mesh, m)
        before = {n: b.clone() for n, b in state.model.named_buffers()}
        tpipe.merge_stats(state.model, delta)
        after = dict(state.model.named_buffers())
        for n, b in before.items():
            if n.endswith("step_count"):
                assert int(after[n]) == int(b) + 1, n
            elif n in delta:
                assert torch.equal(after[n], b + delta[n]), n
        return logits, float(aux), delta, mesh.coords

    got = port_ranks(cfg, variables, shape, fn)
    usage_want = np.asarray(want_delta["moe"]["expert_usage"])
    seen = set()
    b, mb = ids.shape[0], ids.shape[0] // m
    for logits, aux, delta, coords in got:
        d = coords["data"]
        rows = np.concatenate([np.arange(i * mb, (i + 1) * mb).reshape(data, -1)[d]
                               for i in range(m)])
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits)[rows], atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(logits.numpy(), plain[rows], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(aux, float(want_aux), atol=1e-5)
        for layer, usage in _usage_deltas(delta, cfg.num_layers).items():
            np.testing.assert_allclose(usage.numpy(), usage_want[layer], atol=1e-4, rtol=1e-5)
            seen.add(layer)
        assert all(int(v) == 0 for n, v in delta.items() if n.endswith("step_count"))
    assert seen == set(range(cfg.num_layers))


def _grads_by_layer(got):
    """{flax path: gradient} from each rank's {torch name: gradient}."""
    merged = {}
    for grads in got:
        merged.update(grads)
    return interop.flatten(interop.state_dict_to_flax(merged)["params"])


def test_pp_gradients_match_jax():
    cfg = pp_config(num_layers=2)
    variables, ids = setup(cfg, batch=4, seq=16)
    mesh = jax_mesh(pipe=2)
    params, stats = variables["params"], variables["stats_buffer"]

    def pp_loss(p):
        logits, aux, _ = jpipe.pp_forward(cfg, {"params": p, "stats_buffer": stats},
                                          jnp.asarray(ids), mesh, 2)
        lm = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], ids[:, 1:]).mean()
        return lm + 0.01 * aux

    want = interop.flatten(interop.split_scan_layers(
        jax.device_get(jax.jit(jax.grad(pp_loss))(params))))

    def fn(state, mesh):
        batch = tstep.lm_batch(torch.from_numpy(ids), mesh, 2)
        logits, aux, _ = tpipe.pp_forward(state.model, batch["input_ids"], mesh, 2)
        shares = tstep.Shares(mesh, batch["labels"])
        share = F.cross_entropy(logits.flatten(0, 1), batch["labels"].long().flatten(),
                                ignore_index=-100, reduction="sum") / shares.targets
        grads = torch.autograd.grad(shares.objective(share, 0.01 * aux),
                                    state.optimizer.params, materialize_grads=True)
        grads = tstep.reduce_gradients(state, grads)
        names = [n for n, _ in state.model.named_parameters()]
        return dict(zip(names, grads))

    got = _grads_by_layer(port_ranks(cfg, variables, dict(pipe=2), fn))
    assert sorted(got) == sorted(want), (set(got) ^ set(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=k)


def test_pp_train_step_matches_jax():
    """One step at (data 2, pipe 2): metrics and Adam's first moment."""
    cfg = pp_config(num_layers=2)
    variables, ids = setup(cfg, batch=8, seq=16)
    mesh = jax_mesh(data=2, pipe=2)
    js = jstate.shard_train_state(
        jstate.create_train_state(cfg, jax.random.PRNGKey(0), 1e-3, 0.0), mesh)
    js, jmetrics = jpipe.make_pp_train_step(cfg, mesh, 2)(js, {"input_ids": jnp.asarray(ids)})

    def fn(state, mesh):
        step = tpipe.make_pp_train_step(mesh, 2, aux_loss_weight=1.0)
        state, metrics = step(state, tstep.lm_batch(torch.from_numpy(ids), mesh, 2))
        names = [n for n, _ in state.model.named_parameters()]
        owned = {n for n in names if n.startswith("layers.")}
        assert len({n.split(".")[1] for n in owned}) == 1  # one layer per stage
        assert len(state.optimizer.mu) == len(names)
        return dict(zip(names, state.optimizer.mu)), {k: float(v) for k, v in metrics.items()}

    got = port_ranks(cfg, variables, dict(data=2, pipe=2), fn)
    for _, metrics in got:
        for key in ("loss/total", "loss/lm", "loss/aux", "training/grad_norm"):
            np.testing.assert_allclose(metrics[key], float(jmetrics[key]), rtol=1e-5,
                                       err_msg=key)
    mu = _grads_by_layer([g for g, _ in got])
    want = interop.flatten(interop.split_scan_layers(
        jax.device_get(_adam_moments(js.opt_state)[0])))
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert sorted(mu) == sorted(want)
    for k, w in want.items():
        _close(mu[k], w, f"adam mu {k}", extra=1e-6 * top)


def test_pp_without_mhc_or_moe():
    cfg = pp_config(use_hyper_connections=False, use_moe=False)
    variables, ids = setup(cfg)
    mesh = jax_mesh(pipe=2)
    want = jax.jit(lambda v, i: jpipe.pp_forward(cfg, v, i, mesh, 4)[0])(variables,
                                                                          jnp.asarray(ids))

    def fn(state, mesh):
        batch = tstep.lm_batch(torch.from_numpy(ids), mesh, 4)
        with torch.no_grad():
            logits, _, delta = tpipe.pp_forward(state.model, batch["input_ids"], mesh, 4)
        assert delta is None
        return logits

    for logits in port_ranks(cfg, variables, dict(pipe=2), fn):
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_stage_holds_only_its_layers():
    cfg = pp_config()
    variables, _ = setup(cfg)

    def fn(state, mesh):
        layers = {int(n.split(".")[1]) for n, _ in state.model.named_parameters()
                  if n.startswith("layers.")}
        assert layers == set(tpipe.stage_layers(mesh, cfg.num_layers))
        assert all(isinstance(state.model.layers[i], tpipe.Elsewhere)
                   for i in range(cfg.num_layers) if i not in layers)
        assert sum(sh.stage for sh in state.layouts) >= 10
        return len(state.optimizer.params)

    counts = port_ranks(cfg, variables, dict(data=2, pipe=2), fn)
    assert len(set(counts)) == 1
