"""One training step under a mesh, the port's 4 thread ranks against the
JAX package's jitted step on 4 virtual devices, on carried weights.

* The decoder LM (2 layers, d_model 64, 2 heads of 32, S = 128, window
  16, ratio 4, top-k 16, 4 experts top-2, 2 streams, dropout 0) at (data
  2, context 2) with capacity dispatch, at (data 2, expert 2) with ep
  dispatch (the all-to-all) and at (expert 2, context 2) with ep dispatch
  (the psum variant): the metrics, Adam's first moment (0.1 x the clipped
  gradient; expert banks gathered over the expert axis) and the MoE stat
  buffers. Then a MoE slow loop on every rank: every replicated tensor
  stays bit-identical across the ranks.

The dual encoder's step under data parallelism is in
test_torch_contrastive.py. The JAX side runs its attention through its
reference path (the port runs its kernels' plain versions). Tolerances:
test_torch_lm_train.py's (1e-4 relative with a floor of 1e-4 of each
tensor's largest value; fp32 sums in other orders through two layers and
a backward), the metrics within 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.core import mesh as jmesh
from forde_tpu.train import state as jstate
from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close

B, S, LR, WD, AUX = 2, 128, 1e-3, 0.01, 0.01


def lm_config(**kw):
    base = dict(
        vocab_size=512, d_model=64, num_layers=2, num_heads=2, head_dim=32, max_seq_len=S,
        num_experts=4, top_k_experts=2, expert_hidden_dim=128, window_size=16,
        compression_ratio=4, top_k_global=16, num_streams=2, sinkhorn_iterations=3,
        dropout_rate=0.0, attention_impl="reference",
    )
    base.update(kw)
    return jcfg.LLMConfig(**base)


CASES = {
    "data2-context2-capacity": (dict(data=2, context=2), "capacity"),
    "data2-expert2-ep": (dict(data=2, expert=2), "ep"),
    "expert2-context2-ep": (dict(expert=2, context=2), "ep"),
}


def _full_moment(got, name, marks):
    """A parameter's tensor over the whole bank: the expert ranks' slices
    (data 0, context 0) concatenated, or rank 0's."""
    if not marks[name]:
        return got[0]["mu"][name]
    ranks = sorted((r for r in got if r["coords"]["data"] == r["coords"]["context"] == 0),
                   key=lambda r: r["coords"]["expert"])
    return torch.cat([r["mu"][name] for r in ranks])


@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_under_a_mesh_matches_jax(case):
    shape, dispatch = CASES[case]
    cfg = lm_config(moe_dispatch=dispatch)
    jm = jmesh.create_mesh(devices=jax.devices()[:4], **{"data": 1, **shape})
    model_mesh = jm if (dispatch == "ep" or shape.get("context", 1) > 1) else None
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD, init_batch_shape=(1, 64),
                                   mesh=model_mesh)
    host_params = jax.device_get(js.params)
    host_stats = jax.device_get(js.stats_buffer)
    js = jstate.shard_train_state(js, jm)
    ids = np.random.RandomState(1).randint(1, 512, (B, S)).astype(np.int32)
    js, jmetrics = jstep.train_step(
        js, {"input_ids": jax.device_put(ids, jmesh.tokens_sharding(jm))}, aux_loss_weight=AUX)
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_impl="auto")

    def rank(r, world):
        mesh = tmesh.Mesh(shape, r, world)
        model = FORDEDecoderLM(t_cfg, mesh=mesh)
        model.load_state_dict(interop.flax_to_state_dict(
            interop.split_scan_layers(host_params), {}, expected=model.state_dict(),
            stats_buffer=interop.split_scan_layers(host_stats)))
        state = tstate.shard_train_state(
            tstate.create_train_state(t_cfg, None, LR, WD, model=model), mesh)
        state, metrics = tstep.train_step(state, tstep.lm_batch(torch.from_numpy(ids), mesh),
                                          aux_loss_weight=AUX)
        names = [n for n, _ in state.model.named_parameters()]
        out = {"coords": mesh.coords, "metrics": {k: float(v) for k, v in metrics.items()},
               "mu": dict(zip(names, (m.clone() for m in state.optimizer.mu))),
               "marks": dict(zip(names, state.expert_params)),
               "stats": {n: b.clone() for n, b in state.model.named_buffers()}}
        # the slow loop on every rank, from the same generator and the
        # reduced statistics: the replicated state stays the same bits
        moe_slow_loop_step(state.model, t_cfg, torch.Generator().manual_seed(3), epoch=0,
                           step=1, verbose=False)
        out["after"] = {n: t.detach().clone() for n, t in state.model.state_dict().items()
                        if not (out["marks"].get(n))}
        return out

    got = col.run_threads(4, rank)
    for key in ("loss/total", "loss/lm", "loss/aux", "training/grad_norm"):
        for r in got:
            np.testing.assert_allclose(r["metrics"][key], float(jmetrics[key]), rtol=1e-5,
                                       err_msg=key)
    marks = got[0]["marks"]
    assert any(marks.values()) == (dispatch == "ep")
    names = list(marks)
    full = [_full_moment(got, n, marks) for n in names]
    port_mu = interop.flatten(interop.state_dict_to_flax(dict(zip(names, full)))["params"])
    j_mu = interop.flatten(jax.device_get(_adam_moments(js.opt_state)[0]))
    assert sorted(port_mu) == sorted(j_mu)
    top = max(np.abs(np.asarray(w)).max() for w in j_mu.values())
    for k, want in j_mu.items():
        _close(port_mu[k], want, f"adam mu {k}", extra=1e-6 * top)
    want_stats = interop.flatten(jax.device_get(js.stats_buffer))
    port_stats = interop.flatten(interop.state_dict_to_flax(got[0]["stats"])["stats_buffer"])
    for k, want in want_stats.items():
        _close(port_stats[k], want, k, rtol=1e-5, floor=1e-6)
    for r in got[1:]:
        for n, t in r["after"].items():
            assert torch.equal(t, got[0]["after"][n]), n
