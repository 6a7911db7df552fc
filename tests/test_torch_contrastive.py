"""The sharded global-batch contrastive loss
(forde_tpu_torch.parallel.contrastive) over (data 4) thread ranks against
the JAX package's ``sharded_contrastive_loss`` on 4 virtual devices, and
against the port's own ``clip_contrastive_loss`` of the whole batch: the
loss, the accuracies, and the gradients of both embeddings and of the
logit scale. The loss is held by every rank, so each rank differentiates
it over 4 (parallel/collectives.py), and the logit scale's gradient is
the ranks' sum.

The dual encoder's step at (data 4) against the JAX package's jitted step
with the batch sharded over 4 virtual devices, on carried weights: the
metrics, the Adam moments, the parameters, the activation statistics
(moment sums summed over data before they are formed) and the gradient
statistics, with test_torch_clip_step.py's tolerances; every rank ends
with the same bits.

Tolerances: fp32 1e-5 for values, 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.core import mesh as jmesh
from forde_tpu.parallel import contrastive as jcon
from forde_tpu.train import clip_step as jclip
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder, clip_contrastive_loss
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.parallel import contrastive as tcon
from forde_tpu_torch.train import clip_step as tclip
from forde_tpu_torch.train import state as tstate

from test_torch_clip_step import LR, WD, batch as clip_batch, compare
from test_torch_clip_step import small_config as clip_config

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


@pytest.mark.parametrize("batch,dim,logit_scale", [(16, 32, 2.6592), (8, 8, 5.0)])
def test_sharded_contrastive_loss_matches_jax(batch, dim, logit_scale):
    rng = np.random.RandomState(batch)
    img, txt = rng.randn(batch, dim).astype(np.float32), rng.randn(batch, dim).astype(np.float32)
    txt[: batch // 2] = img[: batch // 2] + 0.1 * txt[: batch // 2]  # some pairs match
    scale = np.float32(logit_scale)
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])

    def jloss(img, txt, scale):
        loss, metrics = jcon.sharded_contrastive_loss(img, txt, scale, jm)
        return loss, metrics

    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        img, txt, scale)

    whole = [torch.from_numpy(a.copy()).requires_grad_() for a in (img, txt)]
    whole_scale = torch.tensor(scale, requires_grad=True)
    ref, ref_metrics = clip_contrastive_loss(*whole, whole_scale)
    ref.backward()

    def rank(r, world):
        mesh = tmesh.create_mesh(data=4, rank=r, world=world)
        rows = tmesh.batch_sharding(mesh)
        ti, tt = (torch.from_numpy(rows(a).copy()).requires_grad_() for a in (img, txt))
        ts = torch.tensor(scale, requires_grad=True)
        loss, metrics = tcon.sharded_contrastive_loss(ti, tt, ts, mesh)
        (loss / 4).backward()
        return loss.detach(), metrics, ti.grad, tt.grad, ts.grad

    got = col.run_threads(4, rank)
    for loss, metrics, _, _, _ in got:
        assert torch.equal(loss, got[0][0])  # the same bits on every rank
        np.testing.assert_allclose(float(loss), float(jl), **VAL)
        np.testing.assert_allclose(float(loss), float(ref), **VAL)
        np.testing.assert_allclose(float(metrics["contrastive/acc_img"]),
                                   float(jmetrics["contrastive/acc_img"]), **VAL)
        for key in ("contrastive/acc_img", "contrastive/acc_txt", "contrastive/logit_scale"):
            np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]), **VAL)
    for i, (want, mine) in enumerate(zip(jg[:2], whole)):
        total = np.concatenate([g[2 + i].numpy() for g in got])
        np.testing.assert_allclose(total, np.asarray(want), **GRAD)
        np.testing.assert_allclose(total, mine.grad.numpy(), **GRAD)
    scale_grad = sum(float(g[4]) for g in got)
    np.testing.assert_allclose(scale_grad, float(jg[2]), **GRAD)
    np.testing.assert_allclose(scale_grad, float(whole_scale.grad), **GRAD)


def test_dual_encoder_step_under_data_parallelism_matches_jax():
    cfg = clip_config(64)
    b1, b2 = clip_batch(1), clip_batch(2)
    global_batch = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    js = jclip.create_clip_train_state(cfg, jax.random.PRNGKey(0), LR, WD, batch_size=8,
                                       text_len=b1["input_ids"].shape[1])
    rng = np.random.RandomState(100)
    js = js.replace(brain=jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randint(0, 3, a.shape), jnp.int32), js.brain))
    host = {k: jax.device_get(getattr(js, k)) for k in ("params", "brain", "stats_buffer",
                                                          "grad_stats")}
    jm = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    js = jax.device_put(js, jmesh.replicated(jm))
    js, jmetrics = jclip.clip_train_step(
        js, {k: jax.device_put(v, jmesh.batch_sharding(jm)) for k, v in global_batch.items()})
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_kernel_impl="auto")

    def rank(r, world):
        mesh = tmesh.create_mesh(data=4, rank=r, world=world)
        model = FORDEDualEncoder(t_cfg)
        model.load_state_dict(interop.flax_to_state_dict(
            host["params"], host["brain"], expected=model.state_dict(),
            stats_buffer=host["stats_buffer"]))
        state = tclip.create_clip_train_state(t_cfg, None, LR, WD, model=model)
        state.grad_stats = interop.grad_stats_from_flax(host["grad_stats"])
        tstate.shard_train_state(state, mesh)
        local = tmesh.shard_batch({k: torch.from_numpy(v) for k, v in global_batch.items()},
                                  mesh)
        return tclip.clip_train_step(state, local)

    got = col.run_threads(4, rank)
    state, metrics = got[0]
    compare(js, state, jmetrics, metrics, {})
    for other, _ in got[1:]:
        for (n, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
            assert torch.equal(a, b), n
        for n, g in state.grad_stats.items():
            assert torch.equal(g, other.grad_stats[n]), n
