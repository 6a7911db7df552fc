"""Rematerialisation in the port (forde_tpu_torch/nn/remat.py), against the
port without it and against the JAX package's ``remat``:

* the decoder LM (the small config of test_torch_lm_train.py): one
  ``train_step`` with ``remat=True`` equals one with ``remat=False`` from
  the same weights bit for bit on the CPU (metrics, both Adam moments,
  the parameters after AdamW, the MoE stat buffers), every block ran
  twice (forward, recomputation) and ``step_count`` advanced by exactly 1;
* the same step against the JAX package's ``train_step`` with
  ``remat=True``, unrolled and scanned + remat (as tests/test_scan_layers.py
  builds it), on carried weights: the metrics within 1e-5 relative, the
  moments, parameters and stat buffers as test_torch_lm_train.py holds
  them (1e-4 relative with its floors: fp32 sums in other orders through
  two layers and a backward, which Adam's first step magnifies);
* the dual encoder's sensed step (test_torch_clip_step.py's small config)
  under "block" and "mlp" equals the plain sensed step bit for bit: loss,
  metrics, gradients (Adam's first moment), ``act_stats``, ``step_count``
  and the gradient-tap statistics; ``moment_sums`` runs as often (once per
  StatefulLayer forward and once per tap), and the rematted modules ran
  twice;
* a remat config serves like the plain one (``vit_tiny_config().replace(
  remat="mlp")``, as tests/test_serve.py uses it): no-grad calls are not
  checkpointed and give the same embeddings;
* fused steps with "mlp" remat, rehearsed on the CPU as
  tests/test_torch_fuse_steps.py does (``graphs.on_card`` and
  ``graphs.StepGraph`` patched), equal the same steps run eagerly.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.train import state as jstate
from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.core import graphs
from forde_tpu_torch.models.decoder_lm import DecoderBlock, FORDEDecoderLM
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder, remat_policy
from forde_tpu_torch.nn.stateful import StatefulLayer
from forde_tpu_torch.nn.transformer import EncoderSelfAttention, FORDETransformerBlock
from forde_tpu_torch.ops import stat_sums
from forde_tpu_torch.train import clip_step
from forde_tpu_torch.train import distill as tdistill
from forde_tpu_torch.train import lora as tlora
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close, both_states
from test_torch_clip_step import batch as clip_batch
from test_torch_lm_train import AUX, LR, WD, S, small_config, tokens

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def _count_calls(model, module_type):
    """A counter of the forward calls of ``model``'s ``module_type``
    modules (a forward pre-hook on each, so a recomputation, which may stop
    once it has refilled the saved tensors, counts too), and
    the hooks' handles."""
    count = [0]

    def hook(*_):
        count[0] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, module_type)]
    return count, handles


def _lm_state(cfg, weights):
    model = FORDEDecoderLM(cfg)
    model.load_state_dict(weights)
    return tstate.create_train_state(cfg, None, LR, WD, model=model)


def _everything(state):
    names = [n for n, _ in state.model.named_parameters()]
    out = {f"state/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"mu/{n}": m for n, m in zip(names, state.optimizer.mu)})
    out.update({f"nu/{n}": v for n, v in zip(names, state.optimizer.nu)})
    return out


def test_lm_remat_step_is_the_plain_step_bit_for_bit():
    cfg = tcfg.config_from_dict(jcfg.config_to_dict(small_config())).replace(
        attention_impl="auto")
    weights = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    ids = torch.from_numpy(tokens(1))
    results = {}
    for remat in (False, True):
        state = _lm_state(cfg.replace(remat=remat), weights)
        count, handles = _count_calls(state.model, DecoderBlock)
        state, metrics = tstep.train_step(state, {"input_ids": ids}, aux_loss_weight=AUX)
        for h in handles:
            h.remove()
        assert count[0] == cfg.num_layers * (2 if remat else 1), (remat, count[0])
        assert all(int(layer.moe.step_count) == 1 for layer in state.model.layers)
        results[remat] = (metrics, _everything(state))
    (m0, t0), (m1, t1) = results[False], results[True]
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    assert sorted(t0) == sorted(t1)
    for key in t0:
        assert torch.equal(t0[key], t1[key]), key


def _trained(state):
    """The model's state dict, the optimizer's tensors and moments by
    position, and a LoRA state's adapters."""
    out = {f"state/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    for what, tensors in (("param", opt.params), ("mu", opt.mu), ("nu", opt.nu)):
        out.update({f"{what}/{i}": t for i, t in enumerate(tensors)})
    return out


@pytest.mark.parametrize("extra", ["lora", "grad_accum", "distill"])
def test_lm_remat_extras_steps_are_the_plain_steps_bit_for_bit(extra):
    """3 steps of LoRA (the merged weights are what the recomputation
    reads, from the second step on, when lora_b is no longer zero), of
    gradient accumulation (2 microbatches) and of distillation with remat
    equal 3 without, bit for bit."""
    cfg = tcfg.config_from_dict(jcfg.config_to_dict(small_config())).replace(
        attention_impl="auto")
    weights = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    teacher = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(5)).requires_grad_(False)
    micro = 2 if extra == "grad_accum" else 1
    results = {}
    for remat in (False, True):
        state = _lm_state(cfg.replace(remat=remat), weights)
        if extra == "lora":
            state = tlora.create_lora_train_state(state, 4, torch.Generator().manual_seed(1))
            step = tlora.make_lora_train_step(tlora.lora_scale(4, 16.0), aux_loss_weight=AUX)
        elif extra == "grad_accum":
            step = tstep.make_accum_train_step(micro, aux_loss_weight=AUX)
        else:
            step = tdistill.make_distill_step(teacher, aux_loss_weight=AUX)
        count, handles = _count_calls(state.model, DecoderBlock)
        metrics = []
        for seed in range(3):
            state, m = step(state, {"input_ids": torch.from_numpy(tokens(seed))})
            metrics.append(m)
        for h in handles:
            h.remove()
        assert count[0] == 3 * micro * cfg.num_layers * (2 if remat else 1), (remat, count[0])
        results[remat] = (metrics, _trained(state))
    (m0, t0), (m1, t1) = results[False], results[True]
    for step_metrics, want in zip(m1, m0):
        for key in want:
            assert torch.equal(step_metrics[key], want[key]), key
    assert sorted(t0) == sorted(t1)
    for key in t0:
        assert torch.equal(t0[key], t1[key]), key


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scanned"])
def test_lm_remat_step_matches_jax(scan_layers):
    cfg = small_config(remat=True, scan_layers=scan_layers)
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD, init_batch_shape=(1, S))
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_impl="auto")
    assert t_cfg.remat and t_cfg.scan_layers == scan_layers
    model = FORDEDecoderLM(t_cfg)
    model.load_state_dict(interop.flax_to_state_dict(
        interop.split_scan_layers(jax.device_get(js.params)), {}, expected=model.state_dict(),
        stats_buffer=interop.split_scan_layers(jax.device_get(js.stats_buffer)),
    ))
    ts = tstate.create_train_state(t_cfg, None, LR, WD, model=model)
    ids = tokens(2)
    js, jm = jstep.train_step(js, {"input_ids": jnp.asarray(ids)}, aux_loss_weight=AUX)
    ts, tm = tstep.train_step(ts, {"input_ids": torch.from_numpy(ids)}, aux_loss_weight=AUX)

    for key in ("loss/total", "loss/lm", "loss/aux", "training/grad_norm"):
        _close(float(tm[key]), float(jm[key]), key, rtol=1e-5, floor=0.0)
    names = [n for n, _ in ts.model.named_parameters()]

    def port_tree(tensors):
        sd = dict(zip(names, tensors))
        return interop.flatten(interop.state_dict_to_flax(sd, scan_layers=scan_layers)["params"])

    j_mu, j_nu = (interop.flatten(jax.device_get(t)) for t in _adam_moments(js.opt_state))
    got_mu, got_nu = port_tree(ts.optimizer.mu), port_tree(ts.optimizer.nu)
    assert sorted(got_mu) == sorted(j_mu)
    for moments, got, name in ((j_mu, got_mu, "mu"), (j_nu, got_nu, "nu")):
        top = max(np.abs(np.asarray(w)).max() for w in moments.values())
        for k in moments:
            _close(got[k], moments[k], f"adam {name} {k}", extra=1e-6 * top)

    def update(mu, nu):  # Adam's first step: bias corrections 1 - 0.9, 1 - 0.999
        mu, nu = np.asarray(mu, np.float64) / 0.1, np.asarray(nu, np.float64) / 0.001
        return mu / (np.sqrt(nu) + 1e-8)

    port = interop.flatten(interop.state_dict_to_flax(ts.model.state_dict(),
                                                      scan_layers=scan_layers))
    want = interop.flatten({"params": jax.device_get(js.params),
                            "stats_buffer": jax.device_get(js.stats_buffer)})
    assert sorted(port) == sorted(want)
    for k in want:
        assert port[k].shape == np.shape(want[k]), k
        if k.endswith("step_count"):
            np.testing.assert_array_equal(port[k], np.asarray(want[k]))
            assert (np.asarray(port[k]) == 1).all(), k
        elif k.startswith("params/"):
            name = k[len("params/"):]
            du = np.abs(update(got_mu[name], got_nu[name]) - update(j_mu[name], j_nu[name]))
            _close(port[k], want[k], k, extra=LR * du)
        else:
            _close(port[k], want[k], k)


def _clip_everything(state):
    out = _everything(state)
    out.update({f"grad_stats/{k}": v for k, v in state.grad_stats.items()})
    out["grad_step_count"] = state.grad_step_count
    return out


@pytest.mark.parametrize("policy", ["block", "mlp", True])
def test_dual_encoder_remat_sensed_step_bit_for_bit(policy, monkeypatch):
    calls = [0]
    plain = stat_sums.moment_sums

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(stat_sums, "moment_sums", counted)
    _, _, ref = both_states(64, None)
    _, _, rem = both_states(64, None)
    rem.model.config = rem.model.config.replace(remat=policy)
    for block in rem.model.modules():
        if isinstance(block, FORDETransformerBlock):
            block.remat = remat_policy(policy)
    b = {k: torch.from_numpy(v) for k, v in clip_batch(5).items()}
    ref, want = clip_step.clip_train_step(ref, b)
    plain_calls, calls[0] = calls[0], 0
    count, handles = _count_calls(rem.model, StatefulLayer)
    attention, more = _count_calls(rem.model, EncoderSelfAttention)
    rem, got = clip_step.clip_train_step(rem, b)
    for h in handles + more:
        h.remove()
    layers = sum(isinstance(m, StatefulLayer) for m in rem.model.modules())
    assert plain_calls == calls[0] == 2 * layers  # the activations' and the tap's, once each
    assert count[0] == 2 * layers  # the forward and the recomputation
    # "block" recomputes the attention too, "mlp" keeps its activations
    assert attention[0] == (2 if remat_policy(policy) == "block" else 1) * layers
    for key in want:
        assert torch.equal(got[key], want[key]), key
    t0, t1 = _clip_everything(ref), _clip_everything(rem)
    assert sorted(t0) == sorted(t1)
    for key in t0:
        assert torch.equal(t0[key], t1[key]), key
    assert int(rem.grad_step_count) == 1
    assert all(int(m.step_count) == 1 for m in rem.model.modules()
               if isinstance(m, StatefulLayer))


def test_remat_policies_resolve_as_jax():
    assert [remat_policy(p) for p in (False, "none", True, "block", "mlp")] == [
        None, None, "block", "block", "mlp"]
    with pytest.raises(ValueError, match="remat policy"):
        remat_policy("everything")


def test_remat_config_serves_like_the_plain_one():
    cfg = tcfg.vit_tiny_config().replace(image_size=32, max_text_len=16)
    plain = FORDEDualEncoder(cfg.replace(sense=False), generator=torch.Generator().manual_seed(3))
    rem = FORDEDualEncoder(cfg.replace(sense=False, remat="mlp"))
    rem.load_state_dict(plain.state_dict())
    b = clip_batch(7)
    images = torch.from_numpy(np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32))
    ids = torch.from_numpy(b["input_ids"] % cfg.vocab_size)
    mask = torch.from_numpy(b["attention_mask"])
    count, handles = _count_calls(rem, StatefulLayer)
    with torch.no_grad():
        for fn in ("encode_image", "encode_text"):
            args = (images,) if fn == "encode_image" else (ids, mask)
            assert torch.equal(getattr(rem, fn)(*args), getattr(plain, fn)(*args)), fn
    for h in handles:
        h.remove()
    assert count[0] == cfg.vision.num_layers + cfg.text.num_layers  # no recomputation


class _FakeStepGraph:
    """StepGraph without CUDA: the warm-up runs the step, each replay runs
    it again (tests/test_torch_ema.py)."""

    made = []

    def __init__(self, step, generators=()):
        _FakeStepGraph.made.append(self)
        self.step = step
        self.warmup_outputs = step()

    def replay(self):
        return self.step()


def test_fused_mlp_remat_rehearsed_graph(monkeypatch):
    _FakeStepGraph.made = []
    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "StepGraph", _FakeStepGraph)
    k = 2
    _, _, fus = both_states(64, None)
    for block in fus.model.modules():
        if isinstance(block, FORDETransformerBlock):
            block.remat = "mlp"
    ref = copy.deepcopy(fus)
    fused = clip_step.make_fused_step(fus.model.config, k, 1)
    for seed in (10, 20):
        batches = [{kk: torch.from_numpy(v) for kk, v in clip_batch(seed + i).items()}
                   for i in range(k)]
        fus, m = fused(fus, fused.prepare(next(clip_step.stack_batches(iter(batches), k))))
        for b in batches:
            ref, want = clip_step.clip_train_step(ref, b)
    assert len(_FakeStepGraph.made) == 1  # captured once, replayed once
    assert fus.step == ref.step == 2 * k
    t0, t1 = _clip_everything(ref), _clip_everything(fus)
    for key in t0:
        assert torch.equal(t0[key], t1[key]), key
    for key in want:
        assert torch.equal(m[key], want[key]), key
