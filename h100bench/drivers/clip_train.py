"""Training of the dual encoder: ``train.clip_step.clip_train_step`` (a
sensed step: every StatefulLayer adds its activation statistics and its
gradient statistics) on one ``CLIPTrainState``, a fresh batch of random
image/text pairs every step, and ``brain.neuron_slow_loop.neuron_slow_loop_step``
(the GMM) after every ``slow_loop_interval``-th step of the window, as
``train/clip_loop.py`` runs them with its defaults.

Set-up builds the state with the harness's weights and drives it through
the first ``reference_steps`` steps by the window's own call and feed, the
steps the reference follows, then runs the slow loop once on what they
sensed: its new neuron types are checked.
The window and the traced tail are the LM driver's.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Optional

import torch

from h100bench import compare, generate, weights
from h100bench.common import Outcome, RunContext, memory_peak, release, sync
from h100bench.counts import clip as clip_counts
from h100bench.counts.peaks import OPS_PER_S
from h100bench.reference import brain as ref_brain
from h100bench.reference import clip as ref_clip
from h100bench.reference import fp32
from h100bench.reference import train as ref_train

EMBED = "text.token_embed.weight"


def clip_config(cfg: dict):
    from forde_tpu_torch.core.config import DTypePolicy, DualEncoderConfig, TowerConfig

    names = {f.name for f in dataclasses.fields(DualEncoderConfig)} - {"dtypes", "vision", "text"}
    dtypes = DTypePolicy.bf16() if cfg["dtype"] == "bfloat16" else DTypePolicy.fp32()
    return DualEncoderConfig(**{k: v for k, v in cfg.items() if k in names},
                             vision=TowerConfig(**cfg["vision"]), text=TowerConfig(**cfg["text"]),
                             dtypes=dtypes)


def batch(ctx: RunContext, gen) -> dict:
    """``batch`` pairs: images uniform in [0, 1], token ids uniform over the
    vocabulary, right-padded to lengths uniform in the mix's range."""
    mix, cfg, dev = ctx.traffic, ctx.config, ctx.device
    b, s, size = mix["batch"], cfg["max_text_len"], cfg["image_size"]
    images = torch.rand(b, size, size, 3, generator=gen, device=dev)
    ids = generate.token_batch(gen, b, s, cfg["vocab_size"], dev)
    lens = torch.randint(mix["text_len"]["min"], mix["text_len"]["max"] + 1, (b,),
                         generator=gen, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    return {"image": images, "input_ids": ids, "attention_mask": mask}


def batches(ctx: RunContext, gen, n: int):
    return [batch(ctx, gen) for _ in range(n)]


def build_state(ctx: RunContext):
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
    from forde_tpu_torch.train.clip_step import create_clip_train_state

    mix, config = ctx.traffic, clip_config(ctx.config)
    model = FORDEDualEncoder(config, device="meta").to_empty(device=ctx.device)
    model.load_state_dict(weights.make(weights.clip_specs(ctx.config), ctx.seed, ctx.device),
                          strict=True)
    return create_clip_train_state(config, None, mix["learning_rate"], mix["weight_decay"],
                                   mix["grad_clip_norm"], device=ctx.device, model=model)


def make_step(ctx: RunContext):
    """The window's call. Faults (tests and calibration only):
    ``half_batch`` trains on the first half of the pairs; ``unchanged``
    returns the state as it was."""
    from forde_tpu_torch.train.clip_step import clip_train_step

    def step(state, b):
        if "half_batch" in ctx.faults:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        if "unchanged" in ctx.faults:
            return state, {"loss/contrastive": torch.zeros((), device=ctx.device)}
        return clip_train_step(state, b)

    return step


def slow_loop(ctx: RunContext, state, gen):
    """The neuron slow loop. Fault (tests and calibration only):
    ``slow_loop_unchanged`` leaves the neuron types as they were."""
    from forde_tpu_torch.brain.neuron_slow_loop import neuron_slow_loop_step

    if "slow_loop_unchanged" not in ctx.faults:
        neuron_slow_loop_step(state.model, state.grad_stats, state.grad_step_count, gen,
                              forde_lite=ctx.config["forde_lite"])


def _layers(model):
    from forde_tpu_torch.nn.stateful import stateful_layers

    return stateful_layers(model)


def program_readings(ctx: RunContext, state, step, feed) -> dict:
    """The checked steps through the window's call, then one slow loop:
    losses, the first clipped gradient per leaf and per row of the token
    embedding (Adam's first moment), the change per leaf, the sensed sums
    and the slow loop's new neuron types."""
    b1 = state.optimizer.b1
    names = [n for n, _ in state.model.named_parameters()]
    out = {"losses": []}
    for t, b in enumerate(feed, 1):
        state, m = step(state, b)
        out["losses"].append(float(m["loss/contrastive"]))
        if t == 1:
            moments = dict(zip(names, state.optimizer.mu))
            out["grad_norms"] = compare.leaf_norms((n, mu.float() / (1 - b1))
                                                   for n, mu in moments.items())
            out["embed_rows"] = (moments[EMBED].float() / (1 - b1)).norm(dim=-1).cpu()
    start = weights.make(weights.clip_specs(ctx.config), ctx.seed, ctx.device)
    out["change_norms"] = compare.leaf_norms((n, p.detach().float() - start[n])
                                             for n, p in state.model.named_parameters())
    del start
    layers = _layers(state.model)
    out["act_stats"] = {n: layer.act_stats.clone() for n, layer in layers.items()}
    out["grad_stats"] = {n: g.clone() for n, g in state.grad_stats.items()}
    out["sensed_steps"] = int(state.grad_step_count)
    slow_loop(ctx, state, generate.generator(ctx.seed, 2, ctx.device))
    out["types"] = {n: layer.neuron_assignments.clone() for n, layer in layers.items()}
    return out


def reference_side(ctx: RunContext, precision: Optional[str] = None) -> dict:
    """The reference's readings of the same steps from the seed's weights
    and batches, and what it sensed."""
    mix, cfg = ctx.traffic, ctx.config
    specs = weights.clip_specs(cfg)
    zs_names = [f"{t}.blocks.{i}.stateful" for t in ("vision", "text")
                for i in range(cfg[t]["num_layers"])]
    sensed = {"act": {n: 0.0 for n in zs_names}, "grad": {n: 0.0 for n in zs_names}}

    def loss_fn(p, b):
        loss, zs = ref_clip.forward(p, cfg, b["image"], b["input_ids"], b["attention_mask"],
                                    prec=precision)
        for n, z in zip(zs_names, zs):
            sensed["act"][n] = sensed["act"][n] + ref_clip.act_stats(z)
        for n, g in zip(zs_names, torch.autograd.grad(loss, zs, retain_graph=True)):
            sensed["grad"][n] = sensed["grad"][n] + ref_clip.grad_stats(g)
        return loss, torch.zeros(1)

    with fp32():
        params = weights.make(specs, ctx.seed, ctx.device)
        feed = batches(ctx, generate.generator(ctx.seed, 1, ctx.device), mix["reference_steps"])
        out = ref_train.readings(params, weights.trained(specs), feed, loss_fn,
                                 mix["learning_rate"], mix["weight_decay"], mix["grad_clip_norm"],
                                 rows=EMBED)
        out["act_stats"], out["grad_stats"] = sensed["act"], sensed["grad"]
    return out


def numbers(ctx: RunContext, prog: dict, ref: dict) -> dict:
    """The cell's numbers; ``slow_loop`` and ``slow_loop_median`` where
    ``prog`` ran the slow loop (a control does not): against the reference's slow loop on the
    program's sensed sums, with the generator the program's drew from."""
    out = compare.train_numbers(prog, ref)
    out["sensed"] = max(compare.stat_gap(prog["act_stats"], ref["act_stats"]),
                        compare.stat_gap(prog["grad_stats"], ref["grad_stats"]))
    if "types" in prog:
        types = reference_types(ctx, prog)
        out["slow_loop"] = compare.type_share(prog["types"], types)
        out["slow_loop_median"] = statistics.median(
            compare.layer_type_shares(prog["types"], types).values())
    return out


def reference_types(ctx: RunContext, prog: dict) -> dict:
    """The reference's slow loop on the program's sensed sums."""
    with fp32():
        return ref_brain.slow_loop_types(prog["act_stats"], prog["grad_stats"],
                                         prog["sensed_steps"],
                                         generate.generator(ctx.seed, 2, ctx.device))


def slow_loop_detail(ctx: RunContext, prog: dict) -> dict:
    """A calibration's look at ``slow_loop``: the layers typed otherwise
    than by the reference, with their shares."""
    shares = compare.layer_type_shares(prog["types"], reference_types(ctx, prog))
    return {n: v for n, v in shares.items() if v > 0}


def program_side(ctx: RunContext) -> dict:
    state = build_state(ctx)
    gen = generate.generator(ctx.seed, 1, ctx.device)
    out = program_readings(ctx, state, make_step(ctx), batches(ctx, gen, ctx.traffic["reference_steps"]))
    del state
    release(ctx.device)
    return out


def calibrate(ctx: RunContext, controls, faults):
    """As the LM driver's."""
    ref = reference_side(ctx)
    prog = program_side(ctx)
    yield "program", numbers(ctx, prog, ref)
    for control in controls:
        yield f"control_{control}", numbers(ctx, reference_side(ctx, control), ref)
    for fault in faults:
        fctx = dataclasses.replace(ctx, faults={fault})
        yield f"fault_{fault}", numbers(fctx, program_side(fctx), ref)
    yield "detail", compare.change_detail(prog, ref)
    yield "slow_loop_detail", slow_loop_detail(ctx, prog)


def run(ctx: RunContext, started: float) -> Outcome:
    from forde_tpu_torch import kernels

    from h100bench.drivers.lm_train import train_window

    mix, cfg, dev = ctx.traffic, ctx.config, ctx.device
    state = build_state(ctx)
    step = make_step(ctx)
    gen = generate.generator(ctx.seed, 1, dev)
    readings = program_readings(ctx, state, step, batches(ctx, gen, mix["reference_steps"]))
    slow_gen = generate.generator(ctx.seed, 2, dev)
    sync(dev)
    setup_s = time.perf_counter() - started

    holder = {"state": state, "metrics": None}

    def one_step():
        holder["state"], holder["metrics"] = step(holder["state"], batch(ctx, gen))

    window, steps, traced, device = train_window(
        ctx, one_step, lambda: slow_loop(ctx, holder["state"], slow_gen))
    launches = sum(kernels.launches.values()) / (steps + traced)
    last_loss = float(holder["metrics"]["loss/contrastive"])
    peak = memory_peak(dev)
    holder.clear()
    del state, step
    release(dev)

    ref = reference_side(ctx)
    checks = compare.checks(numbers(ctx, readings, ref), ctx.limits)
    ctx.say(f"steps {steps} in {window:.3f} s; last loss {last_loss:.4f} "
            f"(finite {math.isfinite(last_loss)}); hand-kernel launches a step {launches:.1f}")
    ctx.say(f"peak {peak / 2 ** 30:.2f} GiB; set-up {setup_s:.2f} s")
    b = mix["batch"]
    facts = {"steps": steps, "window_s": window, "traced_steps": traced,
             "flops_per_step": clip_counts.train_step_flops(cfg, b, mix["text_len"]),
             "kernel_least_s_per_step": clip_counts.train_kernel_seconds(cfg, b, mix["text_len"]),
             "peak_ops_per_s": OPS_PER_S[cfg["dtype"]]}
    return Outcome(attempted=steps, failed=0 if math.isfinite(last_loss) else steps,
                   metrics={"train_step_ms": window / steps * 1e3, "setup_s": setup_s},
                   checks=checks, memory_peak_bytes=peak, spans=ctx.spans, facts=facts,
                   device=device)
