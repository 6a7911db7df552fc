"""Training of the decoder LM: ``train.step.train_step`` on one
``train.state`` state, a fresh batch of uniform token ids every step, and
``brain.slow_loop.moe_slow_loop_step`` after every ``slow_loop_interval``-th
step of the window (the window counts its steps from 1), as
``train/loop.py`` runs them with its optimizer defaults.

Set-up builds the state once, with the harness's weights, and drives it
through the first ``reference_steps`` steps by the window's own call and
feed; those steps are what the reference follows. It then runs the slow
loop once on what they sensed, and its change of the router biases is
checked. The window runs for ``--seconds``; ``train_step_ms`` is the
window over every step completed in it, slow-loop updates included. A
traced run then runs ``trace_seconds`` more of the same steps under the
profiler, which the per-layer device metrics read.
Once the window has closed and the peak memory is read, the program is
freed and the reference takes its steps from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from h100bench import compare, generate, weights
from h100bench.common import Outcome, RunContext, memory_peak, release, sync
from h100bench.counts import lm as lm_counts
from h100bench.counts.peaks import OPS_PER_S
from h100bench.reference import brain as ref_brain
from h100bench.reference import fp32
from h100bench.reference import lm as ref_lm
from h100bench.reference import train as ref_train
from h100bench.trace import DeviceTrace

EMBED = "token_embed.weight"


def lm_config(cfg: dict):
    """The program's ``LLMConfig`` from the configuration file's keys."""
    from forde_tpu_torch.core.config import DTypePolicy, LLMConfig

    names = {f.name for f in dataclasses.fields(LLMConfig)} - {"dtypes"}
    dtypes = DTypePolicy.bf16() if cfg["dtype"] == "bfloat16" else DTypePolicy.fp32()
    return LLMConfig(**{k: v for k, v in cfg.items() if k in names}, dtypes=dtypes)


def build_model(cfg: dict, seed: int, device):
    """The program's model with the harness's weights (built on the meta
    device, so that nothing is drawn twice)."""
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    model = FORDEDecoderLM(lm_config(cfg), device="meta").to_empty(device=device)
    model.load_state_dict(weights.make(weights.lm_specs(cfg), seed, device), strict=True)
    return model


def make_step(ctx: RunContext):
    """The window's call: ``train_step`` on a batch of ids. Faults (tests
    and calibration only): ``half_batch`` trains on the first half of the
    rows; ``unchanged`` reads the loss and returns the state unchanged."""
    from forde_tpu_torch.train.step import loss_fn, train_step

    aux = ctx.traffic["aux_loss_weight"]

    def step(state, ids):
        if "half_batch" in ctx.faults:
            ids = ids[: ids.shape[0] // 2]
        if "unchanged" in ctx.faults:
            with torch.no_grad():
                _, total, _, _ = loss_fn(state.model, {"input_ids": ids}, aux)
            return state, {"loss/total": total}
        return train_step(state, {"input_ids": ids}, aux_loss_weight=aux)

    return step


def slow_loop(ctx: RunContext, model, gen):
    """The MoE slow loop. Fault (tests and calibration only):
    ``slow_loop_unchanged`` leaves the routers as they were."""
    from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step

    if "slow_loop_unchanged" not in ctx.faults:
        moe_slow_loop_step(model, lm_config(ctx.config), gen)


def router_biases(model) -> torch.Tensor:
    return torch.stack([blk.moe.moe_layer.router.router_linear.bias.detach().float().clone()
                        for blk in model.layers])


def program_readings(ctx: RunContext, state, step, batches, slow_gen) -> dict:
    """Drive ``state`` through the checked steps and read what the
    reference will give: losses, the first clipped gradient per leaf and
    per row of the token embedding (from Adam's first moment after one
    step, m = (1 - b1) g), the change per leaf after the steps, the router
    usage summed over them; then run the slow loop once on that usage and
    read its change of the router biases (L, E)."""
    b1 = state.optimizer.b1
    names = [n for n, _ in state.model.named_parameters()]
    out = {"losses": []}
    for t, ids in enumerate(batches, 1):
        state, m = step(state, ids)
        out["losses"].append(float(m["loss/total"]))
        if t == 1:
            moments = dict(zip(names, state.optimizer.mu))
            out["grad_norms"] = compare.leaf_norms((n, mu.float() / (1 - b1))
                                                   for n, mu in moments.items())
            out["embed_rows"] = (moments[EMBED].float() / (1 - b1)).norm(dim=-1).cpu()
    start = weights.make(weights.lm_specs(ctx.config), ctx.seed, ctx.device)
    out["change_norms"] = compare.leaf_norms((n, p.detach().float() - start[n])
                                             for n, p in state.model.named_parameters())
    del start
    layers = state.model.layers
    out["usage"] = torch.stack([blk.moe.expert_usage.float() for blk in layers]).cpu()
    out["sensed_steps"] = int(max(int(blk.moe.step_count) for blk in layers))
    before = router_biases(state.model)
    slow_loop(ctx, state.model, slow_gen)
    out["router_change"] = (router_biases(state.model) - before).cpu()
    return out


def batches(ctx: RunContext, gen, n: int):
    mix, cfg = ctx.traffic, ctx.config
    return [generate.token_batch(gen, mix["batch"], mix["seq_len"], cfg["vocab_size"], ctx.device)
            for _ in range(n)]


def reference_side(ctx: RunContext, precision: Optional[str] = None) -> dict:
    """The reference's readings of the checked steps, from the seed's
    weights and batches (regenerated: nothing is taken from the program)."""
    mix, cfg = ctx.traffic, ctx.config
    with fp32():
        params = weights.make(weights.lm_specs(cfg), ctx.seed, ctx.device)
        names = weights.trained(weights.lm_specs(cfg))
        ids = batches(ctx, generate.generator(ctx.seed, 1, ctx.device), mix["reference_steps"])
        return ref_train.readings(
            params, names, ids,
            lambda p, x: ref_lm.loss(p, cfg, x, mix["aux_loss_weight"], prec=precision),
            mix["learning_rate"], mix["weight_decay"], mix["grad_clip_norm"])


def program_side(ctx: RunContext) -> dict:
    """The program's readings of the checked steps alone (no window)."""
    from forde_tpu_torch.train.state import create_train_state

    mix = ctx.traffic
    model = build_model(ctx.config, ctx.seed, ctx.device)
    state = create_train_state(lm_config(ctx.config), None, mix["learning_rate"],
                               mix["weight_decay"], mix["grad_clip_norm"], device=ctx.device,
                               model=model)
    gen = generate.generator(ctx.seed, 1, ctx.device)
    out = program_readings(ctx, state, make_step(ctx), batches(ctx, gen, mix["reference_steps"]),
                           generate.generator(ctx.seed, 2, ctx.device))
    del state, model
    release(ctx.device)
    return out


def calibrate(ctx: RunContext, controls, faults):
    """(side, numbers) of the program, each control and each fault, all
    against one reference run of the seed; then a look at ``change``."""
    ref = reference_side(ctx)
    prog = program_side(ctx)
    yield "program", numbers(ctx, prog, ref)
    for control in controls:
        yield f"control_{control}", numbers(ctx, reference_side(ctx, control), ref)
    for fault in faults:
        fctx = dataclasses.replace(ctx, faults={fault})
        yield f"fault_{fault}", numbers(fctx, program_side(fctx), ref)
    yield "detail", compare.change_detail(prog, ref)


def numbers(ctx: RunContext, prog: dict, ref: dict) -> dict:
    """The cell's numbers; ``router`` where ``prog`` ran the slow loop
    (a control does not): against the reference's slow loop on the
    program's usage, with the generator the program's slow loop drew from."""
    out = dict(compare.train_numbers(prog, ref), usage=compare.usage_gap(prog["usage"], ref["usage"]))
    if "router_change" in prog:
        with fp32():
            nudge = ref_brain.router_nudges(prog["usage"].to(ctx.device), prog["sensed_steps"],
                                            generate.generator(ctx.seed, 2, ctx.device))
        out["router"] = compare.router_gap(prog["router_change"], nudge)
    return out


def train_window(ctx: RunContext, one_step, slow_update):
    """The window: ``one_step`` until ``--seconds`` have passed, and
    ``slow_update`` after every ``slow_loop_interval``-th step, timed
    between two synchronisations; with ``--trace 1`` then ``trace_seconds``
    more of the same under the profiler. Returns (window seconds, steps in
    it, steps traced, device summary or None)."""
    from forde_tpu_torch import kernels

    dev, spans, mix = ctx.device, ctx.spans, ctx.traffic
    kernels.reset_launches()
    n = 0

    def counted():
        nonlocal n
        n += 1
        with spans.span("train.step"):
            one_step()
        if n % mix["slow_loop_interval"] == 0:
            sync(dev)
            with spans.span("brain.update"):
                slow_update()
                sync(dev)

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        counted()
    sync(dev)
    window, steps = time.perf_counter() - t0, n
    if not ctx.trace:
        return window, steps, 0, None
    trace = DeviceTrace(spans, dev)  # a traced tail: the profiler slows the host
    trace.start()
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < mix["trace_seconds"]:
        counted()
    trace.stop()
    return window, steps, n - steps, trace.summary()


def run(ctx: RunContext, started: float) -> Outcome:
    from forde_tpu_torch import kernels
    from forde_tpu_torch.train.state import create_train_state

    mix, cfg, dev, spans = ctx.traffic, ctx.config, ctx.device, ctx.spans
    config = lm_config(cfg)
    model = build_model(cfg, ctx.seed, dev)
    model.train()
    state = create_train_state(config, None, mix["learning_rate"], mix["weight_decay"],
                               mix["grad_clip_norm"], device=dev, model=model)
    step = make_step(ctx)
    gen = generate.generator(ctx.seed, 1, dev)
    slow_gen = generate.generator(ctx.seed, 2, dev)
    readings = program_readings(ctx, state, step, batches(ctx, gen, mix["reference_steps"]),
                                slow_gen)
    sync(dev)
    setup_s = time.perf_counter() - started

    holder = {"state": state, "metrics": None}

    def one_step():
        ids = generate.token_batch(gen, mix["batch"], mix["seq_len"], cfg["vocab_size"], dev)
        holder["state"], holder["metrics"] = step(holder["state"], ids)

    window, steps, traced, device = train_window(
        ctx, one_step, lambda: slow_loop(ctx, model, slow_gen))
    launches = sum(kernels.launches.values()) / (steps + traced)
    metrics = holder.pop("metrics")
    last_loss = float(metrics["loss/total"])
    peak = memory_peak(dev)
    holder.clear()
    del state, model, metrics, step
    release(dev)

    ref = reference_side(ctx)
    checks = compare.checks(numbers(ctx, readings, ref), ctx.limits)
    ctx.say(f"steps {steps} in {window:.3f} s; last loss {last_loss:.4f} "
            f"(finite {math.isfinite(last_loss)}); hand-kernel launches a step {launches:.1f}")
    ctx.say(f"peak {peak / 2 ** 30:.2f} GiB; set-up {setup_s:.2f} s")
    ctx.say("program losses " + " ".join(f"{x:.6f}" for x in readings["losses"])
            + " reference " + " ".join(f"{x:.6f}" for x in ref["losses"]))
    b, s = mix["batch"], mix["seq_len"]
    facts = {"steps": steps, "window_s": window, "traced_steps": traced,
             "flops_per_step": lm_counts.train_step_flops(cfg, b, s),
             "kernel_least_s_per_step": lm_counts.train_kernel_seconds(cfg, b, s),
             "peak_ops_per_s": OPS_PER_S[cfg["dtype"]]}
    failed = 0 if math.isfinite(last_loss) else steps
    return Outcome(attempted=steps, failed=failed,
                   metrics={"train_step_ms": window / steps * 1e3, "setup_s": setup_s},
                   checks=checks, memory_peak_bytes=peak, spans=spans, facts=facts,
                   device=device)
