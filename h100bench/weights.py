"""Weights made from the seed on the card, the same for the program and
the reference.

``lm_specs`` and ``clip_specs`` list every tensor of the FORDE decoder LM
and dual encoder under the program's state-dict names (a convention of the inputs, checked when the
program loads them strictly) with its initialiser: N(0, 1/fan_in) for
projections and expert banks, N(0, 1/rows) for the embeddings, N(0, 0.02)
for the router, the stream expansion and the head, N(0, 0.1) for the
mixing logits, ones for norms and stream weights, zeros for biases and the
sensing buffers. ``make`` draws every normal tensor from one call of the
seed's generator and cuts it into views.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100bench.generate import generator

Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, kind, std (a const's value)


def lm_specs(cfg: dict) -> List[Spec]:
    if not (cfg["use_sparse_attention"] and cfg["use_moe"] and cfg["use_hyper_connections"]):
        raise ValueError("the harness's LM is the full FORDE block: NSA, MoE and mHC")
    d, hd, n = cfg["d_model"], cfg["num_heads"] * cfg["head_dim"], cfg["num_streams"]
    e, h, v = cfg["num_experts"], cfg["expert_hidden_dim"], cfg["vocab_size"]
    specs: List[Spec] = []

    def dense(name, dout, din, std=None):
        specs.append((f"{name}.weight", (dout, din), "normal", din ** -0.5 if std is None else std))
        specs.append((f"{name}.bias", (dout,), "zeros", 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), "ones", 0.0))
        specs.append((f"{name}.bias", (d,), "zeros", 0.0))

    specs.append(("token_embed.weight", (v, d), "normal", v ** -0.5))
    specs.append(("pos_embed.weight", (cfg["max_seq_len"], d), "normal",
                  cfg["max_seq_len"] ** -0.5))
    dense("initial_streams.stream_init", (n - 1) * d, d, 0.02)
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        a = p + "sparse_attention."
        norm(p + "attn_norm")
        dense(a + "local_attention.qkv_proj", 3 * hd, d)
        dense(a + "local_attention.out_proj", d, hd)
        for branch in ("compressed", "topk"):
            for proj in ("q", "k", "v"):
                dense(f"{a}{branch}_{proj}_proj", hd, d)
            dense(f"{a}{branch}_out_proj", d, hd)
        dense(a + "gate_compressed", d, d)
        dense(a + "importance_scorer", 1, d)
        dense(a + "gate_top_k", d, d)
        specs.append((p + "mhc_attn.mixing_logits", (n, n), "normal", 0.1))
        norm(p + "ffn_norm")
        specs.append((p + "moe.expert_usage", (e,), "zeros", 0.0))
        specs.append((p + "moe.step_count", (), "zeros_int", 0.0))
        dense(p + "moe.moe_layer.router.router_linear", e, d, 0.02)
        m = p + "moe.moe_layer.experts."
        specs.append((m + "w_up", (e, d, h), "normal", d ** -0.5))
        specs.append((m + "w_down", (e, h, d), "normal", h ** -0.5))
        specs.append((m + "b_up", (e, h), "zeros", 0.0))
        specs.append((m + "b_down", (e, d), "zeros", 0.0))
        specs.append((p + "mhc_ffn.mixing_logits", (n, n), "normal", 0.1))
    specs.append(("stream_collapser.stream_weights", (n,), "ones", 0.0))
    norm("final_norm")
    dense("lm_head", v, d, 0.02)
    return specs


def clip_specs(cfg: dict) -> List[Spec]:
    """The FORDE dual encoder's tensors (``models/dual_encoder.py``):
    Dense N(0, 1/fan_in), embeddings N(0, 1/width), the CLS, register and
    position tokens N(0, 0.02), the temperature at its initial value, the
    brain map and the sensing buffers at zero."""
    specs: List[Spec] = []

    def dense(name, dout, din, bias=True):
        specs.append((f"{name}.weight", (dout, din), "normal", din ** -0.5))
        if bias:
            specs.append((f"{name}.bias", (dout,), "zeros", 0.0))

    def norm(name, d):
        specs.append((f"{name}.weight", (d,), "ones", 0.0))
        specs.append((f"{name}.bias", (d,), "zeros", 0.0))

    def blocks(tower, tw):
        d, hd, f = tw["d_model"], tw["num_heads"] * tw["head_dim"], tw["mlp_hidden_dim"]
        for i in range(tw["num_layers"]):
            b = f"{tower}.blocks.{i}."
            norm(b + "attn_norm", d)
            dense(b + "attention.qkv_proj", 3 * hd, d)
            dense(b + "attention.out_proj", d, hd)
            norm(b + "mlp_norm", d)
            specs.append((b + "stateful.neuron_assignments", (f,), "zeros_int", 0.0))
            specs.append((b + "stateful.act_stats", (f, 3), "zeros", 0.0))
            specs.append((b + "stateful.step_count", (), "zeros_int", 0.0))
            dense(b + "stateful.w_in", f, d)
            dense(b + "stateful.w_out", d, f)
        norm(f"{tower}.final_norm", d)

    vis, txt = cfg["vision"], cfg["text"]
    patches = (cfg["image_size"] // cfg["patch_size"]) ** 2
    registers = (8 - (patches + 1) % 8) % 8
    specs.append(("logit_scale", (), "const", cfg["logit_scale_init"]))
    specs.append(("vision.cls_token", (1, 1, vis["d_model"]), "normal", 0.02))
    if registers:
        specs.append(("vision.register_tokens", (1, registers, vis["d_model"]), "normal", 0.02))
    specs.append(("vision.pos_embed", (1, patches + 1 + registers, vis["d_model"]), "normal", 0.02))
    dense("vision.patch_embed", vis["d_model"], cfg["patch_size"] ** 2 * 3)
    blocks("vision", vis)
    specs.append(("text.pos_embed", (1, cfg["max_text_len"], txt["d_model"]), "normal", 0.02))
    specs.append(("text.token_embed.weight", (cfg["vocab_size"], txt["d_model"]), "normal",
                  txt["d_model"] ** -0.5))
    blocks("text", txt)
    dense("image_projection", cfg["embed_dim"], vis["d_model"], bias=False)
    dense("text_projection", cfg["embed_dim"], txt["d_model"], bias=False)
    return specs


def make(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``specs`` in fp32 on ``device`` from ``seed``."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, kind, _ in specs if kind == "normal"]
    flat = torch.randn(sum(sizes), generator=generator(seed, 0, device), device=device)
    out, start = {}, 0
    for name, shape, kind, std in specs:
        if kind == "normal":
            size = int(torch.Size(shape).numel())
            out[name] = flat[start:start + size].view(shape).mul_(std)
            start += size
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros_int":
            out[name] = torch.zeros(shape, dtype=torch.int32, device=device)
        elif kind == "const":
            out[name] = torch.full(shape, std, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def trained(specs: List[Spec]) -> List[str]:
    """The parameters among ``specs``: every tensor but the buffers."""
    buffers = ("expert_usage", "step_count", "neuron_assignments", "act_stats")
    return [n for n, _, _, _ in specs if n.rsplit(".", 1)[-1] not in buffers]
