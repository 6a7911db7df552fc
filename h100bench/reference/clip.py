"""Plain reference of the FORDE dual encoder and its neuron slow loop,
written from the model's equations; it shares no code with the program.

Vision: 16 x 16 patches (row, column, channel order) -> Dense -> [CLS,
patches, register tokens] + positions -> pre-norm blocks -> final norm ->
the CLS row. Text: token + position embeddings -> blocks, keys past each
row's length masked (-1e9) -> final norm -> row 0. A block: x + out(attn(
LN x)); x + w_out(F(z) + gate z), z = w_in(LN x), F by each neuron's type
(relu, tanh, binary step; gate 1, or the specialist gate). Projections
without bias; symmetric InfoNCE at scale min(exp(logit_scale), 100).

Sensing, per StatefulLayer and neuron, over every row of z (padding rows
included): [gini, mean |z|, var] of z (gini = (sqrt n - l1 / l2) / (sqrt n
- 1)) and [gini, mean |g|] of g = dL/dz.

The neuron slow loop is ``reference.brain``'s.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference.lm import attend, layer_norm, linear

Params = Dict[str, torch.Tensor]


def _heads(t, h):
    b, s, _ = t.shape
    return t.reshape(b, s, h, -1).transpose(1, 2)


def gini(l1, sumsq, n: int):
    l2 = sumsq.sqrt()
    value = (math.sqrt(n) - l1 / torch.where(l2 == 0, torch.ones_like(l2), l2)) / (
        math.sqrt(n) - 1.0 if n > 1 else 1.0)
    return torch.where(l2 == 0, torch.zeros_like(l2), value)


def act_stats(z: torch.Tensor) -> torch.Tensor:
    z = z.detach().reshape(-1, z.shape[-1]).double()
    n = z.shape[0]
    l1, sumsq = z.abs().sum(0), z.pow(2).sum(0)
    mean = z.sum(0) / n
    var = (sumsq / n - mean ** 2).clamp(min=0.0)
    return torch.stack([gini(l1, sumsq, n), l1 / n, var], -1).float()


def grad_stats(g: torch.Tensor) -> torch.Tensor:
    g = g.reshape(-1, g.shape[-1]).double()
    n = g.shape[0]
    l1, sumsq = g.abs().sum(0), g.pow(2).sum(0)
    return torch.stack([gini(l1, sumsq, n), l1 / n], -1).float()


def multiplex(z, types, gate: float):
    """F(z) + g z; the binary step passes its gradient straight through."""
    step = z - z.detach() + (z.detach() > 0).to(z.dtype)
    f = torch.where(types == 0, torch.relu(z), torch.where(types == 1, torch.tanh(z), step))
    return f + torch.where(types == 2, torch.full_like(z, gate), torch.ones_like(z)) * z


def tower(p: Params, name: str, x, tw: dict, lens, cfg: dict, prec, zs: List, remat: bool):
    h = tw["num_heads"]
    s = x.shape[1]
    visible = None
    if lens is not None:
        visible = (torch.arange(s, device=x.device)[None, :] < lens[:, None])[:, None, None, :]
    else:
        visible = torch.ones(1, 1, 1, s, dtype=torch.bool, device=x.device)

    def block(x, i):
        b = f"{name}.blocks.{i}."
        q, k, v = (_heads(t, h) for t in linear(layer_norm(x, p, b + "attn_norm"), p,
                                                  b + "attention.qkv_proj", prec).chunk(3, -1))
        att = attend(q, k, v, visible, prec).transpose(1, 2).reshape(x.shape[0], s, -1)
        x = x + linear(att, p, b + "attention.out_proj", prec)
        z = linear(layer_norm(x, p, b + "mlp_norm"), p, b + "stateful.w_in", prec)
        return x, z

    for i in range(tw["num_layers"]):
        b = f"{name}.blocks.{i}."
        x, z = checkpoint(block, x, i, use_reentrant=False) if remat else block(x, i)
        zs.append(z)
        y = multiplex(z, p[b + "stateful.neuron_assignments"], cfg["specialist_gate"])
        x = x + linear(y, p, b + "stateful.w_out", prec)
    return layer_norm(x, p, f"{name}.final_norm")[:, 0]


def forward(p: Params, cfg: dict, images, ids, mask, prec=None, remat: bool = True):
    """(loss, [z of every StatefulLayer, vision then text, in block order])."""
    b, hgt, wid, c = images.shape
    ps = cfg["patch_size"]
    patches = images.reshape(b, hgt // ps, ps, wid // ps, ps, c).permute(0, 1, 3, 2, 4, 5)
    x = linear(patches.reshape(b, -1, ps * ps * c), p, "vision.patch_embed", prec)
    parts = [p["vision.cls_token"].expand(b, -1, -1), x]
    if "vision.register_tokens" in p:
        parts.append(p["vision.register_tokens"].expand(b, -1, -1))
    x = torch.cat(parts, 1) + p["vision.pos_embed"]
    zs: List[torch.Tensor] = []
    img = tower(p, "vision", x, cfg["vision"], None, cfg, prec, zs, remat)
    s = ids.shape[1]
    t = p["text.token_embed.weight"][ids] + p["text.pos_embed"][:, :s]
    txt = tower(p, "text", t, cfg["text"], mask.sum(-1), cfg, prec, zs, remat)
    img = linear(img, {"w.weight": p["image_projection.weight"], "w.bias": None}, "w", prec)
    txt = linear(txt, {"w.weight": p["text_projection.weight"], "w.bias": None}, "w", prec)
    img = img / (img.norm(dim=-1, keepdim=True) + 1e-8)
    txt = txt / (txt.norm(dim=-1, keepdim=True) + 1e-8)
    logits = img @ txt.T * torch.clamp(torch.exp(p["logit_scale"]), max=100.0)
    labels = torch.arange(b, device=logits.device)
    loss = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2
    return loss, zs
