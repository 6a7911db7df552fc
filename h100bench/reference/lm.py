"""Plain reference of the FORDE decoder LM (MoE + NSA + mHC), written from
the model's equations; it shares no code with the program.

Per block (pre-norm): NSA over the norm of stream 0, mixed into the
streams by a Sinkhorn-normalised matrix; a routed MoE FFN over the norm of
the new stream 0, mixed in again. Embeddings: token + learned position,
streams [x, stream_init(x)]. Head: softmax-weighted sum of the streams,
the final norm, ``lm_head``. Products run in fp32 (or with their operands
and results rounded, ``precision``: ``lowp``); norms, softmaxes and the
loss in fp32.

NSA, per query at position i of a sequence whose first ``prompt_len``
positions are a prompt (a teacher-forced forward has prompt_len = T):

* window: keys i - w < j <= i;
* compressed: pools of ``ratio`` positions. A prompt query sees the
  prompt's pools, p < max(max(P - w, r) // r, 1) (positions past P wrap
  to the start), from position (p + 1) r on; a later query the pools of
  every complete chunk with (p + 1) r + w - 1 <= i;
* top-k: a prompt query attends over the prompt's k highest importance
  scores (ties to the lower index), those at or before it; a later query
  over the k highest scores among positions <= i;
* a masked score is -1e9, so a query that sees no key attends uniformly
  over the branch's keys; each global branch is gated by a sigmoid and by
  its length rule (compressed: L - w > r, top-k: L > w), L = P for a
  prompt query and i + 1 for a later one.

The routed FFN computes each expert on the tokens routed to it (top-k of
the router's logits, weights the softmax over those logits), which equals
dense dispatch's sum: an expert not chosen has weight 0. The aux loss is
E * sum_e (share of routed slots_e * mean probability_e) times the
configuration's weight; the sensed usage is the mean router probability.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference.lowp import out as rout
from h100bench.reference.lowp import rnd

NEG = -1e9
Params = Dict[str, torch.Tensor]


def linear(x, p: Params, name: str, prec) -> torch.Tensor:
    return rout(F.linear(rnd(x, prec), rnd(p[name + ".weight"], prec), p[name + ".bias"]), prec)


def mm(a, b, prec) -> torch.Tensor:
    return rout(rnd(a, prec) @ rnd(b, prec), prec)


def layer_norm(x, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-6)


def attend(q, k, v, visible, prec, fill: float = NEG) -> torch.Tensor:
    """Softmax attention of (B, H, S, D) queries over (B, H, K, D) keys;
    ``visible`` broadcasts to (B, H, S, K); hidden scores read ``fill``."""
    scores = mm(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    scores = torch.where(visible, scores, torch.full_like(scores, fill))
    return mm(torch.softmax(scores, dim=-1), v, prec)


def _heads(t, h):
    b, s, _ = t.shape
    return t.reshape(b, s, h, -1).transpose(1, 2)


def _merge(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def nsa(p: Params, a: str, x, cfg: dict, prompt_len: int, prec) -> torch.Tensor:
    b, t, _ = x.shape
    h, w = cfg["num_heads"], cfg["window_size"]
    r, k = cfg["compression_ratio"], cfg["top_k_global"]
    dev = x.device
    pos = torch.arange(t, device=dev)
    prompt = pos < prompt_len
    q, kk, vv = (_heads(y, h) for y in linear(x, p, a + "local_attention.qkv_proj", prec).chunk(3, -1))
    diff = pos[:, None] - pos[None, :]
    out = linear(_merge(attend(q, kk, vv, (diff >= 0) & (diff < w), prec)), p,
                 a + "local_attention.out_proj", prec)
    length = torch.where(prompt, torch.full_like(pos, prompt_len), pos + 1)
    use_c = ((length - w) > r).to(x.dtype)[None, :, None]
    use_t = (length > w).to(x.dtype)[None, :, None]

    # compressed branch
    qc = _heads(linear(x, p, a + "compressed_q_proj", prec), h)

    def pooled(means, visible):
        kc = _heads(linear(means, p, a + "compressed_k_proj", prec), h)
        vc = _heads(linear(means, p, a + "compressed_v_proj", prec), h)
        return attend(qc, kc, vc, visible, prec)

    n_prompt = max(max(prompt_len - w, r) // r, 1)
    wrap = torch.arange(n_prompt * r, device=dev) % prompt_len
    means = x[:, wrap].reshape(b, n_prompt, r, -1).mean(2)
    seen = pos[:, None] >= (torch.arange(n_prompt, device=dev) + 1)[None, :] * r
    comp = pooled(means, seen)
    if prompt_len < t:
        n_all = t // r
        means = x[:, : n_all * r].reshape(b, n_all, r, -1).mean(2)
        seen = ((torch.arange(n_all, device=dev) + 1) * r + w - 1)[None, :] <= pos[:, None]
        comp = torch.where(prompt[:, None], comp, pooled(means, seen))
    gate = torch.sigmoid(linear(x, p, a + "gate_compressed", prec))
    out = out + use_c * gate * linear(_merge(comp), p, a + "compressed_out_proj", prec)

    # top-k branch: the scores only pick positions
    imp = linear(x, p, a + "importance_scorer", prec)[..., 0].detach()
    qt = _heads(linear(x, p, a + "topk_q_proj", prec), h)
    k_sel = min(k, prompt_len)
    idx = torch.sort(imp[:, :prompt_len], dim=-1, descending=True, stable=True).indices[:, :k_sel]
    sel = x[torch.arange(b, device=dev)[:, None], idx]
    kt = _heads(linear(sel, p, a + "topk_k_proj", prec), h)
    vt = _heads(linear(sel, p, a + "topk_v_proj", prec), h)
    top = attend(qt, kt, vt, (pos[None, :, None] >= idx[:, None, :])[:, None], prec)
    if prompt_len < t:
        # j is among the k best of positions <= i: fewer than k of them beat it
        beats = (imp[:, :, None] > imp[:, None, :]) | (
            (imp[:, :, None] == imp[:, None, :]) & (pos[:, None] < pos[None, :]))
        rank = torch.cumsum(beats.to(torch.int32), dim=1)  # [b, i, j]: beaters of j in 0..i
        member = (pos[None, None, :] <= pos[None, :, None]) & (rank < k)
        ka = _heads(linear(x, p, a + "topk_k_proj", prec), h)
        va = _heads(linear(x, p, a + "topk_v_proj", prec), h)
        late = attend(qt, ka, va, member[:, None], prec, fill=-math.inf)
        top = torch.where(prompt[:, None], top, late)
    gate = torch.sigmoid(linear(x, p, a + "gate_top_k", prec))
    return out + use_t * gate * linear(_merge(top), p, a + "topk_out_proj", prec)


def moe(p: Params, m: str, x, cfg: dict, prec) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(output, aux loss with its weight, mean router probability (E,))."""
    e_n, top_k = cfg["num_experts"], cfg["top_k_experts"]
    logits = linear(x, p, m + "router.router_linear", prec)
    probs = torch.softmax(logits, dim=-1)
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_idx = top_logits[..., :top_k], top_idx[..., :top_k]
    gates = torch.softmax(top_logits, dim=-1)
    flat = x.reshape(-1, x.shape[-1])
    out = torch.zeros_like(flat)
    weight = (gates[..., None] * F.one_hot(top_idx, e_n)).sum(-2).reshape(-1, e_n)
    routed = F.one_hot(top_idx, e_n).sum(-2).reshape(-1, e_n) > 0
    for e in range(e_n):
        rows = routed[:, e].nonzero()[:, 0]
        hid = mm(flat[rows], p[m + "experts.w_up"][e], prec) + p[m + "experts.b_up"][e]
        y = mm(F.gelu(hid, approximate="tanh"), p[m + "experts.w_down"][e], prec)
        y = y + p[m + "experts.b_down"][e]
        out = out.index_add(0, rows, y * weight[rows, e, None])
    fraction = F.one_hot(top_idx.reshape(-1), e_n).sum(0).float() / (flat.shape[0] * top_k)
    usage = probs.reshape(-1, e_n).mean(0)
    aux = e_n * torch.sum(fraction * usage) * cfg["moe_aux_loss_weight"]
    return out.reshape(x.shape), aux, usage.detach()


def mix(logits, streams, sub, iterations: int, prec):
    """Mix the streams by Sinkhorn-Knopp of exp(logits), add ``sub`` into
    stream 0; (new streams, stream 0)."""
    m = torch.exp(logits) + 1e-8
    for _ in range(iterations):
        m = m / (m.sum(1, keepdim=True) + 1e-8)
        m = m / (m.sum(0, keepdim=True) + 1e-8)
    mixed = rout(torch.einsum("ij,bsjd->bsid", rnd(m, prec), rnd(streams, prec)), prec)
    mixed = mixed + F.pad(sub[:, :, None, :], (0, 0, 0, streams.shape[2] - 1))
    return mixed, mixed[:, :, 0]


def block(p: Params, i: int, streams, cfg: dict, prompt_len: int, prec):
    pre = f"layers.{i}."
    x = layer_norm(streams[:, :, 0], p, pre + "attn_norm")
    attn = nsa(p, pre + "sparse_attention.", x, cfg, prompt_len, prec)
    streams, working = mix(p[pre + "mhc_attn.mixing_logits"], streams, attn,
                           cfg["sinkhorn_iterations"], prec)
    ffn, aux, usage = moe(p, pre + "moe.moe_layer.", layer_norm(working, p, pre + "ffn_norm"),
                          cfg, prec)
    streams, _ = mix(p[pre + "mhc_ffn.mixing_logits"], streams, ffn, cfg["sinkhorn_iterations"], prec)
    return streams, aux, usage


def forward(p: Params, cfg: dict, ids: torch.Tensor, prompt_len: Optional[int] = None,
            prec=None, remat: bool = False):
    """(fp32 logits (B, T, V), summed aux loss, usage (L, E)) of ``ids``
    (B, T); ``prompt_len`` < T gives the positions past it the streaming
    semantics of decoded tokens. ``remat`` recomputes each block in the
    backward (memory: the reference's attention is a full (T, T) product)."""
    b, t = ids.shape
    prompt_len = t if prompt_len is None else prompt_len
    x = p["token_embed.weight"][ids] + p["pos_embed.weight"][:t][None]
    extra = linear(x, p, "initial_streams.stream_init", prec).reshape(b, t, -1, x.shape[-1])
    streams = torch.cat([x[:, :, None], extra], dim=2)
    aux_total = torch.zeros((), device=ids.device)
    usage: List[torch.Tensor] = []
    for i in range(cfg["num_layers"]):
        if remat:
            streams, aux, u = checkpoint(block, p, i, streams, cfg, prompt_len, prec,
                                         use_reentrant=False)
        else:
            streams, aux, u = block(p, i, streams, cfg, prompt_len, prec)
        aux_total = aux_total + aux
        usage.append(u)
    weights = torch.softmax(p["stream_collapser.stream_weights"], dim=0)
    x = layer_norm(torch.einsum("bsnd,n->bsd", streams, weights), p, "final_norm")
    return linear(x, p, "lm_head", prec), aux_total, torch.stack(usage)


def loss(p: Params, cfg: dict, ids: torch.Tensor, aux_weight: float, prec=None,
         remat: bool = True):
    """(total loss, usage): the next-token cross-entropy plus
    ``aux_weight`` times the summed aux loss."""
    logits, aux, usage = forward(p, cfg, ids, prec=prec, remat=remat)
    lm = F.cross_entropy(logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten())
    return lm + aux_weight * aux, usage
