"""Speculative decoding: a small draft model proposes, the target verifies
(port of forde_tpu/models/speculative.py).

Each round the draft proposes ``gamma`` tokens one at a time; the target
scores all of them in one chunked cached forward over ``[pending, d_1 ..
d_gamma]``; proposal ``d_i`` is accepted with probability ``min(1,
p_i(d_i) / q_i(d_i))``, and at the first rejection a replacement is drawn
from ``norm(max(p - q, 0))`` (after all ``gamma`` accepted, the bonus
token from the target's next distribution). The output distribution is
the target's: greedy decoding gives ``generate_cached``'s tokens exactly,
while the target runs (accepted + 1) tokens per forward.

The dense decode caches mask keys by ``cache_index``/``pos_index``, so a
rejection rolls a cache back by setting those counters (``_rollback``):
stale k/v rows are masked, then overwritten. The counters are device
tensors that the model reads, so they are set in place.

The JAX package runs the rounds as one ``lax.while_loop``; here they are
a host loop that reads the accepted count (and the EOS flag) once per
round. Dense-causal configs only (NSA's streaming caches cannot be
rewound) and batch 1 (per-row acceptance would diverge).
"""

from __future__ import annotations

from typing import Optional

import torch

from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.models.generate import _categorical, _filter_logits


def _dist(logits: torch.Tensor, temperature: float, top_k: Optional[int],
          top_p: Optional[float]) -> torch.Tensor:
    """(..., V) fp32 logits -> the distribution sampling draws from
    (one-hot at the first argmax when temperature == 0)."""
    if temperature == 0:
        return torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                           logits.shape[-1]).float()
    return torch.softmax(_filter_logits(logits / temperature, top_k, top_p), dim=-1)


def _rollback(cache: dict, new_index: int) -> None:
    """Rewind a dense decode cache to ``new_index`` tokens, in place: every
    ``cache_index``/``pos_index`` counter is set; k/v rows past it stay
    and are masked."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            _rollback(leaf, new_index)
        elif name in ("cache_index", "pos_index"):
            leaf.fill_(new_index)


def _draw(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of (..., V) probabilities (zeros never drawn)."""
    return _categorical(torch.log(probs), generator)


@torch.no_grad()
def generate_speculative(
    model: FORDEDecoderLM,
    draft_model: FORDEDecoderLM,
    prompt_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 32,
    gamma: int = 4,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    with_stats: bool = False,
):
    """Sample ``max_new_tokens`` continuations of ``prompt_ids`` (1, P) from
    the target ``model``'s distribution, with ``draft_model`` proposing.

    Returns (1, P + max_new_tokens) ids (after a row's first EOS,
    ``pad_id``), or ``(ids, stats)`` with ``with_stats``: {"rounds": target
    forwards, "generated": new tokens kept} (tokens per forward =
    generated / rounds).
    """
    cfg, dcfg = model.config, draft_model.config
    if cfg.use_sparse_attention or dcfg.use_sparse_attention:
        raise ValueError("speculative decoding requires dense-causal configs (NSA's streaming "
                         "caches cannot be rewound)")
    if cfg.vocab_size != dcfg.vocab_size:
        raise ValueError(f"target and draft vocabularies differ ({cfg.vocab_size} vs "
                         f"{dcfg.vocab_size})")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    b, p = prompt_ids.shape
    if b != 1:
        raise ValueError(f"speculative decoding is the batch-1 latency path, got batch {b}")
    buflen = p + max_new_tokens + gamma + 1
    if buflen > min(cfg.max_seq_len, dcfg.max_seq_len):
        raise ValueError(f"prompt + max_new_tokens + gamma overruns max_seq_len ({buflen})")
    dev = prompt_ids.device
    sampling = (temperature, top_k, top_p)

    t_cache, d_cache = model.init_cache(1, dev), draft_model.init_cache(1, dev)
    # The caches hold the accepted sequence but its last, "pending" token,
    # which each round feeds first.
    if p > 1:
        model(prompt_ids[:, :-1], cache=t_cache)
        draft_model(prompt_ids[:, :-1], cache=d_cache)
    pending = prompt_ids[:, -1].to(torch.int64)
    ids = torch.zeros(1, buflen, dtype=torch.int64, device=dev)
    ids[:, :p] = prompt_ids
    steps = torch.arange(gamma, device=dev)
    n = rounds = 0
    done = False
    while n < max_new_tokens and not done:
        # Draft: feed [pending, d_1 .. d_gamma-1], drawing d_1 .. d_gamma.
        tok, d_toks, q_probs = pending, [], []
        for _ in range(gamma):
            logits, _ = draft_model(tok[:, None], cache=d_cache)
            q = _dist(logits[:, -1].float(), *sampling)  # (1, V)
            tok = _draw(q, generator)
            d_toks.append(tok)
            q_probs.append(q[0])
        # ... and ingest d_gamma, so that the draft's cache keeps pace with
        # the target's when every proposal is accepted.
        draft_model(tok[:, None], cache=d_cache)
        d_flat = torch.cat(d_toks)  # (gamma,)
        q_all = torch.stack(q_probs)  # (gamma, V)

        # Target: one chunked forward over [pending, d_1 .. d_gamma].
        chunk = torch.cat([pending, d_flat])[None]
        logits, _ = model(chunk, cache=t_cache)
        p_all = _dist(logits[0].float(), *sampling)  # (gamma + 1, V); row gamma: the bonus

        p_at = p_all[steps, d_flat]
        q_at = torch.clamp(q_all[steps, d_flat], min=1e-30)
        u = torch.rand(gamma, device=dev, generator=generator)
        accept = torch.cat([u < p_at / q_at, torch.zeros(1, dtype=torch.bool, device=dev)])
        k_acc = torch.argmin(accept.to(torch.int32))  # the first rejection; gamma if none

        # The replacement (or bonus) from the residual max(p - q, 0).
        q_ext = torch.cat([q_all, torch.zeros_like(q_all[:1])])
        p_r, q_r = p_all[k_acc], q_ext[k_acc]
        resid = torch.clamp(p_r - q_r, min=0.0)
        norm = resid.sum()
        resid = torch.where(norm > 0, resid / torch.clamp(norm, min=1e-30), p_r)
        emit = torch.cat([d_flat, torch.zeros(1, dtype=torch.int64, device=dev)])
        emit[k_acc] = _draw(resid, generator)
        ids[0, p + n: p + n + gamma + 1] = emit
        hit = torch.zeros((), dtype=torch.bool, device=dev)
        if eos_id is not None:
            hit = ((torch.arange(gamma + 1, device=dev) <= k_acc) & (emit == eos_id)).any()
        k, eos_hit = torch.stack([k_acc, hit.to(k_acc.dtype)]).tolist()  # one read a round
        done = bool(eos_hit)

        # Both caches back to the accepted length (the pending token aside).
        _rollback(t_cache, p + n + k)
        _rollback(d_cache, p + n + k)
        n += k + 1
        pending = emit[k:k + 1]
        rounds += 1

    if eos_id is not None:
        pos = torch.arange(buflen, device=dev)
        is_eos = (ids == eos_id) & (pos[None] >= p)
        first = torch.where(is_eos.any(-1), torch.argmax(is_eos.to(torch.int32), -1), buflen)
        ids = torch.where(pos[None] > first[:, None], pad_id, ids)
    out = ids[:, : p + max_new_tokens]
    if with_stats:
        # The last round may overshoot max_new_tokens; count what is kept.
        return out, {"rounds": rounds, "generated": min(n, max_new_tokens)}
    return out
