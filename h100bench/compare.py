"""The numbers that decide ``correct``, each read against the reference.

Training (per leaf: each parameter tensor, and each of the q, k and v
parts of a fused projection, ``FUSED``, since a key's bias can be nought
to rounding beside the query's and value's). The gap of a leaf's norm is
|program's norm - reference's norm| over the larger of the reference's
norm of that leaf and of the median leaf, so that a gradient that is all
but zero does not blow up its gap; the worst leaf is the number.

* ``loss``: the largest relative gap of the total loss over the checked
  steps;
* ``first_grad``: the worst leaf of the first step's clipped gradient;
* ``change``: the worst leaf of the parameters' change after the checked
  steps, over the leaves the reference moves by its gradient: a leaf whose
  first gradient is under a thousandth of the median leaf's moves by
  weight decay and round-off alone (a key's bias under softmax, a scorer
  that only picks positions) and is left out;
* ``first_grad_rows``: the median over the token embedding's rows (a row
  a token id of the batch) of the gap of each row's first gradient;
* ``usage`` (LM): the largest relative gap of the router's summed usage,
  the input of the MoE slow loop;
* ``router`` (LM): the MoE slow loop's change of the router biases
  against the reference's slow loop on the program's usage, the widest
  gap over the largest nudge;
* ``sensed`` (dual encoder): the sensed activation and gradient sums;
* ``slow_loop`` (dual encoder): the share of neurons the slow loop types
  otherwise than the reference's slow loop on the program's sensed sums;
* ``slow_loop_median`` (dual encoder): the median over the layers of each
  layer's such share. The GMM is not continuous in its input: a mean one
  bit off can seed or settle one layer's clustering otherwise and retype
  most of that layer, so the whole share swings from seed to seed by a
  layer at a time; the median layer does not.

The slow loops are checked from the program's own sums: which expert or
neuron a rounding flips upstream reorders the GMM's input, so the
reference follows the program from there, and the sums themselves are
checked by ``usage`` and ``sensed``.

Serving: ``logit_gap``, the widest amount by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from h100bench.common import Check

MOVED = 1e-3  # a leaf moves by its gradient above this share of the median leaf's
FUSED = {"qkv_proj": 3}  # projections fused along their output rows: q, k, v


def parts(name: str, t: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A tensor as the comparison's leaves: itself, or a fused
    projection's parts along its output rows."""
    for key, n in FUSED.items():
        if f".{key}." in f".{name}":
            return {f"{name}[{i}]": c for i, c in enumerate(t.chunk(n, 0))}
    return {name: t}


def leaf_norms(named) -> Dict[str, float]:
    """{leaf: norm} of (name, tensor) pairs, fused projections in parts."""
    return {leaf: float(c.float().norm()) for name, t in named
            for leaf, c in parts(name, t).items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> float:
    names = list(ref) if leaves is None else list(leaves)
    floor = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names)


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], leaves, n: int = 5) -> list:
    """The ``n`` leaves of the widest gaps: [leaf, gap, program's norm,
    reference's norm] (a calibration's detail)."""
    floor = statistics.median(ref[k] for k in leaves)
    gaps = [[k, abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30), prog[k], ref[k]] for k in leaves]
    return sorted(gaps, key=lambda g: -g[1])[:n]


def moved_leaves(first_grad: Dict[str, float]) -> List[str]:
    floor = MOVED * statistics.median(first_grad.values())
    return [n for n, g in first_grad.items() if g >= floor]


def row_median(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Median over the rows the gradient reaches of the gap of each row's
    norm, relative to the reference's."""
    seen = ref > 0
    return float(((prog[seen] - ref[seen]).abs() / ref[seen]).median())


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers every training cell reads."""
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "first_grad": worst_leaf(prog["grad_norms"], ref["grad_norms"]),
        "first_grad_rows": row_median(prog["embed_rows"], ref["embed_rows"]),
        "change": worst_leaf(prog["change_norms"], ref["change_norms"],
                             moved_leaves(ref["grad_norms"])),
    }


def change_detail(prog: dict, ref: dict) -> dict:
    """A calibration's look at ``change``: its worst leaves, and the
    number with every fused projection counted as one leaf."""

    def whole(norms):
        out: Dict[str, float] = {}
        for leaf, v in norms.items():
            name = leaf.split("[")[0]
            out[name] = (out.get(name, 0.0) ** 2 + v ** 2) ** 0.5
        return out

    leaves = moved_leaves(ref["grad_norms"])
    ref_whole = whole(ref["change_norms"])
    return {"worst": worst_leaves(prog["change_norms"], ref["change_norms"], leaves),
            "change_whole": worst_leaf(whole(prog["change_norms"]), ref_whole,
                                       moved_leaves(whole(ref["grad_norms"])))}


def usage_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst (layer, expert) relative gap of the router's summed usage."""
    return float(((prog - ref).abs() / ref.abs().clamp(min=1e-30)).max())


def router_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The program's change of every layer's router bias (L, E) against
    the reference's nudge (E,): the widest gap over the largest nudge."""
    ref = ref.float().cpu()
    return float((prog.float().cpu() - ref[None]).abs().max() / ref.abs().max().clamp(min=1e-30))


def stat_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """Sensed sums, {layer: (F, k)}: the worst layer and statistic of the
    median over neurons of each neuron's relative gap."""
    worst = 0.0
    for name, r in ref.items():
        r = r.float().cpu()
        gap = (prog[name].float().cpu() - r).abs() / r.abs().clamp(min=1e-30)
        worst = max(worst, float(gap.median(dim=0).values.max()))
    return worst


def type_share(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The share of neurons whose new type differs from the reference's."""
    differ = sum(int((prog[n].cpu() != r.cpu()).sum()) for n, r in ref.items())
    return differ / sum(r.numel() for r in ref.values())


def layer_type_shares(prog: Dict[str, torch.Tensor],
                      ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{layer: the share of its neurons whose new type differs}."""
    return {n: float((prog[n].cpu() != r.cpu()).float().mean()) for n, r in ref.items()}


def checks(numbers: Dict[str, float], limits: dict) -> List[Check]:
    """Every number that has a limit, beside it (a number the limits file
    leaves out is read but not held: see PERF.md)."""
    return [Check(name, float(value), float(limits[name]))
            for name, value in numbers.items() if name in limits]


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap, over positions, between the reference's best logit and
    its logit of the served token: ``ref_logits`` (N, V) fp32 at the
    positions that produced ``tokens`` (N,)."""
    best = ref_logits.max(dim=-1).values
    served = ref_logits.gather(1, tokens[:, None].long())[:, 0]
    return float((best - served).max())
