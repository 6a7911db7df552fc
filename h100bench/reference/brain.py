"""Plain reference of the FORDE slow loops, written from their
definitions; it shares no code with the program.

The GMM: 3 full-covariance components, k-means++ seeding drawn from the
given generator (the first centre uniform, each next one by inverse CDF
over the squared distance to the nearest centre), 10 k-means steps, 50 EM
steps, each point to its most probable component. Labels are the GMM's
own, unless a slow loop orders them.

The neuron slow loop (every layer): the per-neuron (F, 5) statistics
[grad gini, grad mean, act gini, act mean, act var], each averaged over
the sensed steps (a quotient, see ``quotient``); the GMM; labels ordered by their members' mean grad
gini; a 3 x 3 mode filter over the near-square grid of the neurons.

The MoE slow loop: each expert's [mean, variance] over the layers of its
mean router usage over the sensed steps; the GMM; a 3 x 3 x 3 mode
filter over the (1, h, w) near-square grid of the experts, extended at
its edges to 3 a side; then every router bias nudged by -0.1 times the
expert's mean usage less 1 / E, clipped to +-0.1, halved for label 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2 * math.pi)


def quotient(steps, device) -> torch.Tensor:
    """The step count as a tensor on the sums' device, so that a mean is
    their quotient: on the GPU a tensor over a Python number is a product
    with the number's reciprocal, one bit off the quotient in places, and
    the GMM can turn one bit into another clustering of a whole layer."""
    return torch.as_tensor(float(steps), dtype=torch.float32, device=device)


def near_square(n: int):
    h = int(n ** 0.5)
    while n % h:
        h -= 1
    return h, n // h


def _sqdist(x, mu):
    return ((x[:, :, None, :] - mu[:, None, :, :]) ** 2).sum(-1)


def _log_prob(x, means, covs):
    chol, _ = torch.linalg.cholesky_ex(covs)
    diff = x[:, None] - means[:, :, None]
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2), upper=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * (x.shape[-1] * LOG_2PI + logdet[..., None] + (sol ** 2).sum(-2))).transpose(1, 2)


def gmm(x: torch.Tensor, k: int, generator: Optional[torch.Generator], iters: int = 50,
        kmeans_iters: int = 10, reg: float = 1e-6) -> torch.Tensor:
    """Assignments (L, N) of a GMM fitted to each of L problems (L, N, D)."""
    layers, n, d = x.shape
    rows = torch.arange(layers, device=x.device)
    first = torch.randint(n, (layers,), generator=generator, device=x.device)
    means = x[rows, first][:, None, :].repeat(1, k, 1)
    for i in range(1, k):
        d2 = _sqdist(x, means[:, :i]).amin(-1)
        cdf = torch.cumsum(d2 / (d2.sum(-1, keepdim=True) + 1e-12), -1)
        u = torch.rand(layers, 1, generator=generator, device=x.device)
        pick = torch.searchsorted(cdf, cdf[:, -1:] * (1.0 - u)).squeeze(-1).clamp(max=n - 1)
        means[:, i] = x[rows, pick]
    for _ in range(kmeans_iters):
        resp = F.one_hot(_sqdist(x, means).argmin(-1), k).to(x.dtype)
        counts = resp.sum(1)
        means = torch.where(counts[..., None] > 0,
                            (resp.transpose(1, 2) @ x) / counts.clamp(min=1.0)[..., None], means)
    resp = F.one_hot(_sqdist(x, means).argmin(-1), k).float()
    eye = torch.eye(d, device=x.device)

    def m_step(resp):
        nk = resp.sum(1) + 1e-10
        mu = (resp.transpose(1, 2) @ x) / nk[..., None]
        diff = x[:, :, None, :] - mu[:, None, :, :]
        cov = torch.einsum("lnk,lnkd,lnke->lkde", resp, diff, diff) / nk[..., None, None] + reg * eye
        return nk / n, mu, cov

    weights, means, covs = m_step(resp)
    for _ in range(iters):
        log_resp = torch.log_softmax(_log_prob(x, means, covs)
                                     + torch.log(weights + 1e-12)[:, None, :], dim=-1)
        weights, means, covs = m_step(torch.exp(log_resp))
    return (_log_prob(x, means, covs) + torch.log(weights + 1e-12)[:, None, :]).argmax(-1)


def by_grad_gini(assign, grad_gini, k: int):
    """Relabel clusters by ascending mean grad gini of their members (empty
    clusters last, ties kept in label order)."""
    resp = F.one_hot(assign, k).float()
    counts = resp.sum(-2)
    means = (resp * grad_gini[..., None]).sum(-2) / counts.clamp(min=1.0)
    means = torch.where(counts > 0, means, torch.full_like(means, float("inf")))
    rank = torch.argsort(torch.argsort(means, dim=-1, stable=True), dim=-1)
    return torch.gather(rank, -1, assign)


def mode_filter(grid, k: int = 3, size: int = 3):
    """(L, H, W) labels -> the most frequent label in each cell's size x
    size box (zeros outside a grid padded to size + 1 a side; ties to the
    lowest label)."""
    layers, h, w = grid.shape
    ph, pw = max(0, size + 1 - h), max(0, size + 1 - w)
    onehot = F.pad(F.one_hot(grid, k).permute(0, 3, 1, 2).float(),
                   (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    lo, hi = (size - 1) // 2, size - 1 - (size - 1) // 2
    x = F.pad(onehot.reshape(layers * k, 1, *onehot.shape[2:]), (lo, hi, lo, hi))
    counts = F.conv2d(x, torch.ones(1, 1, size, size, device=x.device))
    counts = counts.reshape(layers, k, *onehot.shape[2:])[:, :, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
    return counts.argmax(1)


def neuron_types(stats5: torch.Tensor, generator, k: int = 3) -> torch.Tensor:
    """New types (L, F) of layers of one width from their (L, F, 5) stats."""
    f = stats5.shape[1]
    labels = by_grad_gini(gmm(stats5, k, generator), stats5[..., 0], k)
    gh, gw = near_square(f)
    return mode_filter(labels.reshape(-1, gh, gw), k).reshape(-1, f)


def slow_loop_types(act: Dict[str, torch.Tensor], grad: Dict[str, torch.Tensor], steps: int,
                    generator) -> Dict[str, torch.Tensor]:
    """The neuron slow loop's new types {layer: (F,)} from the sensed sums
    {layer: (F, 3)} and {layer: (F, 2)} of ``steps`` steps: layers of one
    width in one GMM call, in the model's order (``act``'s: vision blocks
    0 to L - 1, then text)."""
    by_width: Dict[int, List[str]] = {}
    for n in act:
        by_width.setdefault(act[n].shape[0], []).append(n)
    steps = quotient(steps, next(iter(act.values())).device)
    out = {}
    for group in by_width.values():
        stats5 = torch.stack([torch.cat([grad[n].float() / steps, act[n].float() / steps], -1)
                              for n in group])
        out.update(zip(group, neuron_types(stats5, generator)))
    return out


def mode_filter_3d(grid: torch.Tensor, k: int = 3, size: int = 3) -> torch.Tensor:
    """(D, H, W) labels -> the most frequent label in each cell's size^3
    box, over the grid extended by its edge cells to at least ``size`` a
    side (nothing counted past that; ties to the lowest label)."""
    shape = grid.shape
    pads = [max(0, size - n) for n in shape]
    idx = [(torch.arange(n + p) - p // 2).clamp(0, n - 1) for n, p in zip(shape, pads)]
    ext = grid.cpu()[idx[0]][:, idx[1]][:, :, idx[2]]
    lo, hi = (size - 1) // 2, size - 1 - (size - 1) // 2
    out = torch.empty(shape, dtype=torch.long)
    for a in range(shape[0]):
        for b in range(shape[1]):
            for c in range(shape[2]):
                i, j, m = a + pads[0] // 2, b + pads[1] // 2, c + pads[2] // 2
                box = ext[max(i - lo, 0):i + hi + 1, max(j - lo, 0):j + hi + 1,
                          max(m - lo, 0):m + hi + 1]
                out[a, b, c] = torch.bincount(box.reshape(-1).long(), minlength=k).argmax()
    return out


def router_nudges(usage_sum: torch.Tensor, steps: int, generator, k: int = 3,
                  target: float = 0.1, most: float = 0.1, damping: float = 0.5) -> torch.Tensor:
    """The MoE slow loop's nudge (E,) of every router bias from the
    routers' usage (L, E) summed over ``steps`` steps."""
    usage = usage_sum.float() / quotient(steps, usage_sum.device)
    mean, var = usage.mean(0), usage.var(0, unbiased=False)
    labels = gmm(torch.stack([mean, var], -1)[None], k, generator)[0]
    e = mean.shape[0]
    gh, gw = near_square(e)
    labels = mode_filter_3d(labels.reshape(1, gh, gw), k).reshape(-1).to(mean.device)
    nudge = torch.clamp(-(mean - 1.0 / e) * target, -most, most)
    return torch.where(labels == 1, nudge * damping, nudge)
