"""Gaussian mixture model fitted on the device (port of
forde_tpu/ops/gmm.py): k-means++ seeding, a few k-means steps, then
full-covariance EM, each a fixed number of iterations with no host
synchronisation.

Every function takes a batch of independent problems: x is (L, N, D), or
(N, D) for one. The slow loop fits all StatefulLayers of one width in one
call. Shapes are tiny (N neurons, D = 5 statistics, K = 3 clusters), so
this is plain PyTorch: no TPU kernel stands behind it.

k-means++ draws from a ``torch.Generator``, which gives other numbers than
``jax.random`` from the same seed; ``fit_gmm(init_means=...)`` starts from
given means instead, so that a test can start both packages alike.
``torch.linalg.cholesky_ex`` keeps JAX's behaviour on a covariance that is
not positive definite: no exception and no host synchronisation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_LOG_2PI = 1.8378770664093453


def _pairwise_sqdist(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(L, N, D), (L, K, D) -> (L, N, K) squared euclidean distances."""
    return ((x[:, :, None, :] - mu[:, None, :, :]) ** 2).sum(-1)


def _kmeans_pp_init(
    x: torch.Tensor, k: int, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """k-means++ seeding of (L, N, D): the first center uniform, each next
    one drawn with probability proportional to D^2 (``jax.random.choice``'s
    inverse-CDF draw, which needs no positive total)."""
    l, n, _ = x.shape
    rows = torch.arange(l, device=x.device)
    first = torch.randint(n, (l,), generator=generator, device=x.device)
    means = x[rows, first][:, None, :].repeat(1, k, 1)
    for i in range(1, k):
        min_d2 = _pairwise_sqdist(x, means[:, :i]).amin(-1)
        probs = min_d2 / (min_d2.sum(-1, keepdim=True) + 1e-12)
        cdf = torch.cumsum(probs, -1)
        u = torch.rand(l, 1, generator=generator, device=x.device)
        idx = torch.searchsorted(cdf, cdf[:, -1:] * (1.0 - u)).squeeze(-1).clamp(max=n - 1)
        means[:, i] = x[rows, idx]
    return means


def _kmeans_refine(
    x: torch.Tensor, means: torch.Tensor, iters: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    k = means.shape[1]
    for _ in range(iters):
        assign = _pairwise_sqdist(x, means).argmin(-1)
        resp = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # (L, N, K)
        counts = resp.sum(1)
        new_means = (resp.transpose(1, 2) @ x) / counts.clamp(min=1.0)[..., None]
        # Empty clusters stay where they were.
        means = torch.where(counts[..., None] > 0, new_means, means)
    return means, _pairwise_sqdist(x, means).argmin(-1)


def _gaussian_log_prob(
    x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor
) -> torch.Tensor:
    """log N(x | mu_k, Sigma_k) for all k: (L, N, D) -> (L, N, K)."""
    chol, _ = torch.linalg.cholesky_ex(covs)  # (L, K, D, D)
    diff = x[:, None, :, :] - means[:, :, None, :]  # (L, K, N, D)
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2), upper=False)
    maha = (sol ** 2).sum(-2)  # (L, K, N)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    d = x.shape[-1]
    return (-0.5 * (d * _LOG_2PI + logdet[..., None] + maha)).transpose(1, 2)


def fit_gmm(
    x: torch.Tensor,
    num_clusters: int,
    generator: Optional[torch.Generator] = None,
    num_iters: int = 50,
    kmeans_iters: int = 10,
    reg_covar: float = 1e-6,
    init_means: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fit a full-covariance GMM to (N, D) or (L, N, D) data on its device.

    Returns (assignments int32 (…, N), {weights, means, covariances}).
    ``init_means`` ((…, K, D)) replaces the k-means++ seeding. Cluster
    labels are arbitrary.
    """
    single = x.dim() == 2
    x = (x[None] if single else x).float()
    l, n, d = x.shape
    k = num_clusters
    eye = torch.eye(d, dtype=torch.float32, device=x.device)

    if init_means is None:
        means = _kmeans_pp_init(x, k, generator)
    else:
        means = init_means.float().reshape(l, k, d).to(x.device)
    means, assign = _kmeans_refine(x, means, kmeans_iters)
    resp = torch.nn.functional.one_hot(assign, k).float()

    def m_step(resp):
        nk = resp.sum(1) + 1e-10  # (L, K)
        weights = nk / n
        means = (resp.transpose(1, 2) @ x) / nk[..., None]
        diff = x[:, :, None, :] - means[:, None, :, :]  # (L, N, K, D)
        covs = (
            torch.einsum("lnk,lnkd,lnke->lkde", resp, diff, diff) / nk[..., None, None]
            + reg_covar * eye
        )
        return weights, means, covs

    weights, means, covs = m_step(resp)
    for _ in range(num_iters):
        log_prob = _gaussian_log_prob(x, means, covs)
        log_resp = torch.log_softmax(log_prob + torch.log(weights + 1e-12)[:, None, :], dim=-1)
        weights, means, covs = m_step(torch.exp(log_resp))

    posterior = _gaussian_log_prob(x, means, covs) + torch.log(weights + 1e-12)[:, None, :]
    assignments = posterior.argmax(-1).to(torch.int32)
    params = {"weights": weights, "means": means, "covariances": covs}
    if single:
        assignments = assignments[0]
        params = {key: v[0] for key, v in params.items()}
    return assignments, params
