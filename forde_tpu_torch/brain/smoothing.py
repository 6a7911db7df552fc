"""Mode filter over neuron- and expert-assignment grids (port of
forde_tpu/brain/smoothing.py).

One-hot encode -> per-cluster box filter -> argmax, with the box filter as
ONE convolution whose batch axis carries every (grid, cluster) pair. The
filter sums the one-hot counts with weights 1 rather than the JAX
package's 1/k^n: the same argmax, and ties between clusters stay exact
ties, which ``argmax`` gives to the lowest label.

Padding as in the JAX package: 2-D grids (the neuron slow loop) are
zero-padded (split evenly) so that each dim is at least kernel_size + 1;
3-D grids (the MoE slow loop) are edge-padded where a dim is smaller than
the kernel; then a SAME convolution and a crop.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def near_square_grid(n: int) -> Tuple[int, int]:
    """Largest-divisor near-square factorisation (h, w), h * w = n."""
    h = int(n ** 0.5)
    while n % h != 0:
        h -= 1
    return h, n // h


def smooth_assignments(
    assignment_grid: torch.Tensor, kernel_size: int = 3, num_clusters: int = 3
) -> torch.Tensor:
    """Mode-filter a (H, W) or (L, H, W) assignment grid."""
    single = assignment_grid.dim() == 2
    grid = assignment_grid[None] if single else assignment_grid
    l, h, w = grid.shape
    pad_h = max(0, kernel_size + 1 - h)
    pad_w = max(0, kernel_size + 1 - w)
    lo_h, lo_w = pad_h // 2, pad_w // 2
    one_hot = F.one_hot(grid.long(), num_clusters).permute(0, 3, 1, 2).float()
    one_hot = F.pad(one_hot, (lo_w, pad_w - lo_w, lo_h, pad_h - lo_h))
    # SAME: pad (k - 1) // 2 before and the rest after, as XLA does.
    lo = (kernel_size - 1) // 2
    hi = kernel_size - 1 - lo
    x = F.pad(one_hot.reshape(l * num_clusters, 1, *one_hot.shape[2:]), (lo, hi, lo, hi))
    kernel = torch.ones(1, 1, kernel_size, kernel_size, device=x.device)
    counts = F.conv2d(x, kernel).reshape(l, num_clusters, *one_hot.shape[2:])
    counts = counts[:, :, lo_h:lo_h + h, lo_w:lo_w + w]
    out = counts.argmax(1)
    return out[0] if single else out


def mode_counts_3d(
    assignment_grid: torch.Tensor, kernel_size: int = 3, num_clusters: int = 3
) -> torch.Tensor:
    """(C, D, H, W) counts of each cluster in the box around every cell of
    a (D, H, W) grid: edge-padded where a dim is smaller than the kernel,
    a SAME box filter, cropped."""
    d, h, w = assignment_grid.shape
    pads = [max(0, kernel_size - n) for n in (d, h, w)]
    los = [p // 2 for p in pads]
    one_hot = F.one_hot(assignment_grid.long(), num_clusters).permute(3, 0, 1, 2).float()
    edge = (los[2], pads[2] - los[2], los[1], pads[1] - los[1], los[0], pads[0] - los[0])
    x = F.pad(one_hot[None], edge, mode="replicate")[0]  # (C, D', H', W')
    lo = (kernel_size - 1) // 2
    hi = kernel_size - 1 - lo
    x = F.pad(x[:, None], (lo, hi) * 3)  # SAME, as XLA pads
    kernel = torch.ones(1, 1, kernel_size, kernel_size, kernel_size, device=x.device)
    counts = F.conv3d(x, kernel)[:, 0]
    return counts[:, los[0]:los[0] + d, los[1]:los[1] + h, los[2]:los[2] + w]


def smooth_assignments_3d(
    assignment_grid: torch.Tensor, kernel_size: int = 3, num_clusters: int = 3
) -> torch.Tensor:
    """Mode-filter a (D, H, W) grid, e.g. (layers-or-experts, gh, gw).
    An exact tie goes to the lowest label. (The JAX package sums weights of
    1/k^3 in fp32, so its rounding noise breaks such ties either way.)"""
    return mode_counts_3d(assignment_grid, kernel_size, num_clusters).argmax(0)
