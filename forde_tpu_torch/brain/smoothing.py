"""Mode filter over 2-D neuron-assignment grids (port of
``near_square_grid`` and ``smooth_assignments`` in
forde_tpu/brain/smoothing.py; the 3-D form serves the MoE loop and is not
ported yet).

One-hot encode -> per-cluster box filter -> argmax, with the box filter as
ONE ``conv2d`` call whose batch axis carries every (grid, cluster) pair.
The filter sums the one-hot counts with weights 1 rather than the JAX
package's 1/k^2: the same argmax, and ties between clusters stay exact
ties, which ``argmax`` gives to the lowest label.

Padding as in the JAX package: zero-pad (split evenly) so that each dim is
at least kernel_size + 1, a SAME convolution, crop.
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
