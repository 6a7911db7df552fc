"""Brain-map plots: Brain Scan, Feature Space and Census (port of
forde_tpu/obs/plots.py, which is numpy and matplotlib only; this is its
copy).

The training loops draw them after every slow loop that was not skipped,
with ``--plots_dir``. matplotlib is imported at the first plot, never at
import time; ``require_matplotlib`` lets a loop refuse ``--plots_dir``
before its first step where matplotlib is missing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def require_matplotlib(flag: str = "--plots_dir") -> None:
    """Raise at once if matplotlib cannot be imported (a run asked for
    plots would otherwise fail at its first slow loop)."""
    try:
        _mpl()
    except ImportError as e:
        raise RuntimeError(f"{flag} needs matplotlib, which cannot be imported here ({e}); "
                           f"leave {flag} unset to train without plots") from e


def plot_brain_scan(
    smoothed_grid: np.ndarray, epoch: int, step: int, output_dir: str = "plots"
) -> str:
    """Heatmap of the smoothed assignment grid, each cell labelled."""
    plt = _mpl()
    os.makedirs(output_dir, exist_ok=True)
    grid = np.asarray(smoothed_grid)
    if grid.ndim == 1:
        grid = grid[None, :]
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(grid, cmap="viridis", interpolation="nearest")
    for (i, j), val in np.ndenumerate(grid):
        ax.text(j, i, str(int(val)), ha="center", va="center", color="w")
    fig.colorbar(im, ax=ax)
    ax.set_title(f"Brain Scan - Epoch {epoch}, Step {step}")
    path = os.path.join(output_dir, f"brain_scan_epoch{epoch}_step{step}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_feature_space(
    stats: np.ndarray,
    assignments: np.ndarray,
    epoch: int,
    step: int,
    output_dir: str = "plots",
    feature_names=("feature 0", "feature 1"),
) -> str:
    """Scatter of the first two stat columns, coloured by cluster."""
    plt = _mpl()
    os.makedirs(output_dir, exist_ok=True)
    stats = np.asarray(stats)
    assignments = np.asarray(assignments)
    fig, ax = plt.subplots(figsize=(8, 6))
    sc = ax.scatter(stats[:, 0], stats[:, 1], c=assignments, cmap="viridis", alpha=0.8)
    fig.colorbar(sc, ax=ax, label="cluster")
    ax.set_xlabel(feature_names[0])
    ax.set_ylabel(feature_names[1])
    ax.set_title(f"Feature Space - Epoch {epoch}, Step {step}")
    path = os.path.join(output_dir, f"feature_space_epoch{epoch}_step{step}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_census(
    assignments: np.ndarray,
    epoch: int,
    step: int,
    output_dir: str = "plots",
    num_clusters: Optional[int] = None,
    labels: Optional[Dict[int, str]] = None,
) -> str:
    """Histogram of the assignments over the clusters (the model-health
    Census)."""
    plt = _mpl()
    os.makedirs(output_dir, exist_ok=True)
    assignments = np.asarray(assignments).reshape(-1)
    k = num_clusters or int(assignments.max()) + 1
    counts = np.bincount(assignments, minlength=k)
    fig, ax = plt.subplots(figsize=(8, 6))
    names = [(labels or {}).get(i, f"cluster {i}") for i in range(k)]
    ax.bar(names, counts)
    ax.set_ylabel("count")
    ax.set_title(f"Census - Epoch {epoch}, Step {step}")
    path = os.path.join(output_dir, f"census_epoch{epoch}_step{step}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def grid_of(assignments: np.ndarray) -> np.ndarray:
    """The assignments on the loops' near-square grid: the largest row
    count at most sqrt(n) that divides n."""
    a = np.asarray(assignments)
    rows = int(np.sqrt(a.size)) or 1
    while a.size % rows:
        rows -= 1
    return a.reshape(rows, -1)
