"""forde-tpu-torch: the FORDE framework on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``forde_tpu`` that keeps its module layout and
names (``core.config``, ``ops.flash_attention``, ``nn.transformer``,
``models.dual_encoder``, ``embed`` ...). Plain tensor code is PyTorch;
each Pallas TPU kernel on a ported path is a CUDA kernel written by hand
for ``sm_90a`` under ``csrc/``, built at first use (``kernels.build``).

This package imports neither JAX nor any module of ``forde_tpu``.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
GPU visible they raise instead of falling back (``resolve_device``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for (the default) and no GPU is visible:
    the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "forde_tpu_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
