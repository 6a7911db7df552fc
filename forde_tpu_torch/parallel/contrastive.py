"""The global-batch contrastive loss under data parallelism (port of
forde_tpu/parallel/contrastive.py).

Each rank holds its (B_local, D) image and text embeddings. The
embeddings are small, so they are all-gathered over the data axis, and
each rank scores its LOCAL queries against the GLOBAL keys: the
(B_global, B_global) similarity matrix never exists on one rank. The
result is ``models.dual_encoder.clip_contrastive_loss`` of the global
batch, which the dual encoder's step takes under data parallelism
(train/clip_step.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.mesh import AXIS_DATA, Mesh
from forde_tpu_torch.models.dual_encoder import l2_normalize
from forde_tpu_torch.parallel.collectives import all_gather, pmean


def sharded_contrastive_loss(
    img_emb: torch.Tensor,
    txt_emb: torch.Tensor,
    logit_scale: torch.Tensor,
    mesh: Mesh,
    max_scale: float = 100.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE of the global batch from this rank's rows (the
    batch split over data). Returns (loss, metrics), both the same on
    every rank: ``contrastive/acc_img`` (as the JAX package's), and
    ``contrastive/acc_txt`` and ``contrastive/logit_scale`` as
    ``clip_contrastive_loss`` reports them. The loss is a ``pmean``: a
    rank differentiates it divided by the data axis' size (the gradient
    convention of parallel/collectives.py)."""
    group = mesh.group(AXIS_DATA)
    b_local = img_emb.shape[0]
    scale = torch.clamp(torch.exp(logit_scale.float()), max=max_scale)
    img = l2_normalize(img_emb.float())
    txt = l2_normalize(txt_emb.float())
    all_img = all_gather(img, group)  # (B_global, D)
    all_txt = all_gather(txt, group)
    labels = group.index * b_local + torch.arange(b_local, device=img.device)
    rows = torch.arange(b_local, device=img.device)
    logits_i = img @ all_txt.T * scale  # local images against every text
    logits_t = txt @ all_img.T * scale  # local texts against every image
    loss_i = -F.log_softmax(logits_i, dim=1)[rows, labels].mean()
    loss_t = -F.log_softmax(logits_t, dim=1)[rows, labels].mean()
    loss = pmean((loss_i + loss_t) / 2, group)
    with torch.no_grad():
        acc_i = pmean((logits_i.argmax(dim=1) == labels).float().mean(), group)
        acc_t = pmean((logits_t.argmax(dim=1) == labels).float().mean(), group)
    return loss, {"contrastive/acc_img": acc_i, "contrastive/acc_txt": acc_t,
                  "contrastive/logit_scale": scale.detach()}
