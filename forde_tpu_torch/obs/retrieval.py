"""Image <-> text retrieval evaluation of the dual encoder (port of
forde_tpu/obs/retrieval.py): recall@K both ways and the mean and median
rank of the true match, over a held-out set of pairs. Embeddings are
computed batch by batch on the model's device (``clip_eval_embeddings``,
which launches the fused-qkv attention forward on the card); the (N, N)
similarity ranking runs there too, in fp32.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from forde_tpu_torch.models.dual_encoder import l2_normalize
from forde_tpu_torch.train.clip_step import CLIPTrainState, clip_eval_embeddings


def _retrieval_ranks(img_emb: torch.Tensor, txt_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank of the true match for every query, both directions: the number
    of candidates that score strictly higher than the match."""
    img = l2_normalize(img_emb.float())
    txt = l2_normalize(txt_emb.float())
    sims = img @ txt.T  # (N, N)
    diag = torch.diagonal(sims)
    rank_i2t = (sims > diag[:, None]).sum(dim=1)
    rank_t2i = (sims > diag[None, :]).sum(dim=0)
    return rank_i2t, rank_t2i


def retrieval_metrics(
    img_emb: torch.Tensor,
    txt_emb: torch.Tensor,
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """recall@K, mean and median rank over (N, D) paired embeddings."""
    rank_i2t, rank_t2i = _retrieval_ranks(img_emb, txt_emb)
    out: Dict[str, float] = {}
    for name, ranks in (("i2t", rank_i2t), ("t2i", rank_t2i)):
        r = ranks.cpu().numpy()
        for k in ks:
            out[f"retrieval/{name}_recall@{k}"] = float((r < k).mean())
        out[f"retrieval/{name}_mean_rank"] = float(r.mean() + 1)
        out[f"retrieval/{name}_median_rank"] = float(np.median(r) + 1)
    return out


def evaluate_retrieval(
    state: CLIPTrainState,
    batches: Iterable[Dict],
    ks: Sequence[int] = (1, 5, 10),
    prefix: str = "",
) -> Dict[str, float]:
    """Embed every (image, caption) batch (numpy arrays or tensors) and
    compute the retrieval metrics over the concatenated set. ``prefix``
    namespaces the tags (e.g. "seen_" for held-out pairs of seen classes,
    "unseen_" for held-out classes)."""
    device = state.model.logit_scale.device
    imgs, txts = [], []
    for batch in batches:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        img, txt, _ = clip_eval_embeddings(state, batch)
        imgs.append(img)
        txts.append(txt)
    out = retrieval_metrics(torch.cat(imgs), torch.cat(txts), ks)
    if prefix:
        out = {k.replace("retrieval/", f"retrieval/{prefix}"): v for k, v in out.items()}
    return out
