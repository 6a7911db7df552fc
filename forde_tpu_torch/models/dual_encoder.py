"""FORDE dual encoder: CLIP-style vision and text towers of StatefulLayer
blocks, projections into a shared embedding space, and the symmetric
contrastive loss (port of forde_tpu/models/dual_encoder.py).

Layouts are the JAX package's: images (B, H, W, C) float in [0, 1],
``input_ids`` and ``attention_mask`` (B, S), right-padded. Under FSDP
(parallel/fsdp.py) each block, embedding, norm and projection gathers its
parameters for its call; under tensor parallelism the blocks' attention
and StatefulLayers run their slices (parallel/tensor_parallel.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.config import DualEncoderConfig, TowerConfig
from forde_tpu_torch.nn.layers import Dense, LayerNorm
from forde_tpu_torch.nn.transformer import FORDETransformerBlock
from forde_tpu_torch.parallel import fsdp


def remat_policy(remat) -> Optional[str]:
    """``DualEncoderConfig.remat`` as the blocks read it (the JAX package's
    ``_block_cls``): True or "block" -> "block", "mlp" -> "mlp", False or
    "none" -> None."""
    if remat in (True, "block"):
        return "block"
    if remat == "mlp":
        return "mlp"
    if remat in (False, None, "none"):
        return None
    raise ValueError(f"unknown remat policy {remat!r}")


def _blocks(cfg: DualEncoderConfig, tw: TowerConfig, device) -> torch.nn.ModuleList:
    return torch.nn.ModuleList(
        FORDETransformerBlock(
            num_heads=tw.num_heads,
            head_dim=tw.head_dim,
            mlp_hidden_dim=tw.mlp_hidden_dim,
            d_model=tw.d_model,
            specialist_gate=cfg.specialist_gate,
            attention_impl=cfg.attention_kernel_impl,
            dropout_rate=tw.dropout_rate,
            dtype=cfg.dtypes.compute,
            sense=cfg.sense,
            param_dtype=cfg.dtypes.param,
            device=device,
            remat=remat_policy(cfg.remat),
        )
        for _ in range(tw.num_layers)
    )


class VisionTransformer(torch.nn.Module):
    """Patchify -> [CLS] + patches + registers + learned positions ->
    FORDE blocks -> final norm -> the CLS output."""

    def __init__(self, config: DualEncoderConfig, tower: TowerConfig, device=None):
        super().__init__()
        cfg, tw = config, tower
        self.dtype = cfg.dtypes.compute
        self.patch_size = p = cfg.patch_size
        n = (cfg.image_size // p) ** 2
        pdt = cfg.dtypes.param
        self.patch_embed = Dense(
            p * p * 3, tw.d_model, dtype=self.dtype, param_dtype=pdt, device=device
        )
        self.cls_token = torch.nn.Parameter(torch.zeros(1, 1, tw.d_model, dtype=pdt, device=device))
        # Register tokens pad the sequence to a multiple of 8.
        num_registers = (8 - (n + 1) % 8) % 8
        self.register_tokens = None
        if num_registers:
            self.register_tokens = torch.nn.Parameter(
                torch.zeros(1, num_registers, tw.d_model, dtype=pdt, device=device)
            )
        self.pos_embed = torch.nn.Parameter(
            torch.zeros(1, n + 1 + num_registers, tw.d_model, dtype=pdt, device=device)
        )
        self.blocks = _blocks(cfg, tw, device)
        self.final_norm = LayerNorm(tw.d_model, dtype=self.dtype, param_dtype=pdt, device=device)

    def forward(
        self, images: torch.Tensor, deterministic: bool = True, sense: bool = False
    ) -> torch.Tensor:
        dtype = self.dtype
        b, h, w, c = images.shape
        p = self.patch_size
        nh, nw = h // p, w // p
        # Cast before the patchify shuffle, then flatten each patch in
        # (row, column, channel) order, as the JAX package does.
        patches = images.to(dtype).reshape(b, nh, p, nw, p, c)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, p * p * c)
        x = fsdp.call(self.patch_embed, patches)
        parts = [fsdp.full(self.cls_token).to(dtype).expand(b, -1, -1), x]
        if self.register_tokens is not None:
            parts.append(fsdp.full(self.register_tokens).to(dtype).expand(b, -1, -1))
        x = torch.cat(parts, dim=1) + fsdp.full(self.pos_embed).to(dtype)
        for block in self.blocks:
            x = fsdp.call(block, x, None, deterministic, sense)
        return fsdp.call(self.final_norm, x)[:, 0, :]


class TextTransformer(torch.nn.Module):
    """Token embedding + learned positions -> FORDE blocks over the
    right-padded ``attention_mask`` -> final norm -> position 0."""

    def __init__(self, config: DualEncoderConfig, tower: TowerConfig, device=None):
        super().__init__()
        cfg, tw = config, tower
        self.dtype = cfg.dtypes.compute
        pdt = cfg.dtypes.param
        self.token_embed = torch.nn.Embedding(
            cfg.vocab_size, tw.d_model, dtype=pdt, device=device
        )
        self.pos_embed = torch.nn.Parameter(
            torch.zeros(1, cfg.max_text_len, tw.d_model, dtype=pdt, device=device)
        )
        self.blocks = _blocks(cfg, tw, device)
        self.final_norm = LayerNorm(tw.d_model, dtype=self.dtype, param_dtype=pdt, device=device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        sense: bool = False,
    ) -> torch.Tensor:
        dtype = self.dtype
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32, device=input_ids.device)
        x = fsdp.call(self.token_embed, input_ids.to(torch.int64)).to(dtype)
        x = x + fsdp.full(self.pos_embed)[:, :s].to(dtype)
        for block in self.blocks:
            x = fsdp.call(block, x, attention_mask, deterministic, sense)
        return fsdp.call(self.final_norm, x)[:, 0, :]


class FORDEDualEncoder(torch.nn.Module):
    """Two towers + projection heads + a learnable temperature.

    ``encode_image`` / ``encode_text`` are the serving surface; both
    return fp32 embeddings. Parameters start from ``init_params`` with a
    ``torch.Generator`` (Flax's initialisers, normal where Flax truncates)
    or come from a checkpoint. ``sense=True`` on a call accumulates the
    fast-loop statistics of every StatefulLayer (a model built with
    ``config.sense``); the default leaves them as they are.
    """

    def __init__(
        self,
        config: DualEncoderConfig,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        cfg = self.config = config
        dt, pdt = cfg.dtypes.compute, cfg.dtypes.param
        self.vision = VisionTransformer(cfg, cfg.vision, device)
        self.text = TextTransformer(cfg, cfg.text, device)
        self.image_projection = Dense(
            cfg.vision.d_model, cfg.embed_dim, bias=False, dtype=dt,
            param_dtype=pdt, device=device,
        )
        self.text_projection = Dense(
            cfg.text.d_model, cfg.embed_dim, bias=False, dtype=dt,
            param_dtype=pdt, device=device,
        )
        self.logit_scale = torch.nn.Parameter(
            torch.tensor(cfg.logit_scale_init, dtype=torch.float32, device=device)
        )
        if generator is not None:
            self.init_params(generator)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initialisers: Dense N(0, 1/fan_in), LayerNorm 1/0,
        Embed N(0, 1/d), CLS/register/position tokens N(0, 0.02)."""
        for module in self.modules():
            if isinstance(module, Dense):
                module.init_params(generator)
            elif isinstance(module, torch.nn.Embedding):
                module.weight.normal_(0.0, module.embedding_dim ** -0.5, generator=generator)
            elif isinstance(module, LayerNorm):
                module.reset_parameters()
        for tok in (
            self.vision.cls_token, self.vision.register_tokens,
            self.vision.pos_embed, self.text.pos_embed,
        ):
            if tok is not None:
                tok.normal_(0.0, 0.02, generator=generator)
        self.logit_scale.fill_(self.config.logit_scale_init)

    def forward(
        self,
        images: torch.Tensor,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        sense: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        img_emb = self.encode_image(images, deterministic, sense)
        txt_emb = self.encode_text(input_ids, attention_mask, deterministic, sense)
        return img_emb, txt_emb, self.logit_scale

    def encode_image(
        self, images: torch.Tensor, deterministic: bool = True, sense: bool = False
    ) -> torch.Tensor:
        feat = self.vision(images, deterministic, sense)
        return fsdp.call(self.image_projection, feat).float()

    def encode_text(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        sense: bool = False,
    ) -> torch.Tensor:
        feat = self.text(input_ids, attention_mask, deterministic, sense)
        return fsdp.call(self.text_projection, feat).float()


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def clip_contrastive_loss(
    img_emb: torch.Tensor,
    txt_emb: torch.Tensor,
    logit_scale: torch.Tensor,
    max_scale: float = 100.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over the batch (forward)."""
    img = l2_normalize(img_emb.float())
    txt = l2_normalize(txt_emb.float())
    scale = torch.clamp(torch.exp(logit_scale), max=max_scale)
    logits = img @ txt.T * scale
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_i = -F.log_softmax(logits, dim=1)[labels, labels].mean()
    loss_t = -F.log_softmax(logits, dim=0)[labels, labels].mean()
    loss = (loss_i + loss_t) / 2
    acc_i = (logits.argmax(dim=1) == labels).float().mean()
    acc_t = (logits.argmax(dim=0) == labels).float().mean()
    return loss, {
        "contrastive/acc_img": acc_i,
        "contrastive/acc_txt": acc_t,
        "contrastive/logit_scale": scale,
    }
