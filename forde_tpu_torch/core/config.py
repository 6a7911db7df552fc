"""Typed configuration of the decoder LM and the dual encoder (port of
forde_tpu/core/config.py).

Field names, order and defaults match the JAX package so that both write
and read the same ``model_config.json``: dtypes serialise by name
(``"float32"``, ``"bfloat16"``), and the ``kind`` key tells ``"llm"``
from ``"dual_encoder"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the name numpy and JAX use)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class DTypePolicy:
    """``compute`` for activations and matmuls, ``param`` for parameter
    storage, ``stats`` for sensing accumulators (always fp32)."""

    compute: torch.dtype = torch.float32
    param: torch.dtype = torch.float32
    stats: torch.dtype = torch.float32

    @staticmethod
    def bf16() -> "DTypePolicy":
        return DTypePolicy(compute=torch.bfloat16, param=torch.float32)

    @staticmethod
    def fp32() -> "DTypePolicy":
        return DTypePolicy()


@dataclass(frozen=True)
class LLMConfig:
    """The FORDE decoder-only LM (MoE + NSA + mHC).

    ``attention_impl``: "auto" (and the JAX config's "pallas" or
    "interpret") runs the attention kernels on CUDA tensors and their
    plain versions on CPU tensors; "reference" runs the plain attention
    paths everywhere. ``moe_dispatch``: "dense" or "capacity" ("ep", expert
    parallelism over a device mesh, comes with the multi-device slice).
    ``remat``: a training forward recomputes each decoder block in the
    backward (nn/remat.py). ``scan_layers`` is the checkpoint layout: the
    saved trees keep the blocks under ``layers/block/...`` with a leading
    (L,) axis, as the JAX package's scanned model does; the port's model
    stays unrolled in either layout (``interop``).
    ``quantized``: weight-only int8 serving (ops/quant.py): the
    dense-causal attention's projections, the dense FFN, the lm_head and
    the MoE expert bank take int8 weights from ``quant.quantize_params``.
    """

    vocab_size: int = 32000
    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 8
    head_dim: int = 64
    max_seq_len: int = 2048
    use_moe: bool = True
    num_experts: int = 8
    top_k_experts: int = 2
    expert_hidden_dim: int = 2048
    moe_aux_loss_weight: float = 0.01
    use_sparse_attention: bool = True
    window_size: int = 512
    compression_ratio: int = 8
    top_k_global: int = 64
    use_hyper_connections: bool = True
    num_streams: int = 4
    sinkhorn_iterations: int = 5
    dropout_rate: float = 0.1
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 2.0
    attention_impl: str = "auto"
    remat: bool = False
    scan_layers: bool = False
    quantized: bool = False
    # The reference's final-norm ordering: with mHC on, final_norm is
    # computed and dropped and lm_head reads the raw collapsed streams.
    reference_quirks: bool = False
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    def replace(self, **kw) -> "LLMConfig":
        return dataclasses.replace(self, **kw)


def create_default_config() -> LLMConfig:
    """The small test config of the JAX package."""
    return LLMConfig(
        vocab_size=50257,
        d_model=256,
        num_layers=4,
        num_heads=4,
        head_dim=64,
        max_seq_len=1024,
        use_moe=True,
        num_experts=4,
        top_k_experts=2,
        expert_hidden_dim=512,
        use_sparse_attention=True,
        window_size=128,
        compression_ratio=4,
        top_k_global=32,
        use_hyper_connections=True,
        num_streams=2,
        sinkhorn_iterations=3,
        dropout_rate=0.0,
    )


@dataclass(frozen=True)
class TowerConfig:
    """One encoder tower (vision or text) of FORDE transformer blocks."""

    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 8
    head_dim: int = 64
    mlp_hidden_dim: int = 2048
    dropout_rate: float = 0.0


@dataclass(frozen=True)
class DualEncoderConfig:
    """CLIP-style dual encoder with StatefulLayer blocks.

    ``attention_kernel_impl``: "auto" runs the fused attention kernels on
    CUDA (their plain versions on CPU tensors); "reference" runs the plain
    masked-attention path everywhere. ``sense`` builds the StatefulLayers'
    fast-loop state (a call still chooses whether to sense);
    ``forde_lite`` picks the slow loop's rule-based assigner over the GMM.
    ``remat``, the rematerialisation policy of a training forward
    (nn/remat.py): False/"none" keeps every activation, True/"block"
    recomputes whole tower blocks in the backward (attention too), "mlp"
    only the StatefulLayer. ``num_neuron_types`` and
    ``stateful_kernel_impl`` are kept for the checkpoint schema; the port
    reads neither.
    """

    image_size: int = 224
    patch_size: int = 16
    vision: TowerConfig = field(default_factory=lambda: TowerConfig())
    vocab_size: int = 30522
    max_text_len: int = 64
    text: TowerConfig = field(
        default_factory=lambda: TowerConfig(d_model=512, num_layers=12)
    )
    embed_dim: int = 512
    logit_scale_init: float = 2.6592
    num_neuron_types: int = 3
    specialist_gate: float = 0.1
    forde_lite: bool = False
    stateful_kernel_impl: str = "auto"
    attention_kernel_impl: str = "auto"
    remat: object = False
    sense: bool = True
    dtypes: DTypePolicy = field(default_factory=DTypePolicy)

    def replace(self, **kw) -> "DualEncoderConfig":
        return dataclasses.replace(self, **kw)


def vit_b16_config() -> DualEncoderConfig:
    """ViT-B/16 + 12-layer text tower."""
    return DualEncoderConfig(
        image_size=224,
        patch_size=16,
        vision=TowerConfig(
            d_model=768, num_layers=12, num_heads=12, head_dim=64, mlp_hidden_dim=3072
        ),
        text=TowerConfig(
            d_model=512, num_layers=12, num_heads=8, head_dim=64, mlp_hidden_dim=2048
        ),
        embed_dim=512,
    )


def vit_tiny_config() -> DualEncoderConfig:
    """Forde-lite tiny config: ViT-Ti/16 + 2-layer text."""
    return DualEncoderConfig(
        image_size=224,
        patch_size=16,
        vision=TowerConfig(
            d_model=192, num_layers=12, num_heads=3, head_dim=64, mlp_hidden_dim=768
        ),
        text=TowerConfig(
            d_model=192, num_layers=2, num_heads=3, head_dim=64, mlp_hidden_dim=768
        ),
        embed_dim=192,
        forde_lite=True,
    )


def vit_tiny_hd128_config() -> DualEncoderConfig:
    """ViT-Ti-scale towers with a single 128-wide attention head."""
    return DualEncoderConfig(
        image_size=224,
        patch_size=16,
        vision=TowerConfig(
            d_model=192, num_layers=12, num_heads=1, head_dim=128,
            mlp_hidden_dim=768,
        ),
        text=TowerConfig(
            d_model=192, num_layers=2, num_heads=1, head_dim=128,
            mlp_hidden_dim=768,
        ),
        embed_dim=192,
        forde_lite=True,
    )


def vit_b16_hd128_config() -> DualEncoderConfig:
    """ViT-B/16 with 128-wide heads: vision 6x128, text 4x128 (the same
    parameter shapes as ``vit_b16_config``; only the head split differs)."""
    return DualEncoderConfig(
        image_size=224,
        patch_size=16,
        vision=TowerConfig(
            d_model=768, num_layers=12, num_heads=6, head_dim=128,
            mlp_hidden_dim=3072,
        ),
        text=TowerConfig(
            d_model=512, num_layers=12, num_heads=4, head_dim=128,
            mlp_hidden_dim=2048,
        ),
        embed_dim=512,
    )


@dataclass(frozen=True)
class BrainConfig:
    """Sense -> Cluster -> Smooth -> Actuate: the fields of the JAX
    package's ``BrainConfig`` that the neuron and MoE slow loops read,
    with its defaults."""

    num_clusters: int = 3
    gmm_iterations: int = 50
    gmm_kmeans_iterations: int = 10
    smoothing_kernel_size: int = 3
    # Router actuation of the MoE slow loop
    target_balance: float = 0.1
    max_adjustment: float = 0.1
    specialist_damping: float = 0.5
    # Forde-lite rule thresholds
    lite_spec_grad_gini: float = 0.8
    lite_pool_act_gini: float = 0.3


PRESETS = {
    "vit_b16": vit_b16_config,
    "vit_tiny": vit_tiny_config,
    "vit_tiny_hd128": vit_tiny_hd128_config,
    "vit_b16_hd128": vit_b16_hd128_config,
}


def config_to_dict(cfg) -> dict:
    """JSON-safe dict of an LLMConfig or DualEncoderConfig, the JAX
    package's schema (dtypes by name)."""
    if isinstance(cfg, LLMConfig):
        kind = "llm"
    elif isinstance(cfg, DualEncoderConfig):
        kind = "dual_encoder"
    else:
        raise TypeError(f"unsupported config type {type(cfg)}")
    d = dataclasses.asdict(cfg)
    d["dtypes"] = {k: dtype_name(v) for k, v in d["dtypes"].items()}
    return {"kind": kind, **d}


def config_from_dict(d: dict):
    """Inverse of ``config_to_dict``; reads the JAX package's JSON too."""
    d = dict(d)
    kind = d.pop("kind")
    if kind not in ("llm", "dual_encoder"):
        raise ValueError(f"unknown config kind {kind!r}")
    d["dtypes"] = DTypePolicy(
        **{k: dtype_from_name(v) for k, v in d["dtypes"].items()}
    )
    if kind == "llm":
        return LLMConfig(**d)
    d["vision"] = TowerConfig(**d["vision"])
    d["text"] = TowerConfig(**d["text"])
    return DualEncoderConfig(**d)
