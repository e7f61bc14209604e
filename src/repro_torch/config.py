"""Model configuration for the port: its own copy of ``repro.config``'s
``MoEConfig``/``ModelConfig`` (same field names and defaults, so a test can
build both packages' configs from one dict), ``smoke_config``,
``with_dispatcher`` and ``get_config``.

Only the families this port runs are accepted: ``dense`` and ``moe`` with
GQA attention. The others (MLA, SSM, hybrid, encdec, vlm) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

# ROADMAP queue 1 item that ports each family or feature not yet in the port
_LATER = "ROADMAP queue 1, 'other families'"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts recipe (paper §2, §3); see ``repro.config``.

    ``router_type``: ``mixtral`` = softmax over the top-k logits (preserves
    the dense function at upcycling init), ``st`` = top-k of the softmax.
    ``capacity_factor=None`` means dropless. Only ``dispatcher="sorted"``
    runs in the port so far (``core.dispatch.get_dispatcher``)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: Optional[float] = 4.0
    router_type: str = "mixtral"  # mixtral | st
    noisy_gating: bool = False
    aux_loss_coef: float = 1e-2
    z_loss_coef: float = 1e-3
    dispatcher: str = "allgather"  # allgather | alltoall | a2a_overlap | sorted
    strict_dispatch: bool = False
    fused_dispatch: bool = False
    expert_d_ff: int = 0  # 0 -> model d_ff
    moe_layer_freq: int = 1
    dense_residual: bool = False
    router_dtype: str = "float32"

    DISPATCHERS = ("allgather", "alltoall", "a2a_overlap", "sorted")

    def __post_init__(self):
        if self.dispatcher not in self.DISPATCHERS:
            raise ValueError(f"unknown dispatcher {self.dispatcher!r}")
        if self.fused_dispatch and self.dispatcher != "sorted":
            raise ValueError("fused_dispatch only exists for dispatcher='sorted'")

    def experts_ff(self, d_ff: int) -> int:
        return self.expert_d_ff or d_ff


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the fields of ``repro.config.ModelConfig``
    that the dense/moe GQA families read)."""

    name: str = "model"
    family: str = "dense"  # dense | moe
    source: str = ""

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    use_mla: bool = False
    moe: Optional[MoEConfig] = None

    dtype: str = "bfloat16"
    quant_weights: str = "none"
    quant_kv: str = "none"
    vocab_divisor: int = 2048

    def __post_init__(self):
        if self.family not in ("dense", "moe") or self.use_mla:
            raise NotImplementedError(
                f"family={self.family!r} use_mla={self.use_mla} is not ported "
                f"yet ({_LATER})"
            )
        if self.quant_weights != "none" or self.quant_kv != "none":
            raise NotImplementedError("int8 serving is ROADMAP queue 1, 'int8'")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        d = self.vocab_divisor
        return int(math.ceil(self.vocab_size / d) * d)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = ("llama3-8b", "llama3-e8t2")


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family (as ``repro.config.smoke_config``
    for the dense/moe families): 2 layers, d_model 256, 4 heads, <=4
    experts, tiny vocab."""
    kw: dict = dict(
        d_model=256, vocab_size=1024, vocab_divisor=128, num_layers=2,
        num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2, head_dim=64,
    )
    if cfg.d_ff:
        kw.update(d_ff=512)
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), expert_d_ff=0
        )
        if moe.dispatcher in ("alltoall", "a2a_overlap"):
            moe = dataclasses.replace(moe, dispatcher="allgather")
        kw.update(moe=moe)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)


def with_dispatcher(cfg: ModelConfig, dispatcher: Optional[str]) -> ModelConfig:
    """``cfg`` with its MoE token dispatcher overridden (no-op for dense
    configs or ``dispatcher=None``)."""
    if dispatcher is None or cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatcher=dispatcher))


def get_config(arch: str) -> ModelConfig:
    """Load ``repro_torch.configs.<arch>``; architectures not ported yet
    raise ``NotImplementedError``."""
    if arch not in ARCH_IDS:
        raise NotImplementedError(f"--arch {arch!r} is not ported yet ({_LATER})")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    )
    cfg = mod.get_config()
    assert cfg.name == arch, (cfg.name, arch)
    return cfg
