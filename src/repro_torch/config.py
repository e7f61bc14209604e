"""Model configuration for the port: its own copy of ``repro.config``'s
``MoEConfig``/``ModelConfig``/``TrainConfig`` (same field names and
defaults, so a test can build both packages' configs from one dict),
``smoke_config``, ``with_dispatcher`` and ``get_config``.

Only the families this port runs are accepted: ``dense``, ``moe`` and
``vlm`` (a dense decoder that takes a stub patch-embedding prefix) with GQA
attention. The others (MLA, SSM, hybrid, encdec) raise
``NotImplementedError`` naming the ROADMAP item that ports them, as does
``get_config`` for their architectures.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

# ROADMAP queue 1 item that ports each family or feature not yet in the port
_LATER = "ROADMAP queue 1, 'other families'"
_LATER_FAMILY = {
    "mla": "ROADMAP queue 1, 'other families': MLA",
    "ssm": "ROADMAP queue 1, 'other families': SSM and hybrid",
    "hybrid": "ROADMAP queue 1, 'other families': SSM and hybrid",
    "encdec": "ROADMAP queue 1, 'other families': encdec",
}
FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts recipe (paper §2, §3); see ``repro.config``.

    ``router_type``: ``mixtral`` = softmax over the top-k logits (preserves
    the dense function at upcycling init), ``st`` = top-k of the softmax,
    ``expert_choice`` = each expert takes its top-C tokens (padded
    dispatch only; ``sorted`` resolves to ``allgather``). ``noisy_gating``
    adds the paper's Eq. 3 noise to the logits in training.
    ``capacity_factor=None`` means dropless. On one card ``allgather`` and
    ``sorted`` run; ``alltoall``/``a2a_overlap`` need an expert-parallel
    plan and fall back to ``allgather`` (``core.dispatch.get_dispatcher``)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: Optional[float] = 4.0
    router_type: str = "mixtral"  # mixtral | st | expert_choice
    noisy_gating: bool = False  # Eq. (3) noisy top-k; off in the paper's main runs
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
    that the dense/moe/vlm GQA families read)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | vlm
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
    # vlm stub frontend: prefix embedding positions (precomputed patch
    # embeddings arrive as batch["embeds"] (B, P, d_model))
    num_prefix_embeds: int = 0

    dtype: str = "bfloat16"
    quant_weights: str = "none"  # none | int8 (int8 expert weights with bf16 per-channel scales)
    quant_kv: str = "none"  # none | int8 (int8 KV pages with per-token scale sidecars)
    vocab_divisor: int = 2048
    # remat policy of the training stack: 'none' | 'full' | 'dots' (the JAX
    # package's 'full' and 'dots' both checkpoint the whole period body)
    remat: str = "full"
    # gradient-accumulation microbatches per step (fp32 accumulation)
    train_microbatches: int = 1

    QUANT_MODES = ("none", "int8")

    def __post_init__(self):
        if self.family not in FAMILIES or self.use_mla:
            item = _LATER_FAMILY["mla" if self.use_mla else self.family] \
                if (self.use_mla or self.family in _LATER_FAMILY) else _LATER
            raise NotImplementedError(
                f"family={self.family!r} use_mla={self.use_mla} is not ported yet ({item})"
            )
        for name in ("quant_weights", "quant_kv"):
            if getattr(self, name) not in self.QUANT_MODES:
                raise ValueError(
                    f"{name} must be one of {self.QUANT_MODES}, got {getattr(self, name)!r}"
                )

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        d = self.vocab_divisor
        return int(math.ceil(self.vocab_size / d) * d)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> Tuple[int, int]:
        """(total, active) parameters excluding vocab padding, as
        ``repro.config.ModelConfig.param_counts`` counts them for the
        dense, moe and vlm families (the vlm stub frontend has none)."""
        D, V, L, hd = self.d_model, self.vocab_size, self.num_layers, self.head_dim_
        total = active = V * D * (1 if self.tie_embeddings else 2) + D  # + final norm
        attn = D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd + self.num_heads * hd * D
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        ffn = lambda dff: 3 * D * dff  # SwiGLU: gate, up, down
        for i in range(L):
            total += 2 * D + attn
            active += 2 * D + attn
            m = self.moe
            if m is not None and i % m.moe_layer_freq == m.moe_layer_freq - 1:
                dff, router = m.experts_ff(self.d_ff), D * m.num_experts
                total += m.num_experts * ffn(dff) + router
                active += m.top_k * ffn(dff) + router
                if m.dense_residual:
                    total += ffn(self.d_ff)
                    active += ffn(self.d_ff)
            elif self.d_ff:
                total += ffn(self.d_ff)
                active += ffn(self.d_ff)
        return total, active

    def flops_per_token(self, seq_len: int = 1) -> int:
        """Approximate forward FLOPs per token: 2 x active matmul params +
        causal attention scores (MFU accounting)."""
        _, active = self.param_counts()
        return 2 * active + 4 * self.num_layers * self.num_heads * self.head_dim_ * (seq_len // 2)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training run hyperparameters (paper §4.2 defaults, scaled); see
    ``repro.config.TrainConfig``. ``zero1`` waits for the multi-GPU item;
    ``ckpt_every`` adds full-state checkpoints into ``ckpt_dir`` to the
    Trainer's default callbacks."""

    global_batch: int = 32
    seq_len: int = 512
    lr: float = 3e-5
    lr_min: float = 3e-7
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 1234
    zero1: bool = True
    blend_ratio: float = 0.7
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: str = "/tmp/repro_ckpt"


ARCH_IDS = (
    "llama3.2-3b",
    "stablelm-1.6b",
    "qwen3-moe-30b-a3b",
    "llava-next-34b",
    "qwen2.5-14b",
    "arctic-480b",
    # paper's own models
    "llama3-8b",
    "llama3-e8t2",
)
# the JAX package's architectures the port does not run yet, and the ROADMAP
# item that ports each
LATER_ARCHS = {
    "minicpm3-4b": _LATER_FAMILY["mla"],
    "mamba2-2.7b": _LATER_FAMILY["ssm"],
    "jamba-1.5-large-398b": _LATER_FAMILY["hybrid"],
    "seamless-m4t-medium": _LATER_FAMILY["encdec"],
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family (as ``repro.config.smoke_config``
    for the dense/moe/vlm families): 2 layers, d_model 256, 4 heads, <=4
    experts (top-k capped at 2), 16 prefix embeddings for a vlm, tiny
    vocab."""
    kw: dict = dict(
        d_model=256, vocab_size=1024, vocab_divisor=128, num_layers=2,
        num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2, head_dim=64,
        num_prefix_embeds=16 if cfg.num_prefix_embeds else 0,
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
    raise ``NotImplementedError`` naming their ROADMAP item."""
    if arch not in ARCH_IDS:
        raise NotImplementedError(f"--arch {arch!r} is not ported yet ({LATER_ARCHS.get(arch, _LATER)})")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    )
    cfg = mod.get_config()
    assert cfg.name == arch, (cfg.name, arch)
    return cfg
