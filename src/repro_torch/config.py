"""Model configuration for the port: its own copy of ``repro.config``'s
``MoEConfig``/``ModelConfig``/``TrainConfig`` (same field names and
defaults, so a test can build both packages' configs from one dict),
``smoke_config``, ``with_dispatcher`` and ``get_config``.

Every family of the JAX package: ``dense`` and ``moe`` (GQA or MLA
attention), ``vlm`` (a dense decoder that takes a stub patch-embedding
prefix), ``ssm`` (Mamba-2), ``hybrid`` (interleaved Mamba and attention
mixers, MoE optional) and ``encdec`` (an encoder over stub frame
embeddings and a decoder with cross-attention), with ``MLAConfig`` and
``SSMConfig``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality) block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 8
    chunk_size: int = 256
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description, the fields of ``repro.config.ModelConfig``.
    ``family``: ``dense`` / ``moe`` decoders (GQA, or MLA with
    ``use_mla``), ``ssm`` (attention-free Mamba-2), ``hybrid`` (the mixer
    pattern ``hybrid_pattern``, 'M' Mamba and 'A' attention, MoE
    optional), ``encdec`` (``num_encoder_layers`` over stub frames, a
    decoder with cross-attention), ``vlm`` (a stub patch-embedding
    prefix)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
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
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): mixer pattern of one period, 'M' Mamba, 'A' attention
    hybrid_pattern: str = ""
    # encdec: encoder layers over batch["frames"] (B, Se, d_model)
    num_encoder_layers: int = 0
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
    # FSDP/ZeRO-3 sharding of the weights over the data axis (jamba,
    # arctic); read by the JAX package's sharding rules, carried here for
    # the multi-GPU item (ROADMAP queue 1, 'Multi-GPU')
    fsdp: bool = False
    # gradient-accumulation microbatches per step (fp32 accumulation)
    train_microbatches: int = 1

    QUANT_MODES = ("none", "int8")

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; expected one of {FAMILIES}")
        for name in ("quant_weights", "quant_kv"):
            if getattr(self, name) not in self.QUANT_MODES:
                raise ValueError(
                    f"{name} must be one of {self.QUANT_MODES}, got {getattr(self, name)!r}"
                )

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        d = self.vocab_divisor
        return int(math.ceil(self.vocab_size / d) * d)

    @property
    def supports_long_context(self) -> bool:
        """True if long-context decode is in scope (the sub-quadratic rule:
        an SSM state, a sliding window or MLA's latent cache)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "encdec":
            return False
        return self.sliding_window is not None or self.use_mla

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> Tuple[int, int]:
        """(total, active) parameters excluding vocab padding, counted as
        ``repro.config.ModelConfig.param_counts`` counts them (stub
        frontends have none)."""
        D, V, L, hd = self.d_model, self.vocab_size, self.num_layers, self.head_dim_
        ffn = lambda dff: 3 * D * dff  # SwiGLU: gate, up, down

        def attn() -> int:
            if self.use_mla and self.mla is not None:
                m, H = self.mla, self.num_heads
                p = D * m.q_lora_rank + m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p += D * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                return p + H * m.v_head_dim * D
            p = D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd + self.num_heads * hd * D
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        def ssm() -> int:
            s = self.ssm or SSMConfig()
            di, nh, ng, ds = s.d_inner(D), s.nheads(D), s.ngroups, s.d_state
            # in_proj (z, x, B, C, dt), depthwise conv, A_log and D, out_proj
            return D * (2 * di + 2 * ng * ds + nh) + (di + 2 * ng * ds) * s.d_conv + 2 * nh + di * D

        total = active = V * D * (1 if self.tie_embeddings else 2) + D  # + final norm
        for i in range(L):
            total += 2 * D
            active += 2 * D
            if self.family == "ssm":
                total += ssm()
                active += ssm()
                continue
            if self.family == "hybrid" and self.hybrid_pattern:
                mix = ssm() if self.hybrid_pattern[i % len(self.hybrid_pattern)] == "M" else attn()
            else:
                mix = attn()
            total += mix
            active += mix
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
        if self.family == "encdec":
            # encoder layers (self-attention + FFN + norms), and each decoder
            # layer's cross-attention and its norm
            enc = self.num_encoder_layers * (attn() + ffn(self.d_ff) + 2 * D) + L * (attn() + D)
            total += enc
            active += enc
        return total, active

    def flops_per_token(self, seq_len: int = 1) -> int:
        """Approximate forward FLOPs per token: 2 x active matmul params +
        causal attention scores over the attention layers (MFU
        accounting)."""
        _, active = self.param_counts()
        flops = 2 * active
        if self.family != "ssm":
            n_attn = self.num_layers
            if self.family == "hybrid" and self.hybrid_pattern:
                per = self.hybrid_pattern
                n_attn = sum(1 for i in range(self.num_layers) if per[i % len(per)] == "A")
            flops += 4 * n_attn * self.num_heads * self.head_dim_ * (seq_len // 2)
        return flops


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
    "mamba2-2.7b",
    "minicpm3-4b",
    "seamless-m4t-medium",
    "llama3.2-3b",
    "stablelm-1.6b",
    "jamba-1.5-large-398b",
    "qwen3-moe-30b-a3b",
    "llava-next-34b",
    "qwen2.5-14b",
    "arctic-480b",
    # paper's own models
    "llama3-8b",
    "llama3-e8t2",
)

def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family (``repro.config.smoke_config``):
    d_model 256, 2 layers (a hybrid: one period of its pattern; an
    encdec: 2 encoder layers too), 4 heads of 64, a small SSM and MLA, <=4
    experts (top-k capped at 2), 16 prefix embeddings for a vlm, tiny
    vocab."""
    kw: dict = dict(
        d_model=256, vocab_size=1024, vocab_divisor=128,
        num_prefix_embeds=16 if cfg.num_prefix_embeds else 0, fsdp=False,
    )
    small_ssm = lambda: dataclasses.replace(cfg.ssm, d_state=32, headdim=32, ngroups=4, chunk_size=16)
    if cfg.family == "ssm":
        kw.update(num_layers=2, ssm=small_ssm())
    elif cfg.family == "hybrid":
        kw.update(num_layers=len(cfg.hybrid_pattern or "M"), ssm=small_ssm())
    else:
        kw.update(num_layers=2)
    if cfg.family == "encdec":
        kw.update(num_encoder_layers=2)
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2, head_dim=64)
    if cfg.use_mla:
        kw.update(mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
                                v_head_dim=32))
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
    """Load ``repro_torch.configs.<arch>`` (dashes and dots become
    underscores)."""
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown --arch {arch!r}; expected one of {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    )
    cfg = mod.get_config()
    assert cfg.name == arch, (cfg.name, arch)
    return cfg
