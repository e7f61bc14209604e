"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 with MoE every other
layer, 16 experts top-2 [arXiv:2403.19887]. Already-MoE: the paper's
upcycling init is inapplicable, but its training recipe (CF, router order,
token dispatchers) apply. ``fsdp=True`` shards the weights over a mesh
(ROADMAP queue 1, 'Multi-GPU'); on one card one period of 8 layers fits
with int8 expert weights (``chip_smoke.py`` phase 13c)."""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        source="arXiv:2403.19887 (Jamba-1.5-Large)",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        hybrid_pattern="MMMAMMMM",  # attention 1-of-8 (1:7)
        moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=2.0,
                      moe_layer_freq=2, dispatcher="allgather"),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=16,
                      chunk_size=256),
        fsdp=True,
        train_microbatches=16,
    )
