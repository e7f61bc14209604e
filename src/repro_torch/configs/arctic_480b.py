"""arctic-480b — 128-expert top-2 MoE with a dense residual FFN in parallel
with every MoE layer [hf:Snowflake/snowflake-arctic-base]; already MoE, so
the paper's recipe (CF training, router order) applies. ``fsdp=True``
shards weights over a mesh (ROADMAP queue 1, 'Multi-GPU'); on one card a
cut of it fits (``chip_smoke.py`` phase 12b serves 2 layers)."""
from repro_torch.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=2.0,
                      dense_residual=True, dispatcher="allgather"),
        fsdp=True,
        train_microbatches=8,
    )
