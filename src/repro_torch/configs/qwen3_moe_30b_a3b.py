"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B];
already MoE, so the paper's recipe (CF training, router order) applies. CF
1.0 is the paper's Table-2 throughput choice: the capacity slots E*C equal
the k*T active assignments."""
from repro_torch.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        rope_theta=1000000.0,
        moe=MoEConfig(num_experts=128, top_k=8, capacity_factor=1.0,
                      dispatcher="allgather"),
        train_microbatches=4,
    )
