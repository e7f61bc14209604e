"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]: LayerNorm, MHA (32 KV
heads), head dim 64."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
        norm_type="layernorm",
        rope_theta=10000.0,
        train_microbatches=2,
    )
