"""qwen2.5-14b — GQA dense decoder with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B (14B dims)",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        rope_theta=1000000.0,
        qkv_bias=True,
        train_microbatches=2,
    )
