"""llama3-8b — the paper's dense base model (upcycling source)."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        source="paper §4.2 / meta-llama/Meta-Llama-3-8B",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
    )
