"""llama3.2-3b — small Llama-3 dense decoder with tied embeddings
[hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        source="hf:meta-llama/Llama-3.2-1B (3B variant dims)",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
        train_microbatches=2,
    )
