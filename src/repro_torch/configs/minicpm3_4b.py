"""minicpm3-4b — dense decoder with MLA (Multi-head Latent Attention)
[hf:openbmb/MiniCPM3-4B]. The compressed latent KV cache (kv_lora 256 +
rope 32 per token) makes long-context decode in scope."""
from repro_torch.config import MLAConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        rope_theta=10000.0,
        use_mla=True,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                      qk_rope_head_dim=32, v_head_dim=64),
        train_microbatches=4,
    )
