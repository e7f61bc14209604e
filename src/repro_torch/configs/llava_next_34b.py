"""llava-next-34b — VLM: Yi-34B-class dense decoder consuming an anyres
patch-embedding prefix [hf:llava-hf/llava-v1.6-34b-hf]. The vision tower
and projector are a stub: ``batch["embeds"]`` (B, 2880, d_model) arrives
precomputed; 2880 = anyres max image tokens (4 tiles + base, 576 each)."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B NH2-Yi backbone dims)",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5000000.0,
        num_prefix_embeds=2880,
        train_microbatches=4,
    )
