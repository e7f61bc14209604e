"""seamless-m4t-medium — speech/text encoder-decoder [arXiv:2308.11596].
The audio frontend (mel-spectrogram + conformer feature extractor) is the
documented stub: the encoder consumes precomputed frame embeddings
(B, Se, d_model). 12 encoder + 12 decoder layers; full attention, so no
long-context decode. The serving engine refuses it, as the JAX engine
cannot serve it (``serving/engine.py``); it generates through
``prefill_forward`` and ``decode_step``."""
from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        source="arXiv:2308.11596 (SeamlessM4T-medium)",
        num_layers=12,
        num_encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        norm_type="layernorm",
        rope_theta=10000.0,
    )
