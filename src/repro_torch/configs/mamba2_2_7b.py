"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].
Attention-free; the paper's upcycling does not apply (no FFN, d_ff=0:
``upcycle_config`` refuses it). It trains, prefills and decodes, with an
O(1) recurrent state at decode."""
from repro_torch.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        source="arXiv:2405.21060 (Mamba-2 2.7B)",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        # chunk 128 (§Perf M3): SSD L-matrix traffic is linear in chunk size
        # (B*H*L*cs elements); 128 stays MXU-aligned while halving that term.
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=8, chunk_size=128),
        train_microbatches=8,
    )
