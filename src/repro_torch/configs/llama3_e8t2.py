"""llama3-e8t2 — the paper's upcycled 8-Expert Top-2 MoE (§4.2): every FFN
of llama3-8b becomes an 8-expert MoE, Mixtral-type router, CF=4. Its
dispatcher default ``alltoall`` needs an expert-parallel mesh: on one card
it falls back to the padded ``allgather`` at CF 4 with a warning (or raises
under strict dispatch); ``dispatcher="sorted"`` is the dropless path (CF
ignored)."""
from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs.llama3_8b import get_config as dense_config
from repro_torch.core.upcycle import upcycle_config


def get_config() -> ModelConfig:
    return upcycle_config(
        dense_config(),
        MoEConfig(num_experts=8, top_k=2, capacity_factor=4.0,
                  router_type="mixtral", dispatcher="alltoall"),
        name="llama3-e8t2",
    )
