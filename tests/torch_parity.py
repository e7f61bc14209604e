"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
one config dict builds both packages' configs, JAX draws the parameters,
and ``params_from_numpy`` carries them to the port on the CPU.

Tolerances used across the files, with their reasons:

* ``FP32_ATOL = 1e-4`` — fp32 configs: both sides compute the same
  arithmetic; only the summation order of the matmuls differs.
* ``BF16_REL = 2e-2`` of max |ref| — bf16 inputs: the two frameworks round
  intermediates to bf16 at different points (a bf16 ulp is 2^-8 ~ 4e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.config import MoEConfig as TMoEConfig
from repro_torch.params import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32_ATOL = 1e-4
BF16_REL = 2e-2

# tests/conftest.py:tiny_dense, plus a 4-expert top-2 MoE
TINY = dict(
    name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, vocab_divisor=64,
)
TINY_MOE = dict(num_experts=4, top_k=2, capacity_factor=None,
                router_type="mixtral", dispatcher="sorted")


def configs(moe: bool = True, fp32: bool = True, moe_kw=None, **kw):
    """(JAX config, port config) built from the same fields."""
    base = dict(TINY, **kw)
    if fp32:
        base["dtype"] = "float32"
    jm = tm = None
    if moe:
        mkw = dict(TINY_MOE, **(moe_kw or {}))
        base["family"] = "moe"
        jm, tm = JMoEConfig(**mkw), TMoEConfig(**mkw)
    return JModelConfig(**base, moe=jm), TModelConfig(**base, moe=tm)


def jax_params(jcfg, seed: int = 0, fp32: bool = True):
    """JAX parameters as tests/conftest.py:init_model draws them."""
    from repro.models.model import model_decl
    from repro.sharding.rules import init_from_decls

    params = init_from_decls(model_decl(jcfg), jax.random.PRNGKey(seed))
    if fp32:
        params = jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, params
        )
    return params


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_rel(out, ref, rel=BF16_REL):
    out, ref = f32(out), f32(ref)
    err = float(np.max(np.abs(out - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), (err, float(np.max(np.abs(ref))))
