"""Port parity: norms, RoPE, embed/unembed, SwiGLU MLP, parameter carry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FP32_ATOL, assert_rel, f32

import repro.models.layers as JL
import repro_torch.models.layers as TL
from repro_torch.params import params_from_numpy, params_to_numpy


def _x(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm(rng, norm_type, dtype):
    x = _x(rng, (2, 5, 64))
    p = {"scale": _x(rng, (64,)) + 1.0, "bias": _x(rng, (64,), 0.1)}
    jout = JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x, dtype), norm_type, 1e-5)
    tout = TL.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x).to(getattr(torch, dtype)), norm_type, 1e-5)
    assert tout.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(f32(tout), f32(jout), atol=1e-5)
    else:  # computed in fp32, rounded once to bf16: at most one ulp apart
        assert_rel(tout, jout)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_half_split(rng, theta):
    x = _x(rng, (2, 7, 4, 16))
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    jout = JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), theta)
    tout = TL.rope_apply(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles up to ~4096 rad in fp32: sin/cos argument rounding dominates
    np.testing.assert_allclose(f32(tout), f32(jout), atol=2e-3)
    small = rng.integers(0, 64, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        f32(TL.rope_apply(torch.from_numpy(x), torch.from_numpy(small), theta)),
        f32(JL.rope_apply(jnp.asarray(x), jnp.asarray(small), theta)), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(rng, dtype):
    table = _x(rng, (64, 32), 0.02)
    untable = _x(rng, (64, 32), 0.02)
    toks = rng.integers(0, 64, (3, 5)).astype(np.int32)
    jp = {"embedding": jnp.asarray(table), "unembedding": jnp.asarray(untable)}
    tp = {"embedding": torch.from_numpy(table), "unembedding": torch.from_numpy(untable)}
    jx = JL.embed_apply(jp, jnp.asarray(toks), jnp.dtype(dtype))
    tx = TL.embed_apply(tp, torch.from_numpy(toks), getattr(torch, dtype))
    np.testing.assert_array_equal(f32(tx), f32(jx))  # a gather and one cast
    jl, tl = JL.unembed_apply(jp, jx), TL.unembed_apply(tp, tx)
    assert tl.dtype == torch.float32  # fp32 logits from operands in x's dtype
    np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(rng, dtype):
    w = {k: _x(rng, s, 0.1) for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    x = _x(rng, (2, 5, 32))
    jout = JL.mlp_apply({k: jnp.asarray(v, dtype) for k, v in w.items()}, jnp.asarray(x, dtype))
    tt = getattr(torch, dtype)
    tout = TL.mlp_apply({k: torch.from_numpy(v).to(tt) for k, v in w.items()}, torch.from_numpy(x).to(tt))
    if dtype == "float32":
        np.testing.assert_allclose(f32(tout), f32(jout), atol=FP32_ATOL)
    else:
        assert_rel(tout, jout)


def test_params_from_numpy_carries_bf16_bits(rng):
    """A JAX bf16 leaf arrives as numpy 'bfloat16' (ml_dtypes) and must
    cross bit for bit; fp32 and int leaves keep their dtype."""
    x = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    tree = {"a": {"w": np.asarray(x)}, "s": np.arange(3, dtype=np.int32),
            "f": np.ones(2, np.float32)}
    t = params_from_numpy(tree, "cpu")
    assert t["a"]["w"].dtype == torch.bfloat16
    assert t["s"].dtype == torch.int32 and t["f"].dtype == torch.float32
    np.testing.assert_array_equal(t["a"]["w"].float().numpy(), np.asarray(x, np.float32))
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["a"]["w"], np.asarray(x, np.float32))
    np.testing.assert_array_equal(back["s"], tree["s"])
