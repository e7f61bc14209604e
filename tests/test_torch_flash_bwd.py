"""Port parity for the flash-attention backward (kernels #17-#18): the
``FlashAttention`` autograd Function on its plain versions, and the plain
dq and dk/dv functions fed the JAX forward's own out and lse, against
``jax.vjp`` of the JAX Pallas kernels in interpret mode, on the same numpy
inputs.

Tolerances: fp32 inputs 1e-5 of max |ref| (the same fp32 arithmetic, other
summation order); bf16 inputs ``BF16_REL`` of max |ref| (the frameworks
round q, k, v products and the probabilities at other points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel, f32

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CASES = [  # (B, Sq, Sk, H, KV, d, causal, window)
    (2, 40, 40, 4, 2, 32, True, None),  # G = 2, S not a multiple of any tile
    (1, 50, 50, 8, 2, 64, True, 16),  # G = 4, sliding window
    (1, 24, 56, 4, 1, 32, True, None),  # G = 4, right-aligned Sq < Sk
    (1, 33, 33, 4, 2, 16, False, None),  # non-causal
    (1, 40, 40, 8, 1, 32, True, None),  # G = 8: the dk/dv kernel's widest cluster
]


def _inputs(rng, case, dtype):
    B, Sq, Sk, H, KV, d, _, _ = case
    arrs = [rng.standard_normal(s).astype(np.float32) * c
            for s, c in (((B, Sq, H, d), 0.5), ((B, Sk, KV, d), 0.5), ((B, Sk, KV, d), 0.5), ((B, Sq, H, d), 1.0))]
    return [jnp.asarray(a, dtype) for a in arrs], [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _close(out, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(f32(out), f32(ref), atol=1e-5 * float(np.abs(f32(ref)).max()))
    else:
        assert_rel(out, ref)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_matches_jax_vjp(rng, case, dtype):
    _, _, _, _, _, _, causal, window = case
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(rng, case, dtype)
    jout, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal=causal, window=window), jq, jk, jv)
    jg = vjp(jdo)
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = tops.flash_attention(q, k, v, causal=causal, window=window)
    _close(out, jout, dtype)
    out.backward(tdo)
    for t, j, src in zip((q.grad, k.grad, v.grad), jg, (q, k, v)):
        assert t.shape == src.shape and t.dtype == src.dtype
        _close(t, j, dtype)


@pytest.mark.parametrize("case", CASES[:3])
def test_plain_dq_dkv_on_the_jax_forward_residuals(rng, case):
    """dq and (dk, dv) from the port's plain versions, fed the JAX kernel's
    own out and lse (and delta = rowsum(dO * O)), equal the JAX backward's;
    the port's forward lse equals the JAX kernel's."""
    B, Sq, Sk, H, KV, d, causal, window = case
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(rng, case, "float32")
    scale = d ** -0.5
    jout, jlse = jfa._fa_call(jq, jk, jv, causal, window, scale, jfa.DEFAULT_BLOCKS, True)
    _, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal=causal, window=window), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    _, tlse = tref.flash_attention_ref(tq, tk, tv, causal, window, scale, return_lse=True)
    np.testing.assert_allclose(f32(tlse), f32(jlse), atol=1e-5)
    out, lse = torch.from_numpy(np.array(jout)), torch.from_numpy(np.array(jlse))
    delta = tref.flash_bwd_delta(out, tdo)
    assert delta.shape == (B * H, Sq)
    args = (tq, tk, tv, tdo, lse, delta, causal, window, scale)
    _close(tref.flash_bwd_dq_ref(*args), jdq, "float32")
    dk, dv = tref.flash_bwd_dkv_ref(*args)
    _close(dk, jdk, "float32")
    _close(dv, jdv, "float32")


def test_flash_backward_never_falls_back():
    """A tensor that is neither CPU nor CUDA is refused, not run plain."""
    from repro_torch.kernels import flash_attention as tfa

    q = torch.zeros((1, 16, 2, 64), device="meta")
    lse = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_bwd(q, q, q, q, lse, q, True, None, 0.125)


_GOOD = {"dq": ((1, 8, 2, 64), torch.bfloat16), "dk": ((1, 8, 1, 64), torch.bfloat16),
         "dv": ((1, 8, 1, 64), torch.bfloat16)}


def _bad_out(name, fault):
    shape, dtype = _GOOD[name]
    if fault == "shape":
        return torch.zeros((1, 8, 2, 32) if name == "dq" else (1, 8, 2, 64), dtype=dtype)
    if fault == "dtype":
        return torch.zeros(shape, dtype=torch.float32)
    if fault == "layout":
        return torch.zeros(shape[:-1] + (2 * shape[-1],), dtype=dtype)[..., ::2]
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device"])
@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_backward_out_is_checked_before_any_library(monkeypatch, name, fault):
    """A wrong ``out=`` on the backward wrappers raises ValueError from the
    argument checks, before a library is loaded or a stream looked up."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 8))
    args = (q, k, k, q, lse, lse, True, None, 0.125)
    good = {n: torch.zeros(s, dtype=d) for n, (s, d) in _GOOD.items()}
    with pytest.raises(ValueError, match=f"out {name}"):
        if name == "dq":
            tfa.flash_bwd_dq_cuda(*args, out=_bad_out(name, fault))
        else:
            out = {**good, name: _bad_out(name, fault)}
            tfa.flash_bwd_dkv_cuda(*args, out=(out["dk"], out["dv"]))
