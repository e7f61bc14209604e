"""Port parity: attention_core (direct, blockwise, kernel routes), the
plain flash attention against the JAX Pallas kernel (interpret mode) and
its oracle, GQA, and ring-decode gqa_apply."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FP32_ATOL, assert_rel, configs, f32

import repro.models.attention as JA
import repro_torch.models.attention as TA
from repro.kernels import ops as jops
from repro.kernels.flash_attention import _fa_call
from repro.kernels.ref import flash_attention_ref as j_fa_ref
from repro.sharding.rules import init_from_decls
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ref import flash_attention_ref as t_fa_ref


def _qkv(rng, B=2, Sq=32, Sk=32, H=4, KV=2, d=16):
    return tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                 for s in ((B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d)))


def _both(arrs, dtype="float32"):
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8), (False, None)])
def test_attention_core_direct(rng, causal, window):
    (q, k, v) = _qkv(rng, Sq=8, Sk=24)  # Sq <= 8: the direct path
    qp = (np.arange(8) + 16)[None].repeat(2, 0).astype(np.int32)
    kp = np.arange(24)[None].repeat(2, 0).astype(np.int32)
    kp[1, :3] = -1  # invalid ring slots
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    jout = JA.attention_core(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp), window, causal=causal)
    tout = TA.attention_core(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp), window, causal=causal)
    np.testing.assert_allclose(f32(tout), f32(jout), atol=1e-5)


@pytest.mark.parametrize("window", [None, 32])
def test_attention_core_blockwise(rng, monkeypatch, window):
    (q, k, v) = _qkv(rng, Sq=128, Sk=128)
    pos = np.arange(128)[None].repeat(2, 0).astype(np.int32)
    for mod in (JA, TA):  # force the blockwise route at a small size
        monkeypatch.setattr(mod, "_BLOCKWISE_MIN_SEQ", 32)
        monkeypatch.setattr(mod, "_KV_BLOCK", 32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    jout = JA.attention_core(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), window)
    tout = TA.attention_core(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos), window)
    np.testing.assert_allclose(f32(tout), f32(jout), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_kernel_route(rng, dtype):
    """use_kernel=True: JAX runs its Pallas flash kernel in interpret mode,
    the port on a CPU tensor runs the kernel's plain version."""
    (q, k, v) = _qkv(rng, Sq=32, Sk=32)
    pos = np.arange(32)[None].repeat(2, 0).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    jout = JA.attention_core(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), use_kernel=True)
    tout = TA.attention_core(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos), use_kernel=True)
    if dtype == "float32":
        np.testing.assert_allclose(f32(tout), f32(jout), atol=1e-5)
    else:
        assert_rel(tout, jout)


FA_CASES = [  # (B, S, H, KV, d, causal, window)
    (2, 64, 4, 2, 32, True, None),  # GQA
    (2, 64, 8, 2, 32, True, 16),  # sliding window
    (1, 48, 4, 4, 16, False, None),  # non-causal
    (1, 40, 4, 1, 64, True, None),  # MQA, ragged length
]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_jax_kernel_and_oracle(rng, case, dtype):
    B, S, H, KV, d, causal, window = case
    (q, k, v) = _qkv(rng, B=B, Sq=S, Sk=S, H=H, KV=KV, d=d)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    jk_out = jops.flash_attention(jq, jk, jv, causal=causal, window=window)  # Pallas, interpret
    jref = j_fa_ref(jq, jnp.repeat(jk, H // KV, 2), jnp.repeat(jv, H // KV, 2), causal=causal, window=window)
    tout = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    for ref in (jk_out, jref):
        if dtype == "float32":
            np.testing.assert_allclose(f32(tout), f32(ref), atol=1e-5)
        else:
            assert_rel(tout, ref)
    # the logsumexp the kernel emits for the backward slice
    _, jlse = _fa_call(jq, jk, jv, causal, window, d ** -0.5, (16, 16), True)
    _, tlse = flash_fwd(tq, tk, tv, causal, window)
    np.testing.assert_allclose(f32(tlse), f32(jlse), atol=1e-4 if dtype == "float32" else 2e-2)


def test_flash_ref_is_right_aligned(rng):
    """Sq < Sk: query i sits at position i + Sk - Sq (JAX kernel semantics)."""
    (q, k, v) = _qkv(rng, B=1, Sq=8, Sk=24, H=4, KV=2, d=16)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    jref = j_fa_ref(jq, jnp.repeat(jk, 2, 2), jnp.repeat(jv, 2, 2), causal=True, window=6)
    np.testing.assert_allclose(f32(t_fa_ref(tq, tk, tv, True, 6)), f32(jref), atol=1e-5)


def test_ring_decode_gqa_apply(rng):
    """Single-token decode against the ring cache: write at the slot, attend
    over valid slots (slot_pos >= 0), window honoured."""
    jcfg, tcfg = configs(moe=False, sliding_window=6)
    decl = JA.gqa_decl(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), init_from_decls(decl, jax.random.PRNGKey(3)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    B, W, KV, hd = 2, 8, tcfg.num_kv_heads, tcfg.head_dim_
    kc = (rng.standard_normal((B, W, KV, hd)) * 0.3).astype(np.float32)
    vc = (rng.standard_normal((B, W, KV, hd)) * 0.3).astype(np.float32)
    pos = np.array([5, 11], np.int32)
    slot = pos % W
    slot_pos = np.array([[0, 1, 2, 3, 4, 5, -1, -1], [8, 9, 10, 11, 4, 5, 6, 7]], np.int32)
    x = (rng.standard_normal((B, 1, tcfg.d_model)) * 0.5).astype(np.float32)
    jout, jc = JA.gqa_apply(
        jcfg, None, jp, jnp.asarray(x), jnp.asarray(pos[:, None]),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        {"slot": jnp.asarray(slot), "slot_pos": jnp.asarray(slot_pos)},
    )
    tcache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    tout, tc = TA.gqa_apply(
        tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos[:, None]), tcache,
        {"slot": torch.from_numpy(slot).long(), "slot_pos": torch.from_numpy(slot_pos)},
    )
    np.testing.assert_allclose(f32(tout), f32(jout), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(tc["k"]), f32(jc["k"]), atol=1e-5)
    np.testing.assert_allclose(f32(tc["v"]), f32(jc["v"]), atol=1e-5)
