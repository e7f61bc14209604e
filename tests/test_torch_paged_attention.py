"""Port parity of the paged-attention decode kernels' plain versions, of the
int8 KV quantiser, and of ``paged_forward``: the same numpy-drawn inputs go
through the JAX package (its Pallas kernels in interpret mode, and its
oracles) and through the port on the CPU.

Tolerances: ``FP32_ATOL`` (1e-4) in fp32 — the same arithmetic, summed in
another order; ``BF16_REL`` (2e-2 of max |ref|) in bf16 — the frameworks
round intermediates to bf16 at other points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BF16_REL, FP32_ATOL, assert_rel, configs, f32, jax_params, to_torch

from repro.core.quant import quantize_kv as j_quantize_kv
from repro.kernels.ops import paged_attention as j_pa
from repro.kernels.ops import paged_attention_q8 as j_pa_q8
from repro.kernels.ref import paged_attention_q8_ref as j_pa_q8_ref
from repro.kernels.ref import paged_attention_ref as j_pa_ref
from repro.models.model import paged_forward as j_paged_forward
from repro.models.model import paged_stack_decl as j_paged_stack_decl
from repro.sharding.rules import ParamDecl as JDecl
from repro_torch.core.quant import dequantize_kv, quantize_kv
from repro_torch.kernels import ops
from repro_torch.models.model import paged_forward as t_paged_forward
from repro_torch.models.model import paged_stack_decl as t_paged_stack_decl
from repro_torch.params import init_from_decls, tree_leaves


def _case(rng, B, H, KV, d, ps, maxP, lens, num_pages=None, hole=False):
    """Random pools and disjoint per-sequence page lists covering ``lens``
    (``hole``: the first sequence's second page released to -1)."""
    num_pages = num_pages or B * maxP
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, ps, KV, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, ps, KV, d)).astype(np.float32)
    perm = rng.permutation(num_pages)
    bt = np.full((B, maxP), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-int(lens[b]) // ps)
        bt[b, :need] = perm[used:used + need]
        used += need
    if hole:
        bt[0, 1] = -1
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _both(q, kp, vp, bt, sl, window=None, dtype=np.float32):
    jargs = [jnp.asarray(a.astype(dtype) if a.dtype == np.float32 else a) for a in (q, kp, vp, bt, sl)]
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    targs = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32 else torch.from_numpy(a)
             for a in (q, kp, vp, bt, sl)]
    jk = j_pa(*jargs, window=window)
    jr = j_pa_ref(*jargs, window=window)
    t = ops.paged_attention(*targs, window=window)
    return t, jk, jr


@pytest.mark.parametrize("H,KV", [(4, 1), (4, 2), (8, 8), (6, 3)])
@pytest.mark.parametrize("ps", [1, 4, 8])
def test_plain_matches_jax_gqa_page_sweep(H, KV, ps):
    rng = np.random.default_rng(H * 100 + ps)
    B, d, maxP = 3, 32, 6
    lens = rng.integers(1, maxP * ps + 1, B)
    t, jk, jr = _both(*_case(rng, B, H, KV, d, ps, maxP, lens))
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


@pytest.mark.parametrize("window", [1, 3, 8, 64])
def test_plain_matches_jax_window(window):
    rng = np.random.default_rng(window)
    B, H, KV, d, ps, maxP = 2, 4, 2, 64, 4, 8
    lens = rng.integers(1, maxP * ps + 1, B)
    t, jk, jr = _both(*_case(rng, B, H, KV, d, ps, maxP, lens), window=window)
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


def test_released_pages_and_idle_row():
    """A -1 page in the middle of a table is masked, a row with seq_len 0
    gives exact zeros, and both agree with the JAX kernel."""
    rng = np.random.default_rng(7)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 32, 4, 5, [18, 9, 0], hole=True)
    t, jk, jr = _both(q, kp, vp, bt, sl)
    assert (bt[0] == -1).sum() > 0 and (bt[2] == -1).all()
    np.testing.assert_array_equal(f32(t)[2], 0.0)
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)


@pytest.mark.parametrize("window", [None, 8])
def test_plain_matches_jax_bf16(window):
    rng = np.random.default_rng(11)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 64, 8, 6, [40, 7, 0], hole=True)
    t, jk, jr = _both(q, kp, vp, bt, sl, window=window, dtype=jnp.bfloat16)
    assert t.dtype == torch.bfloat16
    assert_rel(t, jk, BF16_REL)
    assert_rel(t, jr, BF16_REL)
    np.testing.assert_array_equal(f32(t)[2], 0.0)


def test_quantize_kv_identical_to_jax(rng):
    """Same int8 values and scales: fp32 division, round half to even,
    clip to +-127; round trip within half a step per element."""
    x = (rng.standard_normal((3, 5, 2, 32)) * rng.uniform(0.01, 10, (3, 5, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes the eps scale
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = dequantize_kv(tq, ts).numpy()
    assert np.all(np.abs(back - x) <= ts.numpy() / 2 + 1e-6)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_q8_matches_jax(window):
    rng = np.random.default_rng(21)
    q, kp, vp, bt, sl = _case(rng, 3, 8, 2, 32, 4, 6, [21, 13, 0], hole=True)
    kq, ks = j_quantize_kv(jnp.asarray(kp))
    vq, vs = j_quantize_kv(jnp.asarray(vp))
    jargs = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(bt), jnp.asarray(sl))
    jk = j_pa_q8(*jargs, window=window)
    jr = j_pa_q8_ref(*jargs, window=window)
    targs = [torch.from_numpy(np.asarray(a)) for a in jargs]
    t = ops.paged_attention_q8(*targs, window=window)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(f32(t), f32(jk), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t), f32(jr), atol=FP32_ATOL)
    np.testing.assert_array_equal(f32(t)[2], 0.0)


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
def test_paged_stack_decl_matches_jax(quant_kv):
    jcfg, tcfg = configs(fp32=False, quant_kv=quant_kv)
    jd = j_paged_stack_decl(jcfg, 9, 4)["stack"]["slot0"]["attn"]
    td = t_paged_stack_decl(tcfg, 9, 4)["stack"]["slot0"]["attn"]
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert jd[k].shape == td[k].shape, k
        assert str(jnp.dtype(jd[k].dtype)) == str(td[k].dtype).replace("torch.", ""), k


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_forward_chunk_then_decode(rng, quant_kv, use_kernel):
    """One prefill chunk (right-padded, with an idle row) and one decode
    step through both packages: logits and every written pool leaf agree
    (fp32)."""
    jcfg, tcfg = configs(quant_kv=quant_kv)
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    ps, num_pages, maxP, S = 4, 13, 5, 8
    jpool = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), j_paged_stack_decl(jcfg, num_pages, ps),
                         is_leaf=lambda d: isinstance(d, JDecl))
    tpool = init_from_decls(t_paged_stack_decl(tcfg, num_pages, ps), 0, "cpu")
    bt = np.full((2, maxP), -1, np.int32)
    bt[0, :3] = [5, 2, 9]
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    start = np.array([0, 0], np.int32)
    vlen = np.array([7, 0], np.int32)  # row 1 idle: its writes go to the trash page

    jl, jpool = j_paged_forward(jcfg, None, jp, jpool, jnp.asarray(toks), jnp.asarray(start),
                                jnp.asarray(bt), jnp.asarray(vlen), use_kernel=use_kernel)
    tl, tpool = t_paged_forward(tcfg, tp, tpool, torch.from_numpy(toks), torch.from_numpy(start),
                                torch.from_numpy(bt), torch.from_numpy(vlen), use_kernel=use_kernel)
    np.testing.assert_allclose(f32(tl)[0], f32(jl)[0], atol=FP32_ATOL)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([7, 0], np.int32)
    act = np.array([1, 0], np.int32)
    jl, jpool = j_paged_forward(jcfg, None, jp, jpool, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(bt), jnp.asarray(act), use_kernel=use_kernel)
    tl, tpool = t_paged_forward(tcfg, tp, tpool, torch.from_numpy(tok), torch.from_numpy(pos),
                                torch.from_numpy(bt), torch.from_numpy(act), use_kernel=use_kernel)
    np.testing.assert_allclose(f32(tl)[0], f32(jl)[0], atol=FP32_ATOL)
    live = [5, 2, 9]  # the trash page (12) holds whatever the idle row wrote last
    jattn, tattn = jpool["stack"]["slot0"]["attn"], tpool["stack"]["slot0"]["attn"]
    assert sorted(jattn) == sorted(tattn)
    for name in jattn:
        j, t = np.asarray(jattn[name])[:, live], tattn[name].numpy()[:, live]
        if t.dtype == np.int8:  # int8 codes may sit one step apart where fp32 sums differ
            assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t.astype(np.float32), j.astype(np.float32), atol=FP32_ATOL)
    untouched = [p for p in range(num_pages - 1) if p not in live]
    assert all(not t[:, untouched].any() for t in tree_leaves(tpool))
