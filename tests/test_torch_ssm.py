"""Port parity for the SSM and hybrid families (mamba2-2.7b, jamba): the
chunked SSD scan, the Mamba-2 block's prefill and recurrent step, the smoke
configs' loss and gradients, prefill + decode against the full forward,
the ring engine's tokens against the JAX engine's, and the valid-length
repair of the bucketed prefill.

The JAX ``prefill_forward(valid_len=...)`` lets a bucket's pad tokens into
the SSM state and conv tail (``ssd_chunked`` runs over all S positions,
the tail is taken at the bucket's end), so its first decode after a
bucketed prefill is not its unpadded prefill's. The port keeps ``valid_len``'s
contract (pad positions are invalid): its bucketed prefill equals the JAX
unpadded prefill. ``test_reference_bucketed_prefill_defect_pinned`` pins
the reference's behaviour so a change on either side shows.

Tolerances: ``FP32_ATOL`` (1e-4) on fp32 logits, outputs and cache leaves
of magnitude ~1 (the same arithmetic in another summation order); SSD
outputs and states 1e-4 of max|ref|; bf16 ``BF16_REL`` (2e-2) of max|ref|
(the frameworks round intermediates to bf16 at different points);
gradients ``GRAD_REL`` (5e-4) of max|g| per parameter; losses 1e-5
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BF16_REL, FP32_ATOL, assert_rel, check_grads, f32, jax_params, to_torch

import repro.config as JC
import repro_torch.config as TC
from repro.models import ssm as jssm
from repro.models.model import decode_step as j_decode
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill_forward as j_prefill
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.models import ssm as tssm
from repro_torch.models.model import decode_step as t_decode
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import prefill_forward as t_prefill
from repro_torch.models.model import prefill_reference as t_prefill_ref
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")
# of max|g| per parameter: fp32 gradients reduced over B x S positions in
# another order (jamba's D_skip, a sum with cancellation, parts by 1.04e-4)
GRAD_REL = 5e-4
_CACHE = {}


def _pair(arch, dtype="float32"):
    j = JC.smoke_config(JC.get_config(arch)).replace(dtype=dtype)
    t = TC.smoke_config(TC.get_config(arch)).replace(dtype=dtype)
    return j, t


def _params(arch):
    """The fp32 smoke config's JAX parameters and their port copy (drawn once)."""
    if arch not in _CACHE:
        j, t = _pair(arch)
        jp = jax_params(j)
        _CACHE[arch] = (j, t, jp, to_torch(jp))
    return _CACHE[arch]


def _rel_le(out, ref, rel):
    out, ref = f32(out), f32(ref)
    assert float(np.abs(out - ref).max()) <= rel * float(np.abs(ref).max())


@pytest.mark.parametrize("S,chunk,groups,heads,init", [
    (32, 8, 2, 4, False), (32, 8, 2, 4, True), (48, 16, 1, 3, True), (16, 16, 4, 8, False), (64, 32, 2, 2, True),
])
def test_ssd_chunked_matches_jax(S, chunk, groups, heads, init):
    """y and the final state at several lengths, chunks, B/C groups and
    head counts, with and without an initial state (fp32)."""
    rng = np.random.default_rng(S + chunk + groups)
    B, P, N = 2, 8, 16
    x = rng.standard_normal((B, S, heads, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, S, heads))) * 0.1 + 0.01).astype(np.float32)
    A = -np.exp(rng.uniform(0, 2, heads)).astype(np.float32)
    Bm = rng.standard_normal((B, S, groups, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, groups, N)).astype(np.float32)
    s0 = rng.standard_normal((B, heads, P, N)).astype(np.float32) if init else None
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                              None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
                              None if s0 is None else torch.from_numpy(s0))
    _rel_le(ty, jy, 1e-4)
    _rel_le(ts, js, 1e-4)


def test_ssd_chunked_ragged_length():
    """A length the chunk does not divide (the JAX version asserts): padded
    with dt 0 positions inside, it equals the JAX scan at a chunk that
    divides the length."""
    rng = np.random.default_rng(3)
    B, S, H, P, G, N = 1, 20, 4, 8, 2, 16
    args = [rng.standard_normal((B, S, H, P)), np.abs(rng.standard_normal((B, S, H))) * 0.1,
            -np.exp(rng.uniform(0, 2, H)), rng.standard_normal((B, S, G, N)), rng.standard_normal((B, S, G, N))]
    args = [a.astype(np.float32) for a in args]
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), 4)
    ty, ts = tssm.ssd_chunked(*(torch.from_numpy(a) for a in args), 8)
    assert tuple(ty.shape) == (B, S, H, P)
    _rel_le(ty, jy, 1e-4)
    _rel_le(ts, js, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_prefill_and_decode_match_jax(dtype):
    """The Mamba-2 block of smoke mamba2: prefill output and its cache
    (conv tail, state), then two recurrent steps from that cache."""
    j, t = _pair("mamba2-2.7b", dtype)
    from repro.models.ssm import ssm_decl
    from repro.sharding.rules import init_from_decls

    jp = init_from_decls(ssm_decl(j), jax.random.PRNGKey(1))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = to_torch(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, j.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(j.dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jc = jssm.ssm_apply(j, None, jp, jx, return_state=True)
    ty, tc = tssm.ssm_apply(t, tp, tx, return_state=True)
    check = (lambda a, b: np.testing.assert_allclose(f32(a), f32(b), atol=FP32_ATOL)) if dtype == "float32" \
        else (lambda a, b: assert_rel(a, b, BF16_REL))
    check(ty, jy)
    check(tc["conv"], jc["conv"])
    check(tc["state"], jc["state"])
    for i in range(2):
        step = rng.standard_normal((2, 1, j.d_model)).astype(np.float32)
        jy, jc = jssm.ssm_apply(j, None, jp, jnp.asarray(step).astype(j.dtype), cache=jc)
        ty, tc = tssm.ssm_apply(t, tp, torch.from_numpy(step).to(tx.dtype), cache=tc)
        check(ty, jy)
        check(tc["state"], jc["state"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The smoke configs' loss_fn (mamba2: 2 SSM layers; jamba: one period
    "MMMAMMMM" with MoE on the odd slots) and every parameter's gradient
    (fp32; the port's kernel path, the kernels' plain versions on the CPU,
    against the JAX plain path)."""
    j, t, jp, tp = _params(arch)
    toks = np.random.default_rng(12).integers(0, j.vocab_size, (2, 32)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(j, None, p, jb), has_aux=True))(jp)
    check_grads(t, tp, tb, jm, jg, GRAD_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equal_full_forward(arch):
    """Prefill 12 tokens, then decode 4: each step's logits equal the full
    forward's at that position; ``prefill_reference`` (decode_step over the
    prompt) gives the prefill's logits and cache (fp32, port only)."""
    j, t, jp, tp = _params(arch)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, t.vocab_size, (1, 16)).astype(np.int32))
    full, _ = t_forward(t, tp, {"tokens": toks}, use_kernel=True)
    logits, cache = t_prefill(t, tp, {"tokens": toks[:, :12]}, cache_len=24, use_kernel=True)
    np.testing.assert_allclose(f32(logits), f32(full[:, 11]), atol=FP32_ATOL)
    rl, rc = t_prefill_ref(t, tp, {"tokens": toks[:, :12]}, cache_len=24)
    np.testing.assert_allclose(f32(rl), f32(logits), atol=FP32_ATOL)
    for (a, b) in zip(_leaves(rc["stack"]), _leaves(cache["stack"])):
        np.testing.assert_allclose(f32(a), f32(b), atol=FP32_ATOL)
    for i in range(12, 16):
        logits, cache = t_decode(t, tp, cache, toks[:, i], use_kernel=True)
        if i < 15:
            np.testing.assert_allclose(f32(logits), f32(full[:, i]), atol=FP32_ATOL)


def _leaves(tree):
    from repro_torch.params import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_engine_tokens_equal_jax(arch):
    """Prompt lengths that are powers of two >= 16 (the JAX engine does not
    pad them), 3 requests on 2 slots: the port's ring engine gives the JAX
    engine's greedy tokens."""
    j, t, jp, tp = _params(arch)

    def reqs(cls):
        rng = np.random.default_rng(11)
        return [cls(rid=i, prompt=rng.integers(0, j.vocab_size, L).astype(np.int32), max_new_tokens=n)
                for i, (L, n) in enumerate([(16, 4), (32, 3), (16, 3)])]

    jout = JEngine(j, jp, max_batch=2, max_seq=48).run(reqs(JRequest))
    tout = TEngine(t, tp, max_batch=2, max_seq=48, use_kernel=True, device="cpu").run(reqs(TRequest))
    assert tout == jout and [len(tout[i]) for i in range(3)] == [4, 3, 3]


def _first_decode(prefill, decode, cfg, params, prompt, bucket, tok, **kw):
    """(prefill logits, first-decode logits) of ``prompt`` padded to
    ``bucket`` (``bucket=None``: unpadded)."""
    L = len(prompt)
    if bucket is None:
        toks, vl = prompt[None], None
    else:
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = prompt
        vl = np.array([L], np.int32)
    conv = kw.pop("conv")
    args = {"tokens": conv(toks)}
    if vl is None:
        lg, c = prefill(cfg, params, args, cache_len=40, **kw)
    else:
        lg, c = prefill(cfg, params, args, cache_len=40, valid_len=conv(vl), **kw)
    lg2, _ = decode(cfg, params, c, conv(np.array([tok], np.int32)))
    return lg, lg2


def _both(arch, L=16, bucket=32):
    j, t, jp, tp = _params(arch)
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, j.vocab_size, L).astype(np.int32)
    tok = int(rng.integers(0, j.vocab_size))
    jx = lambda b: _first_decode(lambda c, p, a, **k: j_prefill(c, None, p, a, **k),  # noqa: E731
                                 lambda c, p, cc, tk: j_decode(c, None, p, cc, tk), j, jp, prompt, b, tok,
                                 conv=jnp.asarray)
    tx = lambda b: _first_decode(t_prefill, t_decode, t, tp, prompt, b, tok, conv=torch.from_numpy)  # noqa: E731
    return jx, tx


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_equals_unpadded(arch):
    """A 16-token prompt in a 32-token bucket: the port's prefill logits and
    first-decode logits equal the JAX package's unpadded prefill's and the
    port's own unpadded prefill's."""
    jx, tx = _both(arch)
    j_pre, j_dec = jx(None)
    t_pre, t_dec = tx(32)
    u_pre, u_dec = tx(None)
    for a, b in ((t_pre, j_pre), (t_dec, j_dec), (t_pre, u_pre), (t_dec, u_dec)):
        np.testing.assert_allclose(f32(a), f32(b), atol=FP32_ATOL)


def test_reference_bucketed_prefill_defect_pinned():
    """The JAX package's bucketed prefill (L 16, bucket 32, smoke mamba2)
    continues from a state its pad tokens entered: its first decode after
    the bucketed prefill differs from its unpadded prefill's by more than
    0.5 of max|logits| (1.10 measured), while the prefill logits agree. The
    port matches the unpadded JAX decode and its own unpadded prefill."""
    jx, tx = _both("mamba2-2.7b")
    j_pre, j_dec = jx(None)
    jb_pre, jb_dec = jx(32)
    np.testing.assert_allclose(f32(jb_pre), f32(j_pre), atol=FP32_ATOL)
    rel = float(np.abs(f32(jb_dec) - f32(j_dec)).max()) / float(np.abs(f32(j_dec)).max())
    assert rel > 0.5, rel
    t_pre, t_dec = tx(32)
    u_pre, u_dec = tx(None)
    np.testing.assert_allclose(f32(t_dec), f32(j_dec), atol=FP32_ATOL)
    np.testing.assert_allclose(f32(t_dec), f32(u_dec), atol=FP32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_mode_raises(arch):
    """The page pool holds GQA attention stacks only (the JAX pool
    declaration refuses SSM stacks too): the paged engine raises."""
    j, t, jp, tp = _params(arch)
    with pytest.raises(ValueError, match="GQA attention stacks only"):
        TEngine(t, tp, cache_mode="paged", device="cpu")
    from repro.models.model import paged_stack_decl

    with pytest.raises(AssertionError):
        paged_stack_decl(j, 8, 16)


def test_mamba2_refuses_to_upcycle():
    """No FFN (d_ff 0): upcycling does not apply, in either package."""
    from repro.core.upcycle import upcycle_config as j_up
    from repro_torch.core.upcycle import upcycle_config as t_up

    for up, C, M in ((j_up, JC, JC.MoEConfig), (t_up, TC, TC.MoEConfig)):
        with pytest.raises(AssertionError, match="FFN-free"):
            up(C.get_config("mamba2-2.7b"), M(8, 2))


def test_int8_quantises_the_experts_only():
    """jamba's int8 serving tree: the MoE slots' ``experts`` dicts become
    int8 with scales; the dense slots' FFNs (same three keys) stay bf16, so
    the dense ``mlp_apply`` runs; the direct int8 draw equals quantising
    the bf16 draw bit for bit. The JAX ``quantize_params`` quantises the
    dense FFNs too (pinned: its ``mlp_apply`` would then multiply by raw
    int8 values)."""
    from repro.core.quant import quantize_params as j_quantize
    from repro_torch.core.quant import INT8_LOGIT_BUDGET, quantize_params
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    j, t = _pair("jamba-1.5-large-398b", "bfloat16")
    bf16 = init_from_decls(model_decl(t), 5, "cpu")
    q = quantize_params(bf16)
    direct = init_from_decls(model_decl(t), 5, "cpu", quant_weights="int8")
    for tree in (q, direct):
        assert tree["stack"]["slot0"]["ffn"]["w_gate"].dtype == torch.bfloat16
        assert "w_gate_scale" not in tree["stack"]["slot0"]["ffn"]
        assert tree["stack"]["slot1"]["ffn"]["experts"]["w_gate"].dtype == torch.int8
    for a, b in zip(_leaves(q), _leaves(direct)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int8) if a.dtype == torch.int8 else a,
                                                  b.view(torch.int8) if b.dtype == torch.int8 else b)
    toks = torch.from_numpy(np.random.default_rng(15).integers(0, t.vocab_size, (1, 16)).astype(np.int32))
    lb, _ = t_forward(t, bf16, {"tokens": toks}, use_kernel=True)
    lq, _ = t_forward(t.replace(quant_weights="int8"), q, {"tokens": toks}, use_kernel=True)
    assert float((lq - lb).abs().max()) <= INT8_LOGIT_BUDGET * float(lb.abs().max())
    jp = j_quantize(jax_params(j, fp32=False))
    assert jp["stack"]["slot0"]["ffn"]["w_gate"].dtype == jnp.int8
