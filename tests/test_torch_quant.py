"""Port parity of int8 expert weights: ``quantize_weight`` and
``quantize_params`` bit-equal to the JAX package's, the direct int8 init,
the int8 grouped kernels' plain versions (#10/#11) against the JAX Pallas
kernels (interpret mode) and their oracle, and the ring and paged engines'
greedy tokens with ``quant_weights="int8"`` against the JAX engines', on
the sorted and the padded (``allgather``) dispatcher. The padded int8
kernels' own parity tests are in ``test_torch_padded_q8.py``.

Tolerances: int8 values and bf16 scales are compared bit for bit (same fp32
division, same round-half-to-even). The grouped q8 FFN in fp32 within 1e-5
(the same arithmetic, another summation order); in bf16 ``BF16_REL`` of
max|ref| (the frameworks round at other points). The engines in fp32 emit
identical tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import GG_CASES, _sorted_buffer
from torch_parity import assert_rel, configs, f32, jax_params, to_torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels.ref import grouped_gemm_q8_ref as j_q8_ref
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.config import get_config, smoke_config
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.models.model import forward, model_decl
from repro_torch.params import init_from_decls, tree_leaves
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (both packages' trees are plain dicts)."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree}


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bit_equal_to_jax(rng, dtype):
    w = (rng.standard_normal((2, 3, 64, 48)) * 0.05).astype(np.float32)
    w[0, 1, :, 7] = 0.0  # an all-zero column: scale eps / 127, values 0
    w[1, 0, 5, 3] = 2.5  # one outlier sets its column's scale
    jqv, js = jq.quantize_weight(jnp.asarray(w, dtype))
    tqv, ts = tq.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)))
    assert tqv.dtype == torch.int8 and ts.dtype == torch.bfloat16 and ts.shape == (2, 3, 48)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(ts).numpy(), np.asarray(js).view(np.int16))
    assert int(tqv[0, 1, :, 7].abs().max()) == 0
    np.testing.assert_array_equal(
        f32(tq.dequantize_weight(tqv, ts)), f32(jq.dequantize_weight(jqv, js)))


def test_quantize_params_bit_equal_and_idempotent():
    jcfg, tcfg = configs(fp32=False)
    jp = jax_params(jcfg, fp32=False)
    jqp, tqp = jq.quantize_params(jp), tq.quantize_params(to_torch(jp))
    tex = tqp["stack"]["slot0"]["ffn"]["experts"]
    assert sorted(tex) == sorted(jqp["stack"]["slot0"]["ffn"]["experts"])
    tflat, jflat = _flat(tqp), _flat(jqp)
    assert sorted(tflat) == sorted(jflat)
    for k, a in tflat.items():
        b = jflat[k]
        assert str(a.dtype).split(".")[-1] == str(b.dtype), k
        np.testing.assert_array_equal(_bits(a).numpy(), np.asarray(b).view(np.int16) if b.dtype == jnp.bfloat16
                                      else np.asarray(b), err_msg=k)
    assert tq.quantize_params(tqp)["stack"]["slot0"]["ffn"]["experts"] is tex  # idempotent
    assert tq.is_quantized(tex) and not tq.is_quantized(to_torch(jp)["stack"]["slot0"]["ffn"]["experts"])
    deq = tq.dequantize_experts(tex, torch.float32)
    for k, v in jq.dequantize_experts(jqp["stack"]["slot0"]["ffn"]["experts"], jnp.float32).items():
        np.testing.assert_array_equal(f32(deq[k]), f32(v))


def test_direct_int8_init_equals_quantized_bf16_init():
    """``init_from_decls(..., quant_weights="int8")`` draws the same stream
    and gives ``quantize_params`` of the bf16 init bit for bit, with the
    shapes and dtypes ``quantize_decls`` declares."""
    _, tcfg = configs(fp32=False)
    decls = model_decl(tcfg)
    direct = init_from_decls(decls, 3, "cpu", quant_weights="int8")
    ref = tq.quantize_params(init_from_decls(decls, 3, "cpu"))
    qdecls = tq.quantize_decls(decls)
    leaves = lambda t: [x for x in tree_leaves(t)]
    assert len(leaves(direct)) == len(leaves(ref)) == len(leaves(qdecls))
    for a, b, d in zip(leaves(direct), leaves(ref), leaves(qdecls)):
        assert a.dtype == b.dtype == d.dtype and tuple(a.shape) == tuple(b.shape) == d.shape
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="quant_weights"):
        init_from_decls(decls, 3, "cpu", quant_weights="int4")


@pytest.mark.parametrize("case", GG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_q8_matches_jax_kernel_and_oracle(rng, case, dtype):
    E, D, F, gs, bc = case
    gs, xs, valid = _sorted_buffer(rng, gs, D, bc)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    jq8 = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    tq8 = [tq.quantize_weight(torch.from_numpy(w)) for w in ws]
    jargs = [jnp.asarray(xs, dtype)] + [q for q, _ in jq8] + [s for _, s in jq8] + [jnp.asarray(gs)]
    targs = [torch.from_numpy(xs).to(getattr(torch, dtype))] + [q for q, _ in tq8] + [s for _, s in tq8] \
        + [torch.from_numpy(gs)]
    jk = jops.grouped_gemm_q8(*jargs, row_block=bc)  # Pallas, interpret mode
    jr = j_q8_ref(*jargs, row_block=bc)
    ty = tops.grouped_gemm_q8(*targs, row_block=bc)
    assert ty.dtype == targs[0].dtype
    assert f32(ty)[~valid].max(initial=0) == 0 and f32(ty)[~valid].min(initial=0) == 0
    for ref in (jk, jr):
        if dtype == "float32":
            np.testing.assert_allclose(f32(ty)[valid], f32(ref)[valid], atol=1e-5)
        elif valid.any():
            assert_rel(f32(ty)[valid], f32(ref)[valid])


def test_grouped_q8_is_forward_only(rng):
    gs, xs, _ = _sorted_buffer(rng, (3, 5), 32, 8)
    q = [tq.quantize_weight(torch.randn(s)) for s in ((2, 32, 64), (2, 32, 64), (2, 64, 32))]
    args = [torch.from_numpy(xs)] + [w for w, _ in q] + [s for _, s in q] + [torch.from_numpy(gs)]
    args[4] = args[4].float().requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        tops.grouped_gemm_q8(*args, row_block=8)


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, to_torch(jp)


def _requests(cls, vocab, seed=11, n=5, lmax=30):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, lmax))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 7)))
            for i in range(n)]


PAGED = dict(cache_mode="paged", page_size=8, prefill_chunk=16)
MODES = {"ring": dict(dispatcher="sorted"), "paged": dict(dispatcher="sorted", **PAGED),
         "ring-allgather": dict(dispatcher="allgather"), "paged-allgather": dict(dispatcher="allgather", **PAGED)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_int8_engine_tokens_identical_to_jax(moe, mode, use_kernel):
    """fp32 tiny MoE, sorted or padded (allgather, int8 kernels #8/#9 on the
    kernel path) dispatch, int8 expert weights quantised by each engine from
    the same bf16-free fp32 tree: identical greedy tokens."""
    jcfg, tcfg, jp, tp = moe
    kw = dict(max_batch=2, max_seq=48, use_kernel=use_kernel, quant_weights="int8", **MODES[mode])
    jeng = JEngine(jcfg, jp, **kw)
    teng = TEngine(tcfg, tp, device="cpu", **kw)
    assert teng.cfg.quant_weights == "int8"
    assert tq.is_quantized(teng.params["stack"]["slot0"]["ffn"]["experts"])
    jout = jeng.run(_requests(JRequest, jcfg.vocab_size))
    tout = teng.run(_requests(TRequest, tcfg.vocab_size))
    assert tout == jout
    assert teng.health()["shed_count"] == 0


def test_int8_logits_within_budget():
    """int8-expert logits against the bf16 model's on the e8t2 smoke
    config (the JAX package's budget test, on the port's own draw)."""
    import dataclasses

    cfg = smoke_config(get_config("llama3-e8t2"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=None, dispatcher="sorted"))
    params = init_from_decls(model_decl(cfg), 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        base, _ = forward(cfg, params, {"tokens": tokens})
        quant, _ = forward(cfg, tq.quantize_params(params), {"tokens": tokens})
    err = float((base.float() - quant.float()).abs().max())
    assert 0 < err <= tq.INT8_LOGIT_BUDGET, err


def test_serve_cli_int8_weights_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "3",
                "--dispatcher", "sorted", "--use-kernel", "--quant-weights", "int8", "--device", "cpu"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "served 2 requests (0 shed), 6 tokens" in text and "quant: weights=int8, kv=none" in text
