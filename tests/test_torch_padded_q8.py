"""Port parity of padded (``allgather``) dispatch with int8 expert weights:
the plain version of kernels #8/#9 (``ops.expert_gemm_q8``) against the JAX
Pallas kernels (interpret mode) and their oracle, its forward-only
refusal, the ``AllGatherDispatcher`` on the int8 kernel path (also reached
through the ``alltoall`` fallback), the greedy-parity probe
``sharpen_for_parity`` and exact greedy parity of the padded int8 path on
it, the int8 budgets, the serve CLI, and the argument checks of #8's and
#9's wrappers (each wrong input or ``out=`` raises ValueError before a
library is loaded or a stream looked up; arguments the kernels take reach
the library load).

Every test draws its inputs from its own ``np.random.default_rng(seed)``.

Tolerances: the padded q8 FFN in fp32 within 1e-4 (the same arithmetic,
another summation order), in bf16 within ``KERNEL_PARITY_TOL`` of max|ref|
(the frameworks round at other points); the dispatcher pipeline in fp32
within 1e-4; each of 3 fp32 ``sharpen_for_parity`` steps moves the params
as JAX's does within ``SHARPEN_RTOL`` of the leaf's largest move (an SGD
step is lr x the gradient, whose fp32 error on this model reaches ~2e-4 of
max|g|, see ``test_torch_train``; measured up to 2.3e-4); tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_rel, configs, f32, jax_params, to_torch

from repro.core import quant as jq
from repro.core.dispatch.allgather import AllGatherDispatcher as JAllGather
from repro.kernels import ops as jops
from repro.kernels.ref import expert_gemm_q8_ref as j_q8_ref
from repro_torch.core import quant as tq
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.kernels import _build
from repro_torch.kernels import expert_gemm as teg
from repro_torch.kernels import ops as tops
from repro_torch.params import tree_leaves
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

SHARPEN_RTOL = 1e-3

Q8_CASES = [(4, 64, 64, 128), (3, 5, 128, 256), (2, 70, 64, 128)]  # (E, C, D, F); C 70 straddles a 64-row block


def _q8_operands(seed, E, C, D, F, lead=()):
    rng = np.random.default_rng(seed)
    xe = (rng.standard_normal(lead + (E, C, D)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    return xe, ws


@pytest.mark.parametrize("lead", [(), (2,)], ids=["EC", "GEC"])
@pytest.mark.parametrize("case", Q8_CASES, ids=[f"C{c[1]}" for c in Q8_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_expert_q8_matches_jax_kernel_and_oracle(case, dtype, lead):
    """``ops.expert_gemm_q8`` on the CPU (the plain version of #8/#9)
    against the JAX ``ops.expert_gemm_q8`` (Pallas, interpret mode) and
    ``ref.expert_gemm_q8_ref`` on the same int8 weights and scales; a
    leading group dim folds into each expert's slots in both."""
    E, C, D, F = case
    xe, ws = _q8_operands(C, E, C, D, F, lead)
    jq8 = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    tq8 = [tq.quantize_weight(torch.from_numpy(w)) for w in ws]
    jw = [q for q, _ in jq8] + [s for _, s in jq8]
    tw = [q for q, _ in tq8] + [s for _, s in tq8]
    jx, tx = jnp.asarray(xe, dtype), torch.from_numpy(xe).to(getattr(torch, dtype))
    jk = jops.expert_gemm_q8(jx, *jw)
    # the oracle takes (E, C, D): fold the group dim by hand, as the wrappers do
    x3 = jnp.moveaxis(jx, 0, 1).reshape(E, -1, D) if lead else jx
    jr = j_q8_ref(x3, *jw)
    jr = jnp.moveaxis(jr.reshape(E, lead[0], C, D), 1, 0) if lead else jr
    ty = tops.expert_gemm_q8(tx, *tw)
    assert ty.shape == lead + (E, C, D) and ty.dtype == tx.dtype
    for ref in (jk, jr):
        if dtype == "float32":
            np.testing.assert_allclose(f32(ty), f32(ref), atol=1e-4)
        else:
            assert_rel(ty, ref, tq.KERNEL_PARITY_TOL)


def test_plain_expert_q8_is_dequantised_expert_gemm():
    """In fp32 the int8 FFN is the bf16-free FFN on the dequantised weights
    (the scale commutes with the contraction)."""
    xe, ws = _q8_operands(1, 2, 7, 64, 128)
    q = tq.quantize_experts(dict(zip(("w_gate", "w_up", "w_down"), map(torch.from_numpy, ws))))
    deq = tq.dequantize_experts(q, torch.float32)
    x = torch.from_numpy(xe)
    y = tops.expert_gemm_q8(x, q["w_gate"], q["w_up"], q["w_down"], q["w_gate_scale"], q["w_up_scale"],
                            q["w_down_scale"])
    torch.testing.assert_close(y, tops.expert_gemm(x, deq["w_gate"], deq["w_up"], deq["w_down"]),
                               atol=1e-5, rtol=1e-5)


def test_expert_q8_is_forward_only():
    xe, ws = _q8_operands(2, 2, 3, 64, 128)
    q = [tq.quantize_weight(torch.from_numpy(w)) for w in ws]
    args = [torch.from_numpy(xe)] + [w for w, _ in q] + [s for _, s in q]
    args[5] = args[5].float().requires_grad_(True)  # s_up
    with pytest.raises(ValueError, match="forward only"):
        tops.expert_gemm_q8(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.expert_gemm_q8(*[a.detach().to("meta") for a in args])


def _routing(seed, T, E=4, k=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, 64)) * 0.5).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False, p=[0.55, 0.25, 0.15, 0.05]) for _ in range(T)]).astype(np.int32)
    return x, idx, rng.random((T, k)).astype(np.float32)


@pytest.mark.parametrize("dispatcher", ["allgather", "alltoall"])
def test_allgather_int8_kernel_path_matches_jax(dispatcher, monkeypatch):
    """dispatch -> int8 expert FFN on the kernel path -> combine at CF 4,
    fp32, against the JAX ``AllGatherDispatcher`` (named explicitly); the
    port's ``alltoall`` resolves to it with a warning when strict dispatch
    is off."""
    monkeypatch.setenv("REPRO_STRICT_DISPATCH", "0")
    jcfg, tcfg = configs(moe_kw=dict(dispatcher=dispatcher, capacity_factor=4.0))
    jexp = jax.tree.map(lambda a: a[0], jax_params(jcfg)["stack"]["slot0"]["ffn"]["experts"])
    jq8 = jq.quantize_experts(jexp)
    tq8 = tq.quantize_experts(to_torch(jexp))
    x, idx, gates = _routing(5, 24)
    if dispatcher == "alltoall":
        with pytest.warns(UserWarning, match="falling back to 'allgather'"):
            td = get_dispatcher(tcfg, tcfg.moe)
    else:
        td = get_dispatcher(tcfg, tcfg.moe)
    assert td.name == "allgather"
    jd = JAllGather(jcfg, dataclasses.replace(jcfg.moe, dispatcher="allgather"), None)
    tops.reset_launch_counts()
    ty = td.apply(tq8, torch.from_numpy(x), torch.from_numpy(gates), torch.from_numpy(idx), use_kernel=True)
    jy = jd.apply(jq8, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx), True)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-4)
    assert sum(tops.launch_counts().values()) == 0  # the CPU runs the plain version


@pytest.fixture(scope="module")
def sharpened():
    """bf16 tiny MoE, padded allgather at CF 4, sharpened by the port."""
    _, tcfg = configs(fp32=False, moe_kw=dict(dispatcher="allgather", capacity_factor=4.0))
    jcfg, _ = configs(fp32=False)
    params, pattern = tq.sharpen_for_parity(tcfg, to_torch(jax_params(jcfg, fp32=False)))
    return tcfg, params, pattern


def test_sharpen_for_parity_matches_jax():
    """Three probe steps in fp32, each from JAX's params before it: the same
    pattern, and each step's move of every leaf within ``SHARPEN_RTOL`` of
    JAX's move.
    (Run on their own, the two fp32 trajectories part: at lr 0.5 this tiny
    model's attention turns the gradients' fp32 rounding, see
    ``test_torch_train``, into param differences that grow ~100x a step.)"""
    jcfg, tcfg = configs(moe_kw=dict(dispatcher="allgather", capacity_factor=4.0))
    jp = jax_params(jcfg)
    prev = jp
    for n in (1, 2, 3):
        jout, jpat = jq.sharpen_for_parity(jcfg, jp, steps=n)
        tout, tpat = tq.sharpen_for_parity(tcfg, to_torch(prev), steps=1)
        np.testing.assert_array_equal(tpat, jpat)
        assert tpat.dtype == np.int32 and tpat.shape == (32,)
        for a, b, c in zip(tree_leaves(tout), _leaves_in_port_order(jout, tout), _leaves_in_port_order(prev, tout)):
            assert a.dtype == torch.float32 and not a.requires_grad
            jmove = f32(b) - f32(c)
            np.testing.assert_allclose(f32(a) - f32(c), jmove, atol=SHARPEN_RTOL * np.abs(jmove).max(),
                                       err_msg=f"step {n}")
        prev = jout


def _leaves_in_port_order(jtree, ttree):
    if isinstance(ttree, dict):
        return [x for k in ttree for x in _leaves_in_port_order(jtree[k], ttree[k])]
    return [jtree]


def _probe_requests(cls, pattern, n=4, prompt_len=24, new=8):
    return [cls(rid=i, prompt=np.roll(pattern, -i)[:prompt_len].astype(np.int32), max_new_tokens=new)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["ring", "paged"])
def test_greedy_parity_sharpened_padded_int8(sharpened, mode):
    """Exact greedy parity on the probe: the padded int8 kernel path
    against the bf16 model (as the JAX ``test_greedy_parity_sharpened``);
    the probe's top-1 margins dwarf the int8 logit error, so a flip is a
    quantisation bug, not noise."""
    cfg, params, pattern = sharpened
    kw = dict(max_batch=4, max_seq=64, use_kernel=True, device="cpu")
    if mode == "paged":
        kw.update(cache_mode="paged", page_size=8, prefill_chunk=16)
    base = TEngine(cfg, params, **kw).run(_probe_requests(TRequest, pattern))
    quant = TEngine(cfg, params, quant_weights="int8", **kw).run(_probe_requests(TRequest, pattern))
    assert quant == base
    # the probe learned the pattern: decode continues it
    assert base[0] == list(np.roll(pattern, -24)[:8])


def test_int8_budgets_equal_jax():
    assert tq.INT8_KV_LOGIT_BUDGET == jq.INT8_KV_LOGIT_BUDGET
    assert tq.INT8_LOGIT_BUDGET == jq.INT8_LOGIT_BUDGET and tq.KERNEL_PARITY_TOL == jq.KERNEL_PARITY_TOL


def test_serve_cli_padded_int8_kernel_path_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "3",
                "--dispatcher", "allgather", "--quant-weights", "int8", "--use-kernel", "--device", "cpu"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "served 2 requests (0 shed), 6 tokens" in text and "quant: weights=int8, kv=none" in text


# ---------------------------------------------------------------------------
# argument checks of the CUDA wrappers of #8 and #9 (no card needed)
# ---------------------------------------------------------------------------

AE, AC, AD, AF = 2, 5, 256, 128  # E, C, D, F of the argument-check cases


def _misaligned(shape, dtype, by: int = 1):
    """A contiguous tensor whose data starts ``by`` elements past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(shape)


def _gate_up_q8_args(**faults):
    """#8's wrapper arguments at a small shape (E 2, C 5, D 256, F 128),
    each replaced by ``faults[name]`` where given."""
    args = dict(xe=torch.zeros((AE, AC, AD), dtype=torch.bfloat16),
                w_gate=torch.zeros((AE, AD, AF), dtype=torch.int8), w_up=torch.zeros((AE, AD, AF), dtype=torch.int8),
                s_gate=torch.zeros((AE, AF), dtype=torch.bfloat16), s_up=torch.zeros((AE, AF), dtype=torch.bfloat16),
                out=None)
    args.update(faults)
    return args


def _down_q8_args(**faults):
    """#9's wrapper arguments at the same shape (h (2, 5, 128), Wd (2, 128,
    256)), each replaced by ``faults[name]`` where given."""
    args = dict(h=torch.zeros((AE, AC, AF), dtype=torch.bfloat16), w_down=torch.zeros((AE, AF, AD), dtype=torch.int8),
                s_down=torch.zeros((AE, AD), dtype=torch.bfloat16), out=None)
    args.update(faults)
    return args


_GATE_UP_Q8_FAULTS = {
    ("xe", "shape"): torch.zeros((AE, AC, 2 * AD), dtype=torch.bfloat16),
    ("xe", "experts"): torch.zeros((AE + 1, AC, AD), dtype=torch.bfloat16),
    ("xe", "rows"): torch.zeros((AE, 0, AD), dtype=torch.bfloat16),
    ("xe", "rank"): torch.zeros((AC, AD), dtype=torch.bfloat16),
    ("xe", "width"): dict(xe=torch.zeros((AE, AC, 192), dtype=torch.bfloat16),
                          w_gate=torch.zeros((AE, 192, AF), dtype=torch.int8),
                          w_up=torch.zeros((AE, 192, AF), dtype=torch.int8)),
    ("xe", "dtype"): torch.zeros((AE, AC, AD)),
    ("xe", "layout"): torch.zeros((AE, AC, 2 * AD), dtype=torch.bfloat16)[..., ::2],
    ("xe", "device"): torch.zeros((AE, AC, AD), dtype=torch.bfloat16, device="meta"),
    ("xe", "align"): _misaligned((AE, AC, AD), torch.bfloat16),
    ("w_gate", "shape"): torch.zeros((AE, 2 * AD, AF), dtype=torch.int8),
    ("w_gate", "rank"): torch.zeros((AD, AF), dtype=torch.int8),
    ("w_gate", "width"): dict(w_gate=torch.zeros((AE, AD, 64), dtype=torch.int8),
                              w_up=torch.zeros((AE, AD, 64), dtype=torch.int8),
                              s_gate=torch.zeros((AE, 64), dtype=torch.bfloat16),
                              s_up=torch.zeros((AE, 64), dtype=torch.bfloat16)),
    ("w_gate", "dtype"): torch.zeros((AE, AD, AF), dtype=torch.bfloat16),
    ("w_gate", "layout"): torch.zeros((AE, AD, 2 * AF), dtype=torch.int8)[..., ::2],
    ("w_gate", "device"): torch.zeros((AE, AD, AF), dtype=torch.int8, device="meta"),
    ("w_gate", "align"): _misaligned((AE, AD, AF), torch.int8),
    ("w_up", "shape"): torch.zeros((AE + 1, AD, AF), dtype=torch.int8),
    ("w_up", "dtype"): torch.zeros((AE, AD, AF), dtype=torch.uint8),
    ("w_up", "layout"): torch.zeros((AE, AF, AD), dtype=torch.int8).transpose(1, 2),
    ("w_up", "device"): torch.zeros((AE, AD, AF), dtype=torch.int8, device="meta"),
    ("w_up", "align"): _misaligned((AE, AD, AF), torch.int8),
    ("s_gate", "shape"): torch.zeros((AE, AD), dtype=torch.bfloat16),
    ("s_gate", "dtype"): torch.zeros((AE, AF)),
    ("s_gate", "layout"): torch.zeros((AE, 2 * AF), dtype=torch.bfloat16)[:, ::2],
    ("s_gate", "device"): torch.zeros((AE, AF), dtype=torch.bfloat16, device="meta"),
    ("s_gate", "align"): _misaligned((AE, AF), torch.bfloat16),
    ("s_up", "shape"): torch.zeros((AE, AF, 1), dtype=torch.bfloat16),
    ("s_up", "dtype"): torch.zeros((AE, AF), dtype=torch.float16),
    ("s_up", "device"): torch.zeros((AE, AF), dtype=torch.bfloat16, device="meta"),
    ("s_up", "align"): _misaligned((AE, AF), torch.bfloat16),
    ("out", "shape"): torch.zeros((AE, AC, AD), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((AE, AC, AF)),
    ("out", "layout"): torch.zeros((AE, AC, 2 * AF), dtype=torch.bfloat16)[..., ::2],
    ("out", "device"): torch.zeros((AE, AC, AF), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((AE, AC, AF), torch.bfloat16),
}

_DOWN_Q8_FAULTS = {
    ("h", "shape"): torch.zeros((AE, AC, 2 * AF), dtype=torch.bfloat16),
    ("h", "experts"): torch.zeros((AE + 1, AC, AF), dtype=torch.bfloat16),
    ("h", "rows"): torch.zeros((AE, 0, AF), dtype=torch.bfloat16),
    ("h", "rank"): torch.zeros((AC, AF), dtype=torch.bfloat16),
    ("h", "dtype"): torch.zeros((AE, AC, AF)),
    ("h", "layout"): torch.zeros((AE, AC, 2 * AF), dtype=torch.bfloat16)[..., ::2],
    ("h", "device"): torch.zeros((AE, AC, AF), dtype=torch.bfloat16, device="meta"),
    ("h", "align"): _misaligned((AE, AC, AF), torch.bfloat16),
    ("w_down", "shape"): torch.zeros((AE, 2 * AF, AD), dtype=torch.int8),
    ("w_down", "width"): dict(w_down=torch.zeros((AE, AF, 192), dtype=torch.int8),
                              s_down=torch.zeros((AE, 192), dtype=torch.bfloat16)),
    ("w_down", "rank"): torch.zeros((AF, AD), dtype=torch.int8),
    ("w_down", "dtype"): torch.zeros((AE, AF, AD), dtype=torch.bfloat16),
    ("w_down", "layout"): torch.zeros((AE, AF, 2 * AD), dtype=torch.int8)[..., ::2],
    ("w_down", "device"): torch.zeros((AE, AF, AD), dtype=torch.int8, device="meta"),
    ("w_down", "align"): _misaligned((AE, AF, AD), torch.int8),
    ("s_down", "shape"): torch.zeros((AE, AF), dtype=torch.bfloat16),
    ("s_down", "dtype"): torch.zeros((AE, AD)),
    ("s_down", "layout"): torch.zeros((AE, 2 * AD), dtype=torch.bfloat16)[:, ::2],
    ("s_down", "device"): torch.zeros((AE, AD), dtype=torch.bfloat16, device="meta"),
    ("s_down", "align"): _misaligned((AE, AD), torch.bfloat16),
    ("out", "shape"): torch.zeros((AE, AC, AF), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((AE, AC, AD)),
    ("out", "layout"): torch.zeros((AE, AC, 2 * AD), dtype=torch.bfloat16)[..., ::2],
    ("out", "device"): torch.zeros((AE, AC, AD), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((AE, AC, AD), torch.bfloat16),
}

_PADDED_Q8_FAULTS = {**{("expert_gate_up_q8",) + k: v for k, v in _GATE_UP_Q8_FAULTS.items()},
                     **{("expert_down_q8",) + k: v for k, v in _DOWN_Q8_FAULTS.items()}}


def _forbid_library(monkeypatch, stream: bool = True):
    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    if stream:
        monkeypatch.setattr(torch.cuda, "current_stream", forbidden)


def _call_padded_q8(kernel, a):
    if kernel == "expert_gate_up_q8":
        return teg.expert_gate_up_q8_cuda(a["xe"], a["w_gate"], a["w_up"], a["s_gate"], a["s_up"], out=a["out"])
    return teg.expert_down_q8_cuda(a["h"], a["w_down"], a["s_down"], out=a["out"])


@pytest.mark.parametrize("kernel,arg,fault", sorted(_PADDED_Q8_FAULTS))
def test_padded_q8_args_checked_before_any_library(monkeypatch, kernel, arg, fault):
    """A wrong input or ``out=`` of #8's or #9's wrapper (dtype, shape,
    layout, device, or a base the kernel cannot read: off the 16-byte
    boundary that TMA needs, or a scale off the 4-byte boundary of its bf16
    pairs) raises ValueError from the argument checks, before a library is
    loaded or a stream looked up."""
    _forbid_library(monkeypatch)
    make = _gate_up_q8_args if kernel == "expert_gate_up_q8" else _down_q8_args
    fault_value = _PADDED_Q8_FAULTS[(kernel, arg, fault)]
    with pytest.raises(ValueError, match=kernel):
        _call_padded_q8(kernel, make(**(fault_value if isinstance(fault_value, dict) else {arg: fault_value})))


@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("kernel", ["expert_gate_up_q8", "expert_down_q8"])
def test_padded_q8_good_args_reach_the_library(monkeypatch, kernel, out):
    """Arguments the kernels take (with or without ``out=``) pass every
    check of #8's and #9's wrappers and reach the library load."""
    _forbid_library(monkeypatch, stream=False)
    if kernel == "expert_gate_up_q8":
        a = _gate_up_q8_args(out=torch.zeros((AE, AC, AF), dtype=torch.bfloat16) if out else None)
    else:
        a = _down_q8_args(out=torch.zeros((AE, AC, AD), dtype=torch.bfloat16) if out else None)
    with pytest.raises(AssertionError, match="reached past"):
        _call_padded_q8(kernel, a)
