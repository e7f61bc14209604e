"""Port parity of padded, capacity-factor-bounded dispatch: ``capacity``
and ``dispatch_tables`` bit-equal to the JAX package's, the
``AllGatherDispatcher`` pipeline, the padded expert GEMM's plain version
(#1/#2) against the JAX Pallas kernel (interpret mode) and its oracle,
``ExpertGemm``'s gradients against ``jax.grad`` of the JAX ``expert_gemm``,
three Trainer steps at CF 1.0, the ring engine with ``allgather``, and the
CLIs at their default dispatchers.

Tolerances: tables and capacities exactly; fp32 outputs within 1e-5 (the
same arithmetic, another summation order); bf16 within ``BF16_REL`` of max|ref|; gradients within
``GRAD_TOL`` of max|ref| per tensor; Trainer metrics and params as in
``test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import GNORM_RTOL, METRICS, PARAM_ATOL
from torch_parity import assert_rel, configs, f32, jax_params, to_torch

from repro.config import TrainConfig as JTrainConfig
from repro.core.dispatch.allgather import AllGatherDispatcher as JAllGather
from repro.core.dispatch.base import capacity as j_capacity
from repro.core.dispatch.base import dispatch_tables as j_tables
from repro.data.pipeline import make_train_iter as j_make_train_iter
from repro.kernels import ops as jops
from repro.kernels.ref import expert_gemm_ref as j_eg_ref
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train.callbacks import LoggingCallback as JLogging
from repro.train.state import state_to_tree as j_state_to_tree
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.config import get_config as _get_config
from repro_torch.core import quant as tq
from repro_torch.core.dispatch import AllGatherDispatcher as TAllGather
from repro_torch.core.dispatch import capacity as t_capacity
from repro_torch.core.dispatch import dispatch_tables as t_tables
from repro_torch.core.dispatch import expert_ffn
from repro_torch.core.dispatch.base import DispatchLayout
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.kernels import ops as tops
from repro_torch.params import train_state_from_numpy, tree_leaves
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.train.callbacks import LoggingCallback as TLogging
from repro_torch.train.trainer import Trainer as TTrainer

GRAD_TOL = 1e-5  # of max|ref| per tensor, fp32
CFS = [1.0, 1.25, 2.0, 4.0, None]


def _skewed_routing(rng, T, E=4, k=2):
    """Top-k expert ids with expert 0 far more popular than the rest (so
    small capacities overflow) and random gates."""
    p = np.array([0.55, 0.25, 0.15, 0.05])[:E]
    idx = np.stack([rng.choice(E, k, replace=False, p=p / p.sum()) for _ in range(T)]).astype(np.int32)
    return idx, rng.random((T, k)).astype(np.float32)


@pytest.mark.parametrize("cf", CFS)
def test_capacity_matches_jax(cf):
    for E, k in ((4, 2), (8, 2), (8, 1), (64, 8)):
        jm = dataclasses.replace(configs()[0].moe, num_experts=E, top_k=k, capacity_factor=cf)
        tm = dataclasses.replace(configs()[1].moe, num_experts=E, top_k=k, capacity_factor=cf)
        for T in (1, 3, 4, 7, 9, 16, 300, 2048):
            assert t_capacity(tm, T) == j_capacity(jm, T), (E, k, T, cf)


@pytest.mark.parametrize("cf", CFS)
def test_dispatch_tables_bit_equal_to_jax(rng, cf):
    for T in (1, 5, 24, 64):
        idx, gates = _skewed_routing(rng, T)
        tm = dataclasses.replace(configs()[1].moe, capacity_factor=cf)
        C = t_capacity(tm, T)
        jsel, jg = j_tables(jnp.asarray(idx), jnp.asarray(gates), 4, C)
        tsel, tg = t_tables(torch.from_numpy(idx), torch.from_numpy(gates), 4, C)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        kept = int((tg > 0).sum())
        if cf is None:
            assert kept == T * 2  # dropless: C = T
        if cf == 1.0 and T >= 24:
            assert kept < T * 2  # the skewed routing overflows expert 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_allgather_apply_matches_jax(rng, dtype, use_kernel):
    """dispatch -> expert FFN -> combine at CF 1.0 (tokens drop) in both
    packages on the same routing; the padded buffer and the tables too."""
    jcfg, tcfg = configs(moe_kw=dict(dispatcher="allgather", capacity_factor=1.0))
    jp = jax_params(jcfg)["stack"]["slot0"]["ffn"]["experts"]
    experts = jax.tree.map(lambda a: a[0].astype(dtype), jp)
    T = 24
    x = (rng.standard_normal((T, 64)) * 0.5).astype(np.float32)
    idx, gates = _skewed_routing(rng, T)
    jd, td = JAllGather(jcfg, jcfg.moe, None), TAllGather(tcfg, tcfg.moe)
    jx, jst = jd.dispatch(jnp.asarray(x, dtype), jnp.asarray(idx), jnp.asarray(gates))
    tx, tst = td.dispatch(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(idx),
                          torch.from_numpy(gates))
    assert tx.shape == jx.shape == (1, 4, t_capacity(tcfg.moe, T), 64)
    np.testing.assert_array_equal(f32(tx), f32(jx))
    assert tst.layout.kind == "padded" and tst.layout.capacity == jst.layout.capacity
    np.testing.assert_array_equal(f32(tst.residuals["slot_gate"]), f32(jst.residuals["slot_gate"]))
    jy = jd.apply(experts, jnp.asarray(x, dtype), jnp.asarray(gates), jnp.asarray(idx), use_kernel)
    ty = td.apply(to_torch(experts), torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(gates),
                  torch.from_numpy(idx), use_kernel)
    assert ty.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5)
    else:
        assert_rel(ty, jy)


EG_CASES = [(4, 4, 32, 128), (3, 94, 64, 128), (2, 300, 32, 256)]  # (E, C, D, F)


@pytest.mark.parametrize("case", EG_CASES, ids=[f"C{c[1]}" for c in EG_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_expert_gemm_matches_jax_kernel_and_oracle(rng, case, dtype):
    E, C, D, F = case
    xe = (rng.standard_normal((E, C, D)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    jargs = [jnp.asarray(a, dtype) for a in (xe, *ws)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (xe, *ws)]
    jk = jops.expert_gemm(*jargs)  # Pallas, interpret mode
    jr = j_eg_ref(*jargs)
    ty = tops.expert_gemm(*targs)
    assert ty.shape == (E, C, D) and ty.dtype == targs[0].dtype
    for ref in (jk, jr):
        if dtype == "float32":
            np.testing.assert_allclose(f32(ty), f32(ref), atol=1e-5)
        else:
            assert_rel(ty, ref)


def test_expert_gemm_folds_leading_group_dims(rng):
    """(G, E, C, D) folds G into each expert's slots, as the JAX wrapper."""
    xe = (rng.standard_normal((2, 3, 5, 32)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((3, 32, 128), (3, 32, 128), (3, 128, 32))]
    jy = jops.expert_gemm(*[jnp.asarray(a) for a in (xe, *ws)])
    ty = tops.expert_gemm(*[torch.from_numpy(a) for a in (xe, *ws)])
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5)


@pytest.mark.parametrize("case", EG_CASES[:2], ids=[f"C{c[1]}" for c in EG_CASES[:2]])
def test_expert_gemm_grads_match_jax(rng, case):
    """ExpertGemm's backward (the (E, C, D) buffer copied into 128-row
    regions, the grouped backward passes, sliced back) against jax.grad of
    the JAX expert_gemm (its own backward kernels in interpret mode)."""
    E, C, D, F = case
    arrs = [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((E, C, D), 0.3), ((E, D, F), 0.05), ((E, D, F), 0.05), ((E, F, D), 0.05))]
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jops.expert_gemm(*a) * dy), argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in arrs])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y = tops.expert_gemm(*ts)
    tg = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(f32(a), f32(b), atol=GRAD_TOL * float(np.abs(f32(b)).max()))


def test_padded_int8_kernel_path_raises_and_plain_path_dequantizes(rng):
    """The padded int8 kernel path (#8/#9, their plain version here) is
    forward only: a scale that requires grad raises. Otherwise it computes
    what the plain path computes on the dequantised weights."""
    q = tq.quantize_experts({k: torch.randn(s) * 0.05 for k, s in
                             (("w_gate", (2, 32, 128)), ("w_up", (2, 32, 128)), ("w_down", (2, 128, 32)))})
    xe = torch.randn(1, 2, 3, 32)
    layout = DispatchLayout("padded", 2, capacity=3)
    with pytest.raises(ValueError, match="forward only"):
        expert_ffn({**q, "w_up_scale": q["w_up_scale"].float().requires_grad_(True)}, xe, layout, use_kernel=True)
    deq = tq.dequantize_experts(q, torch.float32)
    torch.testing.assert_close(expert_ffn(q, xe, layout), expert_ffn(deq, xe, layout))
    torch.testing.assert_close(expert_ffn(q, xe, layout, use_kernel=True), expert_ffn(deq, xe, layout),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_trainer_allgather_cf1_matches_jax_trainer(use_kernel):
    """Both Trainers from one state, 3 steps of the same batches at CF 1.0
    (tokens drop) in fp32: per-step metrics and the params after."""
    jcfg, tcfg = configs(moe_kw=dict(dispatcher="allgather", capacity_factor=1.0))
    kw = dict(global_batch=4, seq_len=16, lr=1e-3, lr_min=1e-5, warmup_steps=2, total_steps=6, seed=7,
              log_every=1)
    jt = JTrainer(jcfg, JTrainConfig(**kw), params=jax_params(jcfg),
                  data_iter=j_make_train_iter(jcfg.vocab_size, 16, 4, seed=7), use_kernel=use_kernel)
    tree = jax.tree.map(np.array, j_state_to_tree(jt.state))
    tt = TTrainer(tcfg, TTrainConfig(**kw), state=train_state_from_numpy(tree, "cpu"),
                  data_iter=t_make_train_iter(tcfg.vocab_size, 16, 4, seed=7), use_kernel=use_kernel)
    jt.run(3, callbacks=[JLogging(log=lambda *a: None, log_every=1)])
    tt.run(3, callbacks=[TLogging(log=lambda *a: None, log_every=1)])
    for a, b in zip(tt.history, jt.history):
        for k in METRICS:
            rtol = GNORM_RTOL if k == "grad_norm" and a["step"] > 1 else 1e-5
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-9, err_msg=f"{k} at step {a['step']}")
    for a, b in zip(tree_leaves(tt.params), [v for v in _leaves_in_port_order(jt.params, tt.params)]):
        diff = np.abs(f32(a) - f32(b))
        assert diff.max() <= PARAM_ATOL and (diff > 1e-5).mean() <= 0.01, (a.shape, diff.max())


def _leaves_in_port_order(jtree, ttree):
    """The JAX tree's leaves in the port tree's key order."""
    if isinstance(ttree, dict):
        return [x for k in ttree for x in _leaves_in_port_order(jtree[k], ttree[k])]
    return [jtree]


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_ring_engine_allgather_tokens_identical_to_jax(use_kernel):
    jcfg, tcfg = configs(moe_kw=dict(dispatcher="allgather", capacity_factor=1.0))
    jp = jax_params(jcfg)
    kw = dict(max_batch=2, max_seq=48, use_kernel=use_kernel)
    rng = lambda: np.random.default_rng(3)
    reqs = lambda cls, r: [cls(rid=i, prompt=r.integers(0, 256, L).astype(np.int32), max_new_tokens=n)
                           for i, (L, n) in enumerate([(5, 4), (17, 6), (9, 3)])]
    jout = JEngine(jcfg, jp, **kw).run(reqs(JRequest, rng()))
    tout = TEngine(tcfg, to_torch(jp), device="cpu", **kw).run(reqs(TRequest, rng()))
    assert tout == jout and [len(tout[i]) for i in range(3)] == [4, 6, 3]


def test_serve_cli_without_dispatcher_on_cpu(capsys, monkeypatch):
    """No --dispatcher: the smoke config's allgather at CF 4 serves; the
    full config's alltoall raises under strict dispatch (the suite's
    default) and falls back to allgather with a warning without it."""
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "3", "--use-kernel",
                "--device", "cpu"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "served 2 requests (0 shed), 6 tokens" in capsys.readouterr().out
    small = ["--arch", "llama3-e8t2", "--requests", "1", "--max-new", "1", "--prompt-len", "3", "--device", "cpu"]
    monkeypatch.setattr("repro_torch.config.get_config", _full_width_cut)
    monkeypatch.setattr("repro_torch.launch.serve.get_config", _full_width_cut)
    with pytest.raises(ValueError, match="illegal"):
        main(small)
    monkeypatch.setenv("REPRO_STRICT_DISPATCH", "0")
    with pytest.warns(UserWarning, match="falling back to 'allgather'"):
        out = main(small)
    assert sorted(out) == [0] and out[0]


def _full_width_cut(arch):
    """llama3-e8t2 with its own dispatcher (alltoall) at a size the CPU
    runs: the smoke widths without the smoke config's dispatcher swap."""
    from repro_torch.config import smoke_config

    cfg = _get_config(arch)
    return smoke_config(cfg).replace(num_layers=1, moe=dataclasses.replace(
        smoke_config(cfg).moe, dispatcher=cfg.moe.dispatcher))


def test_train_cli_at_default_cf(capsys):
    """``--upcycle`` at the default ``--cf 4.0`` trains through allgather;
    ``--quant-weights int8`` reports the int8-expert held-out CE."""
    from repro_torch.launch.train import main as train_cli

    tr = train_cli(["--arch", "llama3-8b", "--smoke", "--upcycle", "4", "--steps", "2", "--batch", "2",
                    "--seq", "32", "--use-kernel", "--quant-weights", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.cfg.moe.dispatcher == "allgather" and tr.cfg.moe.capacity_factor == 4.0
    assert "final held-out CE" in out and "int8-expert held-out CE" in out
    assert tr.state.step == 2 and np.isfinite(tr.history[0]["loss"])
    assert not tq.is_quantized(tr.params["stack"]["slot0"]["ffn"]["experts"])


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _bad(shape, fault):
    if fault == "shape":
        return torch.zeros(shape[:-1] + (shape[-1] + 128,), dtype=torch.bfloat16)
    if fault == "dtype":
        return torch.zeros(shape, dtype=torch.float32)
    if fault == "layout":
        return torch.zeros(shape[:-1] + (2 * shape[-1],), dtype=torch.bfloat16)[..., ::2]
    if fault == "align":
        return _misaligned(shape)
    return torch.zeros(shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "h"])
def test_expert_down_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (or input) of the padded down kernel #2's wrapper
    raises ValueError from the argument checks, before a library is loaded
    or a stream looked up."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import expert_gemm as teg

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, C, F, D = 2, 5, 128, 256
    h = torch.zeros((E, C, F), dtype=torch.bfloat16)
    w_down = torch.zeros((E, F, D), dtype=torch.bfloat16)
    if arg == "h":
        if fault == "shape":  # F not a multiple of the column tile
            h, w_down = torch.zeros((E, C, 96), dtype=torch.bfloat16), torch.zeros((E, 96, D), dtype=torch.bfloat16)
        else:
            h = _bad((E, C, F), fault)
        with pytest.raises(ValueError, match="expert_down"):
            teg.expert_down_cuda(h, w_down)
    else:
        with pytest.raises(ValueError, match="expert_down: out" if fault != "align" else "16-byte"):
            teg.expert_down_cuda(h, w_down, out=_bad((E, C, D), fault))


@pytest.mark.parametrize("fault", ["shape", "dtype", "layout", "device", "align"])
@pytest.mark.parametrize("arg", ["out", "xe"])
def test_expert_gate_up_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong ``out=`` (or input) of the padded gate/up kernel #1's
    wrapper raises ValueError from the argument checks, before a library
    is loaded or a stream looked up."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import expert_gemm as teg

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    E, C, D, F = 2, 5, 256, 128
    xe = torch.zeros((E, C, D), dtype=torch.bfloat16)
    w = torch.zeros((E, D, F), dtype=torch.bfloat16)
    if arg == "xe":
        with pytest.raises(ValueError, match="expert_gate_up"):
            teg.expert_gate_up_cuda(_bad((E, C, D), fault), w, w)
    else:
        with pytest.raises(ValueError, match="expert_gate_up: out" if fault != "align" else "16-byte"):
            teg.expert_gate_up_cuda(xe, w, w, out=_bad((E, C, F), fault))
