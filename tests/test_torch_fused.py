"""Port parity of fused dispatch (the sorted dispatcher's gather in the
gate/up prologue and gate-weighted combine in the down epilogue, kernels
#12-#15): the plain fused forward (bf16 and int8 weights) against the JAX
fused Pallas kernels in interpret mode, the ``FusedMoe`` gradients (the
gates' included) against ``jax.grad`` through the JAX fused function, the
inputs-only residuals, the sorted dispatcher's fused path and its inert
flag without kernels, the ring and paged engines' greedy tokens, three
Trainer steps against the JAX fused Trainer, and the serve and train CLIs.

Tolerances: fp32 within 1e-5 (the same arithmetic and rounding points,
another summation order; int8 weights 1e-4 as the JAX test holds its
fused q8 path); bf16 within one bf16 ulp of max|y| (both round h and each
slot partial to bf16 at the same points); gradients within 2e-4 in fp32,
each nonzero. The Trainer as ``test_trainer_matches_jax_trainer`` holds
it; the engines emit identical tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import GNORM_RTOL, METRICS, PARAM_ATOL
from torch_parity import FP32_ATOL, configs, f32, jax_params, to_torch

from repro.config import TrainConfig as JTrainConfig
from repro.core import quant as jq
from repro.core.dispatch.sorted import SortedDispatcher as JSorted
from repro.data.pipeline import make_train_iter as j_make_train_iter
from repro.kernels import expert_gemm as jeg
from repro.kernels import ops as jops
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train.callbacks import LoggingCallback as JLogging
from repro.train.state import state_to_tree as j_state_to_tree
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.core import quant as tq
from repro_torch.core.dispatch import SortedDispatcher as TSorted
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.kernels import expert_gemm as teg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import main as serve_cli
from repro_torch.launch.train import main as train_cli
from repro_torch.models.model import loss_fn as t_loss_fn
from repro_torch.params import train_state_from_numpy, tree_leaves
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.train.callbacks import LoggingCallback as TLogging
from repro_torch.train.trainer import Trainer as TTrainer

# (E, k, T, D, F): tests/test_autotune.py:FUSED_CASES
FUSED_CASES = [
    (2, 1, 16, 128, 128),
    (4, 2, 16, 128, 256),
    (4, 2, 24, 256, 128),
    (8, 2, 16, 256, 256),
]
GRAD_ATOL = 2e-4


def _routing(rng, E, k, T, bc):
    """The sorted dispatcher's index vectors for random top-k routing with
    distinct experts per token, as numpy arrays: (token, slot, dest,
    gate_sorted, group_sizes)."""
    N = T * k
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(N)
    gates = rng.uniform(0.2, 1.0, size=N).astype(np.float32)
    order = np.argsort(idx, kind="stable")
    gs = np.bincount(idx, minlength=E).astype(np.int32)
    padded = (gs + bc - 1) // bc * bc
    starts_pad, starts = np.cumsum(padded) - padded, np.cumsum(gs) - gs
    sorted_e = idx[order]
    dest = starts_pad[sorted_e] + np.arange(N) - starts[sorted_e]
    return [a.astype(np.int32) for a in (order // k, order % k, dest)] + [gates[order], gs]


def _case(E, k, T, D, F, bc, seed=0):
    rng = np.random.default_rng(seed + 1000 * E + 100 * k + T + D + F)
    x = rng.standard_normal((T, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, ws, _routing(rng, E, k, T, bc)


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a) for a in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a).long()
            for a in arrays]


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("row_block", [8, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_matches_jax_fused(case, row_block, dtype):
    x, ws, (token, slot, dest, gate, gs) = _case(*case, row_block)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy = jops.grouped_gemm_fused(*_jax([x] + ws, jd), *_jax([gs, token, dest, slot, gate]),
                                 row_block=row_block)  # Pallas, interpret mode
    ty = tops.grouped_gemm_fused(*_torch([x] + ws, td), torch.from_numpy(gs), *_torch([token, dest, slot]),
                                 torch.from_numpy(gate), row_block=row_block)
    assert ty.dtype == td and ty.shape == x.shape
    err = float(np.abs(f32(ty) - f32(jy)).max())
    if dtype == "float32":
        assert err <= 1e-5, err
    else:
        assert err <= _bf16_ulp(float(np.abs(f32(jy)).max())), err


def test_fused_tables_match_jax_prefetch():
    rng = np.random.default_rng(5)
    E, k, T, bc = 4, 2, 16, 8
    token, slot, dest, gate, _ = _routing(rng, E, k, T, bc)
    N_pad = tref.aligned_rows(T * k, E, bc)
    jt = jeg._fused_prefetch(*_jax([token, dest, slot, gate]), T, N_pad)
    tt = teg.fused_prefetch(*_torch([token, dest, slot]), torch.from_numpy(gate), T, N_pad)
    valid = np.zeros(N_pad, bool)
    valid[dest] = True
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy()[valid], np.asarray(b)[valid])
    assert tt[2].dtype == torch.float32
    np.testing.assert_array_equal(tt[0].numpy()[~valid], 0)  # padding rows gather token 0
    np.testing.assert_array_equal(tt[1].numpy()[~valid], -1)  # and are never stored


def _q8_pair(ws):
    jw = [jq.quantize_weight(jnp.asarray(w)) for w in ws]
    tw = [tq.quantize_weight(torch.from_numpy(w)) for w in ws]
    return [q for q, _ in jw] + [s for _, s in jw], [q for q, _ in tw] + [s for _, s in tw]


@pytest.mark.parametrize("case", FUSED_CASES[1:])
@pytest.mark.parametrize("row_block", [8, 128])
def test_plain_fused_q8_matches_jax_fused_q8(case, row_block):
    x, ws, (token, slot, dest, gate, gs) = _case(*case, row_block, seed=1)
    jw, tw = _q8_pair(ws)
    jy = jops.grouped_gemm_fused_q8(jnp.asarray(x), *jw, *_jax([gs, token, dest, slot, gate]),
                                    row_block=row_block)
    ty = tops.grouped_gemm_fused_q8(torch.from_numpy(x), *tw, torch.from_numpy(gs), *_torch([token, dest, slot]),
                                    torch.from_numpy(gate), row_block=row_block)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-4)


def test_fused_q8_is_forward_only():
    x, ws, (token, slot, dest, gate, gs) = _case(4, 2, 16, 128, 256, 8)
    _, tw = _q8_pair(ws)
    tw[3] = tw[3].float().requires_grad_(True)  # s_gate
    with pytest.raises(ValueError, match="forward only"):
        tops.grouped_gemm_fused_q8(torch.from_numpy(x), *tw, torch.from_numpy(gs), *_torch([token, dest, slot]),
                                   torch.from_numpy(gate), row_block=8)


@pytest.mark.parametrize("case", FUSED_CASES[:2])
@pytest.mark.parametrize("row_block", [8, 128])
def test_fused_moe_grads_match_jax(case, row_block):
    """``FusedMoe``'s backward (the unfused composition's VJP through the
    grouped forward and backward) against ``jax.grad`` through the JAX
    fused custom_vjp: x, the three weights and the gates."""
    x, ws, (token, slot, dest, gate, gs) = _case(*case, row_block, seed=2)
    jidx = _jax([gs, token, dest, slot])

    def jloss(x, wg, wu, wd, g):
        y = jeg.grouped_gemm_fused(x, wg, wu, wd, *jidx, g, blocks=(row_block, 512, 512), interpret=True)
        return jnp.sum(jnp.square(y))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_jax([x] + ws + [gate]))
    leaves = [t.requires_grad_(True) for t in _torch([x] + ws + [gate])]
    tidx = [torch.from_numpy(gs)] + _torch([token, dest, slot])
    y = tops.grouped_gemm_fused(*leaves[:4], *tidx, leaves[4], row_block=row_block)
    tg = torch.autograd.grad(y.square().sum(), leaves)
    for name, a, b in zip(("x", "w_gate", "w_up", "w_down", "gates"), tg, jg):
        np.testing.assert_allclose(f32(a), f32(b), atol=GRAD_ATOL, err_msg=name)
        assert float(a.abs().sum()) > 0, name


def test_fused_residuals_are_inputs_only():
    E, k, T, D, F = 4, 2, 16, 128, 256
    x, ws, (token, slot, dest, gate, gs) = _case(E, k, T, D, F, 128)
    args = _torch([x] + ws) + [torch.from_numpy(gs)] + _torch([token, dest, slot]) + [torch.from_numpy(gate)]
    saved = teg.grouped_gemm_fused_residuals(*args, row_block=128)
    shapes = sorted(s for s, _ in saved)
    assert shapes == sorted(tuple(a.shape) for a in args)
    jres = jeg.fused_moe_residuals(*_jax([x] + ws + [gs, token, dest, slot, gate]), blocks=(128, 512, 512))
    assert shapes == sorted(tuple(r.shape) for r in jres)
    N_pad = tref.aligned_rows(T * k, E, 128)
    assert not any(s[0] == N_pad for s in shapes) and not any(F in s and T * k in s for s in shapes)


def _dispatch_inputs(rng, T=24, E=4, k=2, D=64, F=128):
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    gates = rng.random((T, k)).astype(np.float32)
    ws = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for n, s in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D)))}
    return x, idx, gates, ws


def test_sorted_dispatcher_fused_matches_jax():
    rng = np.random.default_rng(6)
    jcfg, tcfg = configs(moe_kw=dict(fused_dispatch=True))
    x, idx, gates, ws = _dispatch_inputs(rng)
    jy = JSorted(jcfg, jcfg.moe, None).apply({n: jnp.asarray(w) for n, w in ws.items()}, jnp.asarray(x),
                                              jnp.asarray(gates), jnp.asarray(idx), use_kernel=True)
    td = TSorted(tcfg, tcfg.moe)
    texp = {n: torch.from_numpy(w) for n, w in ws.items()}
    ty = td.apply(texp, torch.from_numpy(x), torch.from_numpy(gates), torch.from_numpy(idx), use_kernel=True)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5)
    # the fused path ran: its plain version on the dispatcher's own tables
    token, slot, dest, gate_sorted, gs = td._indices(torch.from_numpy(idx), torch.from_numpy(gates), 128)
    direct = tref.grouped_gemm_fused_ref(torch.from_numpy(x), *texp.values(), gs, token, dest, slot, gate_sorted)
    assert torch.equal(ty, direct)


def test_fused_flag_is_inert_without_kernels():
    """JAX runs the unfused XLA path when ``fused_dispatch`` is set without
    ``use_kernel`` (tests/test_dispatch.py); so does the port."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = configs(moe_kw=dict(fused_dispatch=True))
    _, tcfg_off = configs()
    x, idx, gates, ws = _dispatch_inputs(rng)
    targs = ({n: torch.from_numpy(w) for n, w in ws.items()}, torch.from_numpy(x), torch.from_numpy(gates),
             torch.from_numpy(idx))
    on = TSorted(tcfg, tcfg.moe).apply(*targs, use_kernel=False)
    off = TSorted(tcfg_off, tcfg_off.moe).apply(*targs, use_kernel=False)
    assert torch.equal(on, off)
    jy = JSorted(jcfg, jcfg.moe, None).apply({n: jnp.asarray(w) for n, w in ws.items()}, jnp.asarray(x),
                                              jnp.asarray(gates), jnp.asarray(idx), use_kernel=False)
    np.testing.assert_allclose(f32(on), f32(jy), atol=FP32_ATOL)


def _requests(cls, vocab, seed=11, n=5, lmax=30):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, lmax))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 7)))
            for i in range(n)]


MODES = {"ring": dict(), "paged": dict(cache_mode="paged", page_size=8, prefill_chunk=16)}
WEIGHTS = {"fp32": dict(fp32=True), "bf16": dict(fp32=False), "int8": dict(fp32=True, quant_weights="int8")}


@pytest.fixture(scope="module", params=list(WEIGHTS))
def engines_model(request):
    w = dict(WEIGHTS[request.param])
    fp32 = w.pop("fp32")
    jcfg, tcfg = configs(fp32=fp32)
    jp = jax_params(jcfg, fp32=fp32)
    return jcfg, tcfg, jp, to_torch(jp), w


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_engine_tokens_identical_to_jax(engines_model, mode):
    jcfg, tcfg, jp, tp, w = engines_model
    kw = dict(max_batch=2, max_seq=48, dispatcher="sorted", use_kernel=True, fused_dispatch=True, **w,
              **MODES[mode])
    jeng = JEngine(jcfg, jp, **kw)
    teng = TEngine(tcfg, tp, device="cpu", **kw)
    assert teng.cfg.moe.fused_dispatch and teng.cfg.moe.dispatcher == "sorted"
    jout = jeng.run(_requests(JRequest, jcfg.vocab_size))
    tout = teng.run(_requests(TRequest, tcfg.vocab_size))
    assert tout == jout, {r: (tout[r], jout[r]) for r in jout if tout[r] != jout[r]}


def test_fused_engine_needs_kernels():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="use_kernel"):
        TEngine(tcfg, {}, device="cpu", fused_dispatch=True)
    with pytest.raises(ValueError, match="sorted"):
        TEngine(tcfg, {}, device="cpu", fused_dispatch=True, use_kernel=True, dispatcher="allgather")


def test_fused_trainer_matches_jax_trainer():
    """Both Trainers from one state, fused dispatch with kernels, 3 steps
    of the same batches in fp32: per-step metrics and the params after, at
    the tolerances of test_trainer_matches_jax_trainer."""
    jcfg, tcfg = configs(moe_kw=dict(fused_dispatch=True))
    kw = dict(global_batch=4, seq_len=16, lr=1e-3, lr_min=1e-5, warmup_steps=2, total_steps=6, seed=7,
              log_every=1)
    jt = JTrainer(jcfg, JTrainConfig(**kw), params=jax_params(jcfg),
                  data_iter=j_make_train_iter(jcfg.vocab_size, 16, 4, seed=7), use_kernel=True)
    tree = jax.tree.map(np.array, j_state_to_tree(jt.state))
    tt = TTrainer(tcfg, TTrainConfig(**kw), state=train_state_from_numpy(tree, "cpu"),
                  data_iter=t_make_train_iter(tcfg.vocab_size, 16, 4, seed=7), use_kernel=True)
    assert tt.cfg.moe.fused_dispatch
    jt.run(3, callbacks=[JLogging(log=lambda *a: None, log_every=1)])
    tt.run(3, callbacks=[TLogging(log=lambda *a: None, log_every=1)])
    for a, b in zip(tt.history, jt.history):
        for k in METRICS:
            rtol = GNORM_RTOL if k == "grad_norm" and a["step"] > 1 else 1e-5
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-9, err_msg=f"{k} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0.0
    for a, b in zip(tree_leaves(tt.params), jax.tree.leaves(jt.params)):
        diff = np.abs(f32(a) - f32(b))
        assert diff.max() <= PARAM_ATOL and (diff > 1e-5).mean() <= 0.01, (a.shape, diff.max())


def test_fused_remat_on_equals_remat_off_and_router_learns():
    """``torch.utils.checkpoint`` reruns ``FusedMoe.forward``: the loss and
    every gradient equal those without remat, and the router's weights get
    a nonzero gradient through the gates."""
    rng = np.random.default_rng(8)
    jcfg, tcfg = configs(moe_kw=dict(fused_dispatch=True))
    jp = jax_params(jcfg)
    toks = rng.integers(0, tcfg.vocab_size, (2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    out = {}
    for remat in ("none", "full"):
        tp = to_torch(jp)
        leaves = tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = t_loss_fn(tcfg.replace(remat=remat), tp, batch, None, True)
        out[remat] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
    assert out["none"][0] == out["full"][0]
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)
    router = tp["stack"]["slot0"]["ffn"]["router"]["w_g"]
    g = out["full"][1][[i for i, t in enumerate(leaves) if t is router][0]]
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("extra", [[], ["--cache-mode", "paged"], ["--quant-weights", "int8"]],
                         ids=["ring", "paged", "int8"])
def test_serve_cli_fused_on_cpu(capsys, extra):
    out = serve_cli(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "3", "--use-kernel",
                     "--fused-dispatch", "--device", "cpu", *extra])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "served 2 requests (0 shed), 6 tokens" in text and "fused dispatch" in text


@pytest.mark.parametrize("bad", [["--fused-dispatch"], ["--fused-dispatch", "--use-kernel", "--dispatcher",
                                                        "allgather"]], ids=["no-kernel", "allgather"])
def test_serve_cli_fused_errors(capsys, bad):
    with pytest.raises(SystemExit):
        serve_cli(["--arch", "llama3-e8t2", "--smoke", "--device", "cpu", *bad])
    assert "--fused-dispatch requires" in capsys.readouterr().err


def test_train_cli_fused_on_cpu(capsys):
    tr = train_cli(["--arch", "llama3-8b", "--smoke", "--upcycle", "4", "--top-k", "2", "--cf", "-1",
                    "--use-kernel", "--fused-dispatch", "--steps", "2", "--batch", "2", "--seq", "32",
                    "--device", "cpu"])
    assert tr.cfg.moe.fused_dispatch and tr.cfg.moe.dispatcher == "sorted"
    assert tr.state.step == 2 and np.isfinite(tr.history[-1]["loss"])
    assert "final held-out CE" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [["--fused-dispatch"], ["--fused-dispatch", "--use-kernel", "--dispatcher",
                                                        "allgather"]], ids=["no-kernel", "allgather"])
def test_train_cli_fused_errors(bad):
    with pytest.raises(SystemExit, match="--fused-dispatch requires"):
        train_cli(["--arch", "llama3-8b", "--smoke", "--upcycle", "4", "--steps", "1", "--batch", "2",
                   "--seq", "16", "--device", "cpu", *bad])


def _fused_q8_down_args(**faults):
    """The fused int8 down kernel #15's wrapper arguments at a small shape
    (E 2, N_pad 256, F 128, D 256, k 2, T 64), each replaced by
    ``faults[name]`` where given."""
    E, N_pad, F, D = 2, 256, 128, 256
    args = dict(h=torch.zeros((N_pad, F), dtype=torch.bfloat16), w_down=torch.zeros((E, F, D), dtype=torch.int8),
                s_down=torch.zeros((E, D), dtype=torch.bfloat16),
                row_out=torch.full((N_pad,), -1, dtype=torch.int32), gate_pad=torch.zeros(N_pad),
                tile_group=torch.zeros(2, dtype=torch.int32), tile_rows=torch.full((2,), 128, dtype=torch.int32),
                k=2, T=64, out=None)
    args.update(faults)
    return args


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


_FUSED_Q8_FAULTS = {
    ("h", "shape"): torch.zeros((256, 256), dtype=torch.bfloat16),
    ("h", "dtype"): torch.zeros((256, 128)),
    ("h", "layout"): torch.zeros((256, 256), dtype=torch.bfloat16)[:, ::2],
    ("h", "device"): torch.zeros((256, 128), dtype=torch.bfloat16, device="meta"),
    ("h", "align"): _misaligned((256, 128), torch.bfloat16),
    ("w_down", "shape"): torch.zeros((2, 256, 256), dtype=torch.int8),
    ("w_down", "dtype"): torch.zeros((2, 128, 256), dtype=torch.bfloat16),
    ("w_down", "layout"): torch.zeros((2, 128, 512), dtype=torch.int8)[..., ::2],
    ("w_down", "device"): torch.zeros((2, 128, 256), dtype=torch.int8, device="meta"),
    ("w_down", "align"): _misaligned((2, 128, 256), torch.int8),
    ("s_down", "shape"): torch.zeros((2, 128), dtype=torch.bfloat16),
    ("s_down", "dtype"): torch.zeros((2, 256)),
    ("s_down", "device"): torch.zeros((2, 256), dtype=torch.bfloat16, device="meta"),
    ("row_out", "shape"): torch.zeros(255, dtype=torch.int32),
    ("row_out", "dtype"): torch.zeros(256, dtype=torch.int64),
    ("row_out", "layout"): torch.zeros(512, dtype=torch.int32)[::2],
    ("gate_pad", "shape"): torch.zeros(128),
    ("gate_pad", "dtype"): torch.zeros(256, dtype=torch.bfloat16),
    ("gate_pad", "device"): torch.zeros(256, device="meta"),
    ("tile_group", "shape"): torch.zeros(3, dtype=torch.int32),
    ("tile_rows", "dtype"): torch.full((2,), 128, dtype=torch.int64),
    ("tile_rows", "device"): torch.full((2,), 128, dtype=torch.int32, device="meta"),
    ("out", "shape"): torch.zeros((2, 64, 128), dtype=torch.bfloat16),
    ("out", "dtype"): torch.zeros((2, 64, 256)),
    ("out", "layout"): torch.zeros((2, 64, 512), dtype=torch.bfloat16)[..., ::2],
    ("out", "device"): torch.zeros((2, 64, 256), dtype=torch.bfloat16, device="meta"),
    ("out", "align"): _misaligned((2, 64, 256), torch.bfloat16),
}


@pytest.mark.parametrize("arg,fault", sorted(_FUSED_Q8_FAULTS))
def test_fused_down_q8_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of the fused int8 down kernel #15's wrapper
    (dtype, shape, layout, device, or a base off the 16-byte boundary that
    TMA needs) raises ValueError from the argument checks, before a library
    is loaded or a stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    a = _fused_q8_down_args(**{arg: _FUSED_Q8_FAULTS[(arg, fault)]})
    with pytest.raises(ValueError, match="grouped_down_fused_q8|fused down: out"):
        teg.fused_down_q8_cuda(a["h"], a["w_down"], a["s_down"], a["row_out"], a["gate_pad"], a["tile_group"],
                               a["tile_rows"], a["k"], a["T"], out=a["out"])


@pytest.mark.parametrize("out", [False, True])
def test_fused_down_q8_good_args_reach_the_library(monkeypatch, out):
    """Arguments the kernel takes (with or without ``out=``) pass every
    check of #15's wrapper and reach the library load."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    a = _fused_q8_down_args(out=torch.zeros((2, 64, 256), dtype=torch.bfloat16) if out else None)
    with pytest.raises(AssertionError, match="reached past"):
        teg.fused_down_q8_cuda(a["h"], a["w_down"], a["s_down"], a["row_out"], a["gate_pad"], a["tile_group"],
                               a["tile_rows"], a["k"], a["T"], out=a["out"])


def _fused_down_args(**faults):
    """The fused bf16 down kernel #13's wrapper arguments: #15's with a bf16
    w_down and no scale, each replaced by ``faults[name]`` where given."""
    args = _fused_q8_down_args(w_down=torch.zeros((2, 128, 256), dtype=torch.bfloat16))
    del args["s_down"]
    args.update(faults)
    return args


_FUSED_DOWN_FAULTS = {
    **{key: t for key, t in _FUSED_Q8_FAULTS.items() if key[0] not in ("w_down", "s_down")},
    ("h", "rows"): torch.zeros((200, 128), dtype=torch.bfloat16),
    ("w_down", "shape"): torch.zeros((2, 256, 256), dtype=torch.bfloat16),
    ("w_down", "width"): torch.zeros((2, 128, 64), dtype=torch.bfloat16),
    ("w_down", "rank"): torch.zeros((128, 256), dtype=torch.bfloat16),
    ("w_down", "dtype"): torch.zeros((2, 128, 256), dtype=torch.int8),
    ("w_down", "layout"): torch.zeros((2, 128, 512), dtype=torch.bfloat16)[..., ::2],
    ("w_down", "device"): torch.zeros((2, 128, 256), dtype=torch.bfloat16, device="meta"),
    ("w_down", "align"): _misaligned((2, 128, 256), torch.bfloat16),
    ("row_out", "device"): torch.zeros(256, dtype=torch.int32, device="meta"),
    ("gate_pad", "layout"): torch.zeros(512)[::2],
    ("tile_group", "dtype"): torch.zeros(2, dtype=torch.int64),
}


def _fused_down(a):
    return teg.fused_down_cuda(a["h"], a["w_down"], a["row_out"], a["gate_pad"], a["tile_group"], a["tile_rows"],
                               a["k"], a["T"], out=a["out"])


@pytest.mark.parametrize("arg,fault", sorted(_FUSED_DOWN_FAULTS))
def test_fused_down_args_checked_before_any_library(monkeypatch, arg, fault):
    """A wrong input or ``out=`` of the fused bf16 down kernel #13's wrapper
    (dtype, shape, layout, device, or a base off the 16-byte boundary that
    TMA needs) raises ValueError from the argument checks, before a library
    is loaded or a stream looked up."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    with pytest.raises(ValueError, match="grouped_down_fused:|fused down: out"):
        _fused_down(_fused_down_args(**{arg: _FUSED_DOWN_FAULTS[(arg, fault)]}))


@pytest.mark.parametrize("out", [False, True])
def test_fused_down_good_args_reach_the_library(monkeypatch, out):
    """Arguments the kernel takes (with or without ``out=``) pass every
    check of #13's wrapper and reach the library load."""
    from repro_torch.kernels import _build

    def forbidden(*_a, **_k):
        raise AssertionError("reached past the argument checks")

    monkeypatch.setattr(_build, "load", forbidden)
    with pytest.raises(AssertionError, match="reached past"):
        _fused_down(_fused_down_args(out=torch.zeros((2, 64, 256), dtype=torch.bfloat16) if out else None))
