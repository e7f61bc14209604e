"""Port parity for the routers and the order-fixed k-way sums:

* the sorted, padded and fused-backward combines at top-8 and under
  expert choice against the JAX package, and each bit for bit against its
  declared summation order (each token's rows added one at a time in
  ascending row of the expert-major buffer, ``core.segment``);
* ``expert_choice_tables`` with ties, ``moe_apply`` and a model's
  gradients under expert choice, and the dispatcher registry's rules for
  it, against the JAX package;
* noisy gating: ``train=False`` is plain routing, the drawn noise is
  standard normal as JAX's is (parity is distributional: the port draws
  from a ``torch.Generator``), remat and no remat give the same gradients
  from one generator state, and a resumed run replays noisy steps bit for
  bit.

Tolerances: fp32 outputs 1e-6 absolute (sorted combine: the same fp32 adds
in the same order) or 1e-5 (the MoE layer: the experts' matmuls sum in
another order); bf16 padded combines bit-equal to JAX's
(the same bf16 adds in the same order); gradients 2e-4 absolute as in
``test_torch_fused.py``; noise moments within 0.02 over 100k draws (five
standard errors of the variance estimate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused import GRAD_ATOL, _case, _jax, _torch
from torch_parity import configs, f32, jax_params, to_torch

from repro.core.dispatch import get_dispatcher as j_get_dispatcher
from repro.core.dispatch.allgather import AllGatherDispatcher as JAllGather
from repro.core.dispatch.base import expert_choice_tables as j_ec_tables
from repro.core.dispatch.sorted import SortedDispatcher as JSorted
from repro.core.moe import moe_apply as j_moe_apply
from repro.core.router import route as j_route
from repro.kernels import expert_gemm as jeg
from repro.models.model import loss_fn as j_loss_fn
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.core import segment
from repro_torch.core.dispatch import AllGatherDispatcher as TAllGather
from repro_torch.core.dispatch import SortedDispatcher as TSorted
from repro_torch.core.dispatch import expert_choice_tables as t_ec_tables
from repro_torch.core.dispatch import get_dispatcher as t_get_dispatcher
from repro_torch.core.moe import moe_apply as t_moe_apply
from repro_torch.core.router import route as t_route
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.kernels import expert_gemm as teg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import loss_fn as t_loss_fn
from repro_torch.params import tree_leaves
from repro_torch.train.callbacks import LoggingCallback
from repro_torch.train.state import state_to_tree, tree_to_state
from repro_torch.train.trainer import Trainer, microbatch_generators

EC = dict(router_type="expert_choice", dispatcher="allgather")


def _topk(rng, T, E, k):
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    gates = rng.uniform(0.2, 1.0, (T, k)).astype(np.float32)
    return idx, gates


def _ordered_sum(rows, owners, T):
    """The declared order, written out: token t's rows added one at a time
    in ascending row index, onto zero, in ``rows``' dtype."""
    out = torch.zeros((T,) + rows.shape[1:], dtype=rows.dtype)
    for r in range(rows.shape[0]):
        t = int(owners[r])
        if 0 <= t < T:
            out[t] = out[t] + rows[r]
    return out


def test_segment_sums_are_adjoint_and_order_fixed():
    """``table_sum`` and ``row_gather`` are each other's adjoints (gradcheck
    in fp64, with sentinel entries) and add in table order."""
    rng = np.random.default_rng(3)
    # 3 experts x 4 slots over 5 tokens, distinct tokens per expert (expert choice)
    sel = torch.stack([torch.from_numpy(rng.permutation(5)[:4]) for _ in range(3)])
    table = segment.slot_row_table(sel, 5)
    owner = segment.row_owner(table, 12)
    rows = torch.randn((12, 3), dtype=torch.float64, requires_grad=True)
    x = torch.randn((5, 3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda r: segment.table_sum(r, table, owner), (rows,))
    assert torch.autograd.gradcheck(lambda v: segment.row_gather(v, sel.reshape(-1), table), (x,))
    np.testing.assert_array_equal(owner.numpy(), sel.reshape(-1).numpy())
    out = segment.table_sum(rows.detach().float(), table, owner)
    assert torch.equal(out, _ordered_sum(rows.detach().float(), owner, 5))


def test_sorted_combine_top8_matches_jax_and_its_order(rng):
    jcfg, tcfg = configs(moe_kw=dict(num_experts=16, top_k=8))
    T, D, E, k = 24, 32, 16, 8
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx, gates = _topk(rng, T, E, k)
    jd, td = JSorted(jcfg, jcfg.moe, None), TSorted(tcfg, tcfg.moe)
    jxs, jst = jd.dispatch(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), row_block=8)
    txs, tst = td.dispatch(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates), row_block=8)
    np.testing.assert_array_equal(f32(txs), f32(jxs))
    ye = rng.standard_normal(txs.shape).astype(np.float32)
    out = td.combine(torch.from_numpy(ye), tst)
    np.testing.assert_allclose(f32(out), f32(jd.combine(jnp.asarray(ye), jst)), atol=1e-6)
    r = tst.residuals
    yv = torch.from_numpy(ye)[r["dest"]] * r["gate_sorted"][:, None]
    assert torch.equal(out, _ordered_sum(yv, r["token"], T))


def _padded_pair(rng, moe_kw, T, D, gates_full=None):
    jcfg, tcfg = configs(moe_kw=moe_kw)
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    x = rng.standard_normal((T, D)).astype(np.float32)
    if gates_full is None:
        idx, gates = _topk(rng, T, E, k)
    else:
        idx, gates = np.zeros((T, 1), np.int32), gates_full
    jd, td = JAllGather(jcfg, jcfg.moe, None), TAllGather(tcfg, tcfg.moe)
    jxe, jst = jd.dispatch(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates))
    txe, tst = td.dispatch(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates))
    np.testing.assert_array_equal(f32(txe), f32(jxe))
    np.testing.assert_array_equal(tst.residuals["sel"].numpy(), np.asarray(jst.residuals["sel"]))
    np.testing.assert_array_equal(f32(tst.residuals["slot_gate"]), f32(jst.residuals["slot_gate"]))
    ye = rng.standard_normal(txe.shape).astype(np.float32)
    jout = jd.combine(jnp.asarray(ye, jnp.bfloat16), jst)
    out = td.combine(torch.from_numpy(ye).bfloat16(), tst)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(out), f32(jout))
    # the declared order: slots (e, c) ascending, each gated row onto zero in bf16; empty slots add nothing
    sg = tst.residuals["slot_gate"][0]
    yg = (torch.from_numpy(ye).bfloat16() * sg[..., None].bfloat16())[0].reshape(-1, D)
    owners = torch.where(sg.reshape(-1) != 0, tst.residuals["sel"][0].reshape(-1), -1)
    assert torch.equal(out, _ordered_sum(yg, owners, T))
    return tst


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_padded_combine_top8_matches_jax_and_its_order(rng, cf):
    """top-8 over 16 experts at CF 1 (assignments dropped) and CF 2."""
    st = _padded_pair(rng, dict(num_experts=16, top_k=8, capacity_factor=cf, dispatcher="allgather"), 24, 32)
    assert st.residuals["table"].shape == (24, 8)


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_padded_combine_expert_choice_matches_jax_and_its_order(rng, cf):
    """Expert choice: up to E slots a token (CF 4 gives C = T, so every
    expert takes every token)."""
    T, E = 24, 4
    logits = rng.standard_normal((T, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    st = _padded_pair(rng, dict(num_experts=E, top_k=2, capacity_factor=cf, **EC), T, 32, probs.astype(np.float32))
    counts = (st.residuals["table"] < st.residuals["owner"].shape[0]).sum(1)
    assert int(counts.max()) >= 3  # some token sums three or more slots


@pytest.mark.parametrize("row_block", [8, 128])
def test_fused_backward_dx_top8_matches_jax_and_its_order(monkeypatch, row_block):
    """``FusedMoe``'s dx at top-8 over 16 experts against ``jax.grad``
    through the JAX fused path (interpret mode), and bit for bit against
    each token's 8 rows of the grouped backward's dxs added in sorted
    order; the plain fused composition ``fused_unfused_ref`` sums its
    forward and its x gradient the same way."""
    x, ws, (token, slot, dest, gate, gs) = _case(16, 8, 16, 128, 128, row_block, seed=4)
    jidx = _jax([gs, token, dest, slot])

    def jloss(x, wg, wu, wd, g):
        y = jeg.grouped_gemm_fused(x, wg, wu, wd, *jidx, g, blocks=(row_block, 512, 512), interpret=True)
        return jnp.sum(jnp.square(y))

    jdx = jax.grad(jloss)(*_jax([x] + ws + [gate]))
    captured = {}
    bwd = teg.grouped_gemm_bwd

    def spy(*a, **kw):
        out = bwd(*a, **kw)
        captured["dxs"] = out[0]
        return out

    monkeypatch.setattr(teg, "grouped_gemm_bwd", spy)
    xt = torch.from_numpy(x).requires_grad_(True)
    tidx = [torch.from_numpy(gs)] + _torch([token, dest, slot])
    y = tops.grouped_gemm_fused(xt, *_torch(ws), *tidx, torch.from_numpy(gate), row_block=row_block)
    (dx,) = torch.autograd.grad(y.square().sum(), [xt])
    np.testing.assert_allclose(f32(dx), f32(jdx), atol=GRAD_ATOL)
    tok, dst = torch.from_numpy(token).long(), torch.from_numpy(dest).long()
    assert torch.equal(dx, _ordered_sum(captured["dxs"][dst], tok, 16))

    xr = torch.from_numpy(x).requires_grad_(True)
    yr = tref.fused_unfused_ref(xr, *_torch(ws), *tidx, torch.from_numpy(gate), row_block=row_block)
    (dxr,) = torch.autograd.grad(yr.square().sum(), [xr])
    np.testing.assert_allclose(f32(yr), f32(y), atol=1e-5)
    np.testing.assert_allclose(f32(dxr), f32(dx), atol=GRAD_ATOL)


def test_expert_choice_tables_with_ties_match_jax(rng):
    """Each expert's top-C tokens, ties to the lower token index."""
    T, E, C = 12, 4, 5
    probs = rng.uniform(size=(T, E)).astype(np.float32)
    probs[6:] = probs[:6]  # every value twice: tokens t and t + 6 tie
    probs[:, 1] = 0.25  # one expert sees nothing but ties
    js, jg = j_ec_tables(jnp.asarray(probs), E, C)
    ts, tg = t_ec_tables(torch.from_numpy(probs), E, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ts[1].numpy(), np.arange(C))


@pytest.mark.parametrize("dispatcher", ["sorted", "allgather"])
@pytest.mark.parametrize("cf", [1.0, 2.0])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_apply_expert_choice_matches_jax(rng, dispatcher, cf, use_kernel):
    """moe_apply with expert choice (``sorted`` resolves to ``allgather``)
    and its aux losses (no load-balance term), fp32."""
    jcfg, tcfg = configs(moe_kw=dict(router_type="expert_choice", dispatcher=dispatcher, capacity_factor=cf))
    jp = jax_params(jcfg)
    ffn = jp["stack"]["slot0"]["ffn"]
    jffn = jax.tree.map(lambda a: a[0], ffn)
    tffn = to_torch(jffn)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe_apply(jcfg, jcfg.moe, None, jffn, jnp.asarray(x), use_kernel=use_kernel)
    ty, taux = t_moe_apply(tcfg, tcfg.moe, tffn, torch.from_numpy(x), use_kernel)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    assert float(taux["load_balance_loss"]) == 0.0


def test_expert_choice_model_grads_match_jax(rng):
    """Gradients of a two-layer expert-choice model (router through the
    gathered probabilities, experts through the padded buffer) against
    ``jax.grad``, within GRAD_ATOL."""
    jcfg, tcfg = configs(moe_kw=dict(capacity_factor=1.0, **EC))
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jg = jax.grad(lambda p: j_loss_fn(jcfg, None, p, {k: jnp.asarray(v) for k, v in b.items()})[0])(jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = t_loss_fn(tcfg, tp, {k: torch.from_numpy(v) for k, v in b.items()}, use_kernel=True)
    tg = torch.autograd.grad(loss, leaves)
    for a, ref in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(f32(a), f32(ref), atol=GRAD_ATOL)


def test_dispatcher_rules_for_expert_choice(monkeypatch):
    """``sorted`` with expert choice resolves to ``allgather``; under
    ``alltoall`` expert choice is the fallback's reason (strict: raises)."""
    _, tcfg = configs(moe_kw=dict(router_type="expert_choice", dispatcher="sorted"))
    assert isinstance(t_get_dispatcher(tcfg, tcfg.moe), TAllGather)
    jcfg, _ = configs(moe_kw=dict(router_type="expert_choice", dispatcher="sorted"))
    assert isinstance(j_get_dispatcher(jcfg, jcfg.moe, None, 24, 2), JAllGather)
    moe = dataclasses.replace(tcfg.moe, dispatcher="alltoall")
    with pytest.raises(ValueError, match="expert_choice routing needs the full"):
        t_get_dispatcher(tcfg, moe)
    monkeypatch.setenv("REPRO_STRICT_DISPATCH", "0")
    with pytest.warns(UserWarning, match="expert_choice"):
        assert isinstance(t_get_dispatcher(tcfg, moe), TAllGather)


NOISY = dict(noisy_gating=True)


def test_noisy_route_without_training_is_plain_routing(rng):
    """``train=False`` (or no generator) routes exactly as without noisy
    gating, in both packages; w_noise is declared zeros, fp32."""
    from repro_torch.core.router import router_decl

    _, tcfg = configs(moe_kw=NOISY)
    jcfg, _ = configs(moe_kw=NOISY)
    decl = router_decl(64, tcfg.moe)
    assert decl["w_noise"].init == "zeros" and decl["w_noise"].dtype == torch.float32
    w = (rng.standard_normal((64, 4)) * 0.5).astype(np.float32)
    wn = (rng.standard_normal((64, 4)) * 0.5).astype(np.float32)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    tp = {"w_g": torch.from_numpy(w), "w_noise": torch.from_numpy(wn)}
    plain = dataclasses.replace(tcfg.moe, noisy_gating=False)
    ref = t_route(plain, {"w_g": tp["w_g"]}, torch.from_numpy(x))
    gen = torch.Generator().manual_seed(0)
    for out in (t_route(tcfg.moe, tp, torch.from_numpy(x), gen, train=False),
                t_route(tcfg.moe, tp, torch.from_numpy(x), None, train=True)):
        for a, b in zip(out[:2], ref[:2]):
            assert torch.equal(a, b)
    jg, ji, _ = j_route(jcfg.moe, {"w_g": jnp.asarray(w), "w_noise": jnp.asarray(wn)}, jnp.asarray(x),
                        jax.random.PRNGKey(0), train=False)
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(f32(ref[0]), f32(jg), atol=1e-6)


def _noise_samples(route_fn, n_rows: int):
    """Standardised noise from the ``st`` router over two experts with
    w_g = 0 and equal noise scales s: log(p_a / p_b) = s (n_a - n_b), so
    its ratio to s sqrt(2) is N(0, 1) if the noise is."""
    D = 8
    x = np.ones((n_rows, D), np.float32)
    wn = np.full((D, 2), 0.05, np.float32)
    s = np.log1p(np.exp(D * 0.05))  # softplus(x @ w_noise)
    gates, idx = route_fn(x, np.zeros((D, 2), np.float32), wn)
    p_hi, p_lo = gates[:, 0], gates[:, 1]
    sign = np.where(idx[:, 0] == 0, 1.0, -1.0)
    return sign * np.log(p_hi / p_lo) / (s * np.sqrt(2.0))


def test_noisy_gating_noise_is_standard_normal_in_both_packages():
    n = 100_000
    moe = dict(num_experts=2, top_k=2, router_type="st", **NOISY)
    jcfg, tcfg = configs(moe_kw=moe)
    gen = torch.Generator().manual_seed(1)

    def t_fn(x, w, wn):
        g, i, _ = t_route(tcfg.moe, {"w_g": torch.from_numpy(w), "w_noise": torch.from_numpy(wn)},
                          torch.from_numpy(x), gen, train=True)
        return g.double().numpy(), i.numpy()

    def j_fn(x, w, wn):
        g, i, _ = j_route(jcfg.moe, {"w_g": jnp.asarray(w), "w_noise": jnp.asarray(wn)}, jnp.asarray(x),
                          jax.random.PRNGKey(1), train=True)
        return np.asarray(g, np.float64), np.asarray(i)

    for fn in (t_fn, j_fn):
        z = _noise_samples(fn, n)
        assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.02, (fn.__name__, z.mean(), z.var())


def _noisy_cfg(**kw):
    return configs(moe_kw=dict(noisy_gating=True), **kw)[1]


def _noisy_params(cfg, seed=0):
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls, tree_map

    params = tree_map(lambda t: t.float(), init_from_decls(model_decl(cfg), seed, "cpu"))  # an fp32 config
    # a nonzero w_noise, so the noise scale depends on x
    params["stack"]["slot0"]["ffn"]["router"]["w_noise"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    return params


@pytest.mark.parametrize("use_kernel", [False, True])
def test_noisy_gating_remat_grads_equal_no_remat(rng, use_kernel):
    """The stack draws each MoE layer's noise before its checkpointed
    period, so the recompute sees the forward's noise: gradients under
    remat="full" equal those under remat="none" from one generator state,
    bit for bit; the noise reaches w_noise's gradient."""
    cfg = _noisy_cfg()
    params = _noisy_params(cfg)
    leaves = tree_leaves(params)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    for t in leaves:
        t.requires_grad_(True)
    grads, losses = {}, {}
    for remat in ("full", "none"):
        gen = torch.Generator().manual_seed(7)
        loss, _ = t_loss_fn(cfg.replace(remat=remat), params, batch, gen, use_kernel=use_kernel)
        grads[remat] = torch.autograd.grad(loss, leaves)
        losses[remat] = float(loss.detach())
    assert losses["full"] == losses["none"]
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)
    w_noise = params["stack"]["slot0"]["ffn"]["router"]["w_noise"]
    assert float(grads["full"][[i for i, t in enumerate(leaves) if t is w_noise][0]].abs().max()) > 0
    plain, _ = t_loss_fn(cfg, params, batch, None, use_kernel=use_kernel)
    assert float(plain) != losses["full"]  # the noise moved the loss


def _noisy_trainer(cfg, state=None, data_state=None):
    tcfg = TTrainConfig(global_batch=2, seq_len=16, lr=1e-3, lr_min=1e-5, warmup_steps=1, total_steps=4, seed=0)
    it = t_make_train_iter(cfg.vocab_size, 16, 2, tcfg.blend_ratio, 0)
    if data_state is not None:
        it.restore(data_state)
    params = None if state is not None else _noisy_params(cfg)
    return Trainer(cfg, tcfg, params=params, state=state, data_iter=it, use_kernel=True, device="cpu")


def test_noisy_steps_resume_bit_for_bit():
    """Four noisy steps straight, and two steps, a save of the state tree
    (with the generator's ``rng_state``) and two steps resumed in a fresh
    Trainer: the same losses and every parameter bit-equal. The generator
    advances one draw a step whatever the microbatch count."""
    cfg = _noisy_cfg()
    quiet = [LoggingCallback(log=lambda m: None, log_every=1)]
    straight = _noisy_trainer(cfg)
    straight.run(4, callbacks=quiet)
    first = _noisy_trainer(cfg)
    first.run(2, callbacks=quiet)
    restored = tree_to_state(state_to_tree(first.state), cfg, "cpu")
    resumed = _noisy_trainer(cfg, state=restored, data_state=first.data_iter.state())
    resumed.run(2, callbacks=quiet)
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in straight.history[2:]]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    gens = []
    for m in (1, 2):
        g = torch.Generator().manual_seed(5)
        microbatch_generators(cfg.replace(train_microbatches=m), g, m)
        gens.append(g.get_state())
    assert torch.equal(gens[0], gens[1])
    assert len(microbatch_generators(cfg, torch.Generator(), 3)) == 3
