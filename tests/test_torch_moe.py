"""Port parity: router gates and indices, sorted dispatch/combine, the plain
grouped GEMM against the JAX Pallas kernel (interpret mode) and its
oracle, and moe_apply."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FP32_ATOL, assert_rel, configs, f32, jax_params, to_torch

from repro.core.dispatch.sorted import SortedDispatcher as JSorted
from repro.core.dispatch.sorted import aligned_rows
from repro.core.moe import moe_apply as j_moe_apply
from repro.core.router import route as j_route
from repro.kernels import ops as jops
from repro.kernels.expert_gemm import group_tiling as j_group_tiling
from repro.kernels.ref import grouped_gemm_ref as j_gg_ref
from repro_torch.core.dispatch import SortedDispatcher as TSorted
from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.moe import moe_apply as t_moe_apply
from repro_torch.core.router import route as t_route
from repro_torch.kernels import ops as tops
from repro_torch.kernels.expert_gemm import group_tiling as t_group_tiling


@pytest.mark.parametrize("router_type", ["mixtral", "st"])
def test_router_gates_indices_and_aux(rng, router_type):
    jcfg, tcfg = configs(moe_kw=dict(router_type=router_type))
    w = (rng.standard_normal((64, 4)) * 0.5).astype(np.float32)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    x[:3] = 0.0  # all-equal logits: ties go to the lower expert index
    jg, ji, jaux = j_route(jcfg.moe, {"w_g": jnp.asarray(w)}, jnp.asarray(x))
    tg, ti, taux = t_route(tcfg.moe, {"w_g": torch.from_numpy(w)}, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[:3].numpy(), [[0, 1]] * 3)
    np.testing.assert_allclose(f32(tg), f32(jg), atol=1e-6)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("row_block", [1, 128])
def test_sorted_dispatch_and_combine(rng, row_block):
    jcfg, tcfg = configs()
    T, D, E, k = 24, 64, 4, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    idx[idx == 3] = 0  # expert 3 stays empty (its partner slot keeps the row valid)
    idx[:, 1] = np.where(idx[:, 1] == idx[:, 0], (idx[:, 0] + 1) % 3, idx[:, 1])
    gates = rng.random((T, k)).astype(np.float32)
    jd, td = JSorted(jcfg, jcfg.moe, None), TSorted(tcfg, tcfg.moe)
    jxs, jst = jd.dispatch(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), row_block=row_block)
    txs, tst = td.dispatch(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates), row_block=row_block)
    assert txs.shape[0] == aligned_rows(T * k, E, row_block)
    np.testing.assert_array_equal(f32(txs), f32(jxs))
    np.testing.assert_array_equal(tst.layout.group_sizes.numpy(), np.asarray(jst.layout.group_sizes))
    assert tst.layout.group_sizes[3] == 0
    ye = rng.standard_normal(txs.shape).astype(np.float32)
    np.testing.assert_allclose(
        f32(td.combine(torch.from_numpy(ye), tst)), f32(jd.combine(jnp.asarray(ye), jst)), atol=1e-6)


GG_CASES = [  # (E, D, F, group_sizes, row_block)
    (4, 32, 64, (16, 0, 7, 9), 8),
    (3, 64, 128, (130, 0, 13), 128),  # empty expert, group past one tile
    (2, 32, 64, (0, 0), 8),  # nothing routed
]


def _sorted_buffer(rng, gs, D, bc):
    gs = np.asarray(gs, np.int32)
    N_pad = aligned_rows(int(gs.sum()), len(gs), bc)
    xs = np.full((N_pad, D), 7.5, np.float32)  # poisoned padding rows
    padded = (gs + bc - 1) // bc * bc
    starts = np.cumsum(padded) - padded
    valid = np.zeros(N_pad, bool)
    for e, g in enumerate(gs):
        xs[starts[e]:starts[e] + g] = rng.standard_normal((g, D)) * 0.3
        valid[starts[e]:starts[e] + g] = True
    return gs, xs, valid


@pytest.mark.parametrize("case", GG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_gemm_matches_jax_kernel_and_oracle(rng, case, dtype):
    E, D, F, gs, bc = case
    gs, xs, valid = _sorted_buffer(rng, gs, D, bc)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    jargs = [jnp.asarray(a, dtype) for a in (xs, *ws)] + [jnp.asarray(gs)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (xs, *ws)] + [torch.from_numpy(gs)]
    jk = jops.grouped_gemm(*jargs, row_block=bc)  # Pallas, interpret mode
    jr = j_gg_ref(*jargs, row_block=bc)
    ty = tops.grouped_gemm(*targs, row_block=bc)
    assert f32(ty)[~valid].max(initial=0) == 0 and f32(ty)[~valid].min(initial=0) == 0
    for ref in (jk, jr):
        if dtype == "float32":
            np.testing.assert_allclose(f32(ty)[valid], f32(ref)[valid], atol=1e-5)
        elif valid.any():
            assert_rel(f32(ty)[valid], f32(ref)[valid])


def test_ragged_plain_path_matches_grouped_gemm_xla(rng):
    gs = np.array([5, 0, 9, 2], np.int32)
    xs = (rng.standard_normal((16, 32)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in ((4, 32, 64), (4, 32, 64), (4, 64, 32))]
    jy = jops.grouped_gemm_xla(*[jnp.asarray(a) for a in (xs, *ws)], jnp.asarray(gs))
    ty = tops.grouped_gemm_ragged(*[torch.from_numpy(a) for a in (xs, *ws)], torch.from_numpy(gs))
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5)


@pytest.mark.parametrize("gs", [(16, 0, 7, 9), (0, 0, 0, 40), (128, 1, 0, 0)])
def test_group_tiling_matches_jax(gs):
    bc = 8 if max(gs) < 128 else 128
    nt = aligned_rows(sum(gs), len(gs), bc) // bc
    jtg, jtr = j_group_tiling(jnp.asarray(gs, jnp.int32), nt, bc)
    ttg, ttr = t_group_tiling(torch.tensor(gs, dtype=torch.int32), nt, bc)
    np.testing.assert_array_equal(ttg.numpy(), np.asarray(jtg))
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_apply(rng, use_kernel):
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)["stack"]["slot0"]["ffn"]
    layer = jax.tree.map(lambda a: a[0], jp)  # first period
    x = (rng.standard_normal((2, 9, 64)) * 0.5).astype(np.float32)
    jy, jaux = j_moe_apply(jcfg, jcfg.moe, None, layer, jnp.asarray(x), use_kernel=use_kernel)
    ty, taux = t_moe_apply(tcfg, tcfg.moe, to_torch(layer), torch.from_numpy(x), use_kernel=use_kernel)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=FP32_ATOL)
    np.testing.assert_allclose(float(taux["z_loss"]), float(jaux["z_loss"]), rtol=1e-5)


def test_unported_dispatchers_raise():
    _, tcfg = configs(moe_kw=dict(dispatcher="allgather"))
    with pytest.raises(NotImplementedError, match="padded dispatch"):
        get_dispatcher(tcfg, tcfg.moe)
