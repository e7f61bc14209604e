"""Port parity: parameter declarations, forward, prefill_forward,
decode_step, configs, and the function-preserving upcycle."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FP32_ATOL, configs, f32, jax_params, to_torch

import repro.config as JC
import repro_torch.config as TC
from repro.models.model import decode_step as j_decode
from repro.models.model import forward as j_forward
from repro.models.model import model_decl as j_model_decl
from repro.models.model import prefill_forward as j_prefill
from repro.sharding.rules import ParamDecl as JDecl
from repro_torch.core.upcycle import upcycle_config, upcycle_params
from repro_torch.models.model import decode_step as t_decode
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import model_decl as t_model_decl
from repro_torch.models.model import prefill_forward as t_prefill
from repro_torch.params import ParamDecl as TDecl
from repro_torch.params import init_from_decls, tree_leaves


def _flat(tree, is_leaf, prefix=""):
    out = {}
    for k, v in tree.items():
        if is_leaf(v):
            out[prefix + k] = v
        else:
            out.update(_flat(v, is_leaf, prefix + k + "/"))
    return out


@pytest.mark.parametrize("moe", [False, True])
def test_model_decl_matches_jax(moe):
    """Same keys, shapes (stacked (periods, ...) leading dim), init rules
    and dtypes as the JAX declarations."""
    jcfg, tcfg = configs(moe=moe, fp32=False)
    jd = _flat(j_model_decl(jcfg), lambda v: isinstance(v, JDecl))
    td = _flat(t_model_decl(tcfg), lambda v: isinstance(v, TDecl))
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert jd[k].shape == td[k].shape and jd[k].init == td[k].init, k
        assert str(jnp.dtype(jd[k].dtype)) == str(td[k].dtype).replace("torch.", ""), k
    params = init_from_decls(t_model_decl(tcfg), 0, "cpu")
    assert all(torch.isfinite(t.float()).all() for t in tree_leaves(params))


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward(rng, moe, use_kernel):
    jcfg, tcfg = configs(moe=moe)
    jp = jax_params(jcfg)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jaux = j_forward(jcfg, None, jp, {"tokens": jnp.asarray(toks)}, use_kernel=use_kernel)
    tl, taux = t_forward(tcfg, to_torch(jp), {"tokens": torch.from_numpy(toks)}, use_kernel=use_kernel)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    for k in ("load_balance_loss", "z_loss"):  # summed over layers in both
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_then_decode(rng, use_kernel):
    """Bucketed prefill (valid_len) -> ring cache -> two decode steps: the
    logits and every cache leaf agree with the JAX package."""
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = rng.integers(0, jcfg.vocab_size, 11)
    vl = np.array([11], np.int32)
    jl, jc = j_prefill(jcfg, None, jp, {"tokens": jnp.asarray(toks)}, cache_len=24,
                       use_kernel=use_kernel, valid_len=jnp.asarray(vl))
    tl, tc = t_prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, cache_len=24,
                       use_kernel=use_kernel, valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab_size, 1).astype(np.int32)
        jl, jc = j_decode(jcfg, None, jp, jc, jnp.asarray(tok), use_kernel=use_kernel)
        tl, tc = t_decode(tcfg, tp, tc, torch.from_numpy(tok), use_kernel=use_kernel)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    for jleaf, tleaf in zip(jax.tree.leaves(jc["stack"]), tree_leaves(tc["stack"])):
        np.testing.assert_allclose(f32(tleaf), f32(jleaf), atol=FP32_ATOL)


def test_decode_from_empty_cache_marks_other_slots_invalid(rng):
    """pos == 0 resets every other slot of the row to -1 (model.py:169-177)."""
    jcfg, tcfg = configs(moe=False)
    jp = jax_params(jcfg)
    from repro.models.model import cache_decl as j_cache_decl
    from repro_torch.models.model import cache_decl as t_cache_decl

    jc = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), j_cache_decl(jcfg, 2, 8),
                      is_leaf=lambda d: isinstance(d, JDecl))
    tc = init_from_decls(t_cache_decl(tcfg, 2, 8), 0, "cpu")
    tok = np.array([3, 7], np.int32)
    jl, jc = j_decode(jcfg, None, jp, jc, jnp.asarray(tok))
    tl, tc = t_decode(tcfg, to_torch(jp), tc, torch.from_numpy(tok))
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)


def test_upcycled_moe_equals_dense_parent(rng):
    """The paper's claim (tests/test_upcycle.py:18) on the port: with the
    Mixtral router the upcycled MoE's first forward is the dense forward."""
    jcfg, tcfg = configs(moe=False, num_layers=4)
    dense = to_torch(jax_params(jcfg))
    moe_cfg = upcycle_config(tcfg, TC.MoEConfig(num_experts=4, top_k=2, capacity_factor=None,
                                                router_type="mixtral", dispatcher="sorted"))
    moe = upcycle_params(tcfg, moe_cfg, dense, seed=1)
    assert moe["stack"]["slot0"]["ffn"]["experts"]["w_gate"].shape[1] == 4
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    ld, _ = t_forward(tcfg, dense, {"tokens": toks})
    for use_kernel in (False, True):
        lm, _ = t_forward(moe_cfg, moe, {"tokens": toks}, use_kernel=use_kernel)
        np.testing.assert_allclose(f32(lm), f32(ld), atol=FP32_ATOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "llama3-e8t2"])
def test_configs_match_jax(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    for f in dataclasses.fields(t):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name == "moe" and tv is not None:
            jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
        assert jv == tv, f.name
    js, ts = JC.smoke_config(j), TC.smoke_config(t)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size"):
        assert getattr(js, f) == getattr(ts, f), f
    assert t.padded_vocab == j.padded_vocab
