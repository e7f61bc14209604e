"""Port parity for MLA (Multi-head Latent Attention, minicpm3-4b): the
mixer's expanded prefill and absorbed decode, the smoke config's forward,
loss, bucketed prefill and decode steps, the ring engine's tokens against
the JAX engine's, the paged mode's refusal, and the upcycled minicpm3
(MLA with MoE FFNs) on the train CLI.

Tolerances: ``FP32_ATOL`` (1e-4) on fp32 logits, outputs and cache leaves
(the same arithmetic in another summation order); bf16 ``BF16_REL``
(2e-2) of max|ref| (the frameworks round intermediates to bf16 at
different points); losses 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BF16_REL, FP32_ATOL, assert_rel, f32, jax_params, to_torch

import repro.config as JC
import repro_torch.config as TC
from repro.models.attention import mla_apply as j_mla
from repro.models.model import decode_step as j_decode
from repro.models.model import forward as j_forward
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill_forward as j_prefill
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.models.attention import mla_apply as t_mla
from repro_torch.models.model import decode_step as t_decode
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import loss_fn as t_loss_fn
from repro_torch.models.model import prefill_forward as t_prefill
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "minicpm3-4b"
_CACHE = {}


def _pair(dtype="float32"):
    return (JC.smoke_config(JC.get_config(ARCH)).replace(dtype=dtype),
            TC.smoke_config(TC.get_config(ARCH)).replace(dtype=dtype))


def _params():
    if not _CACHE:
        j, t = _pair()
        jp = jax_params(j)
        _CACHE.update(j=j, t=t, jp=jp, tp=to_torch(jp))
    return _CACHE["j"], _CACHE["t"], _CACHE["jp"], _CACHE["tp"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode_match_jax(dtype):
    """One MLA layer of smoke minicpm3: the expanded prefill's output and
    latent cache (ckv, krope), then two absorbed decode steps against a
    ring of 24 slots holding that prefill (written in place in the port)."""
    j, t = _pair(dtype)
    from repro.models.attention import mla_decl
    from repro.sharding.rules import init_from_decls

    jp = init_from_decls(mla_decl(j), jax.random.PRNGKey(2))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = to_torch(jp)
    check = (lambda a, b: np.testing.assert_allclose(f32(a), f32(b), atol=FP32_ATOL)) if dtype == "float32" \
        else (lambda a, b: assert_rel(a, b, BF16_REL))
    rng = np.random.default_rng(4)
    B, S, W = 2, 12, 24
    x = rng.standard_normal((B, S, j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    tdt = getattr(torch, dtype)
    jo, jc = j_mla(j, None, jp, jnp.asarray(x).astype(j.dtype), jnp.asarray(pos), return_kv=True)
    to, tc = t_mla(t, tp, torch.from_numpy(x).to(tdt), torch.from_numpy(pos), return_kv=True)
    check(to, jo)
    check(tc["ckv"], jc["ckv"])
    check(tc["krope"], jc["krope"])
    # ring of W slots: the prefill in slots 0..S-1, the rest invalid
    jring = {k: jnp.zeros((B, W) + v.shape[2:], v.dtype).at[:, :S].set(v) for k, v in jc.items()}
    tring = {k: torch.zeros((B, W) + v.shape[2:], dtype=v.dtype) for k, v in tc.items()}
    for k in tring:
        tring[k][:, :S] = tc[k]
    slot_pos = np.full((B, W), -1, np.int32)
    slot_pos[:, :S] = np.arange(S)
    for p in (S, S + 1):
        slot_pos[:, p] = p
        view = {"slot": np.full((B,), p, np.int32), "slot_pos": slot_pos}
        xs = rng.standard_normal((B, 1, j.d_model)).astype(np.float32)
        ps = np.full((B, 1), p, np.int32)
        jo, jring = j_mla(j, None, jp, jnp.asarray(xs).astype(j.dtype), jnp.asarray(ps), cache=jring,
                          cache_view={k: jnp.asarray(v) for k, v in view.items()})
        to, tring = t_mla(t, tp, torch.from_numpy(xs).to(tdt), torch.from_numpy(ps), cache=tring,
                          cache_view={k: torch.from_numpy(v.copy()) for k, v in view.items()})
        check(to, jo)
        check(tring["ckv"], jring["ckv"])


def test_minicpm3_entry_points_match_jax():
    """Smoke minicpm3 (2 MLA layers), fp32: forward, loss_fn, a bucketed
    prefill of an 11-token prompt in a 16 bucket and two absorbed decode
    steps, logits and every cache leaf (the port's kernel path against the
    JAX plain path)."""
    j, t, jp, tp = _params()
    rng = np.random.default_rng(14)
    toks = rng.integers(0, j.vocab_size, (2, 16)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}
    jl, _ = j_forward(j, None, jp, jb)
    tl, _ = t_forward(t, tp, tb, use_kernel=True)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    _, jm = j_loss_fn(j, None, jp, jb)
    _, tm = t_loss_fn(t, tp, tb, use_kernel=True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    pt = np.zeros((1, 16), np.int32)
    pt[0, :11] = toks[0, :11]
    vl = np.array([11], np.int32)
    jl, jc = j_prefill(j, None, jp, {"tokens": jnp.asarray(pt)}, cache_len=24, valid_len=jnp.asarray(vl))
    tl, tc = t_prefill(t, tp, {"tokens": torch.from_numpy(pt)}, cache_len=24, use_kernel=True,
                       valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    assert set(tc["stack"]["slot0"]["attn"]) == {"ckv", "krope"}
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(f32(tc["stack"]["slot0"]["attn"][k]), f32(jc["stack"]["slot0"]["attn"][k]),
                                   atol=FP32_ATOL)
    for _ in range(2):
        tok = rng.integers(0, j.vocab_size, 1).astype(np.int32)
        jl, jc = j_decode(j, None, jp, jc, jnp.asarray(tok))
        tl, tc = t_decode(t, tp, tc, torch.from_numpy(tok), use_kernel=True)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)


def test_ring_engine_tokens_equal_jax():
    """3 requests on 2 slots, prompts in the 16 and 32 buckets, the third
    admitted mid-stream: the port's ring engine gives the JAX engine's
    greedy tokens (fp32)."""
    j, t, jp, tp = _params()

    def reqs(cls):
        rng = np.random.default_rng(5)
        return [cls(rid=i, prompt=rng.integers(0, j.vocab_size, L).astype(np.int32), max_new_tokens=n)
                for i, (L, n) in enumerate([(5, 3), (19, 5), (12, 4)])]

    jout = JEngine(j, jp, max_batch=2, max_seq=40).run(reqs(JRequest))
    tout = TEngine(t, tp, max_batch=2, max_seq=40, use_kernel=True, device="cpu").run(reqs(TRequest))
    assert tout == jout and [len(tout[i]) for i in range(3)] == [3, 5, 4]


def test_paged_mode_raises():
    """The page pool holds GQA k/v pages only; an MLA config keeps the ring
    cache in both packages."""
    j, t, jp, tp = _params()
    with pytest.raises(ValueError, match="GQA attention stacks only"):
        TEngine(t, tp, cache_mode="paged", device="cpu")
    from repro.models.model import paged_stack_decl

    with pytest.raises(AssertionError):
        paged_stack_decl(j, 8, 16)


def test_upcycled_minicpm3_preserves_the_dense_function_and_trains(capsys):
    """minicpm3 upcycled to 4 experts top-2 (MLA mixer, MoE FFN): at the
    Mixtral router's init its logits are the dense parent's (fp32); the
    train CLI's ``--upcycle`` runs on it."""
    from repro_torch.core.upcycle import upcycle_config, upcycle_params
    from repro_torch.launch.train import main as train_cli

    _, t, _, tp = _params()
    moe_cfg = upcycle_config(t, TC.MoEConfig(num_experts=4, top_k=2, capacity_factor=None, dispatcher="sorted"))
    assert moe_cfg.family == "moe" and moe_cfg.use_mla
    moe = upcycle_params(t, moe_cfg, tp, seed=0)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, t.vocab_size, (2, 16)).astype(np.int32))
    ld, _ = t_forward(t, tp, {"tokens": toks})
    lm, _ = t_forward(moe_cfg, moe, {"tokens": toks}, use_kernel=True)
    np.testing.assert_allclose(f32(lm), f32(ld), atol=FP32_ATOL)
    tr = train_cli(["--arch", ARCH, "--smoke", "--upcycle", "4", "--top-k", "2", "--cf", "-1", "--use-kernel",
                    "--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu"])
    assert tr.state.step == 2 and np.isfinite(tr.history[-1]["loss"])
    assert "final held-out CE" in capsys.readouterr().out
