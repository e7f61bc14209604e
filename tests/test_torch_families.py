"""Port parity for the families of the twelve architectures: config
fields, ``param_counts`` and ``flops_per_token`` against the JAX package's
configs; ``upcycle_config`` keeps the JAX family, and the upcycled vlm and
encdec smoke configs' losses equal the JAX ones; each GQA architecture's smoke
config, with the JAX parameters carried across in fp32, gives the JAX
``forward``, ``loss_fn``, ``prefill_forward`` and two ``decode_step``s
(tied embeddings, QKV bias, LayerNorm, the vlm prefix, 128-expert configs'
padded dispatch at CF 1 and 2, the dense residual); an explicit top-8
config (``smoke_config`` caps top-k at 2); the vlm stub input on the
training and serving CLIs.

Tolerance: ``FP32_ATOL`` (1e-4) on fp32 logits and cache leaves (the same
arithmetic, other summation order); losses 1e-5 relative.
"""
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
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill_forward as j_prefill
from repro_torch.models.model import decode_step as t_decode
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import loss_fn as t_loss_fn
from repro_torch.models.model import prefill_forward as t_prefill

NEW_ARCHS = ("llama3.2-3b", "qwen2.5-14b", "stablelm-1.6b", "llava-next-34b", "arctic-480b", "qwen3-moe-30b-a3b")


def _fields_equal(j, t):
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if dataclasses.is_dataclass(tv):
            jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
        assert jv == tv, f.name


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_arch_configs_match_jax(arch):
    """Every field of the config (the JAX package's fields, in its order;
    MLA's and the SSM's sub-configs), the counts, the FLOPs and the
    long-context rule equal the JAX config's, at full size and in the
    smoke config."""
    assert len(TC.ARCH_IDS) == 12 and set(TC.ARCH_IDS) == set(JC.ARCH_IDS)
    j, t = JC.get_config(arch), TC.get_config(arch)
    _fields_equal(j, t)
    assert t.param_counts() == j.param_counts()
    assert t.supports_long_context == j.supports_long_context
    for S in (1, 4096):
        assert t.flops_per_token(S) == j.flops_per_token(S)
    js, ts = JC.smoke_config(j), TC.smoke_config(t)
    _fields_equal(js, ts)
    assert ts.param_counts() == js.param_counts() and ts.padded_vocab == js.padded_vocab


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b", "minicpm3-4b", "seamless-m4t-medium"])
def test_training_mfu_counts_every_family(arch):
    """MFU from ``flops_per_token`` alone: an SSM stack adds no attention
    FLOPs, a hybrid only its attention layers', so the JAX package's count
    at S 4096 over the h100 profile's peak."""
    from repro_torch.roofline.analysis import training_mfu

    j = JC.get_config(arch)
    mfu = training_mfu(TC.get_config(arch), 4096, 1000.0)
    assert mfu == 3 * j.flops_per_token(4096) * 1000.0 / 989e12
    if arch.startswith("mamba2"):
        assert j.flops_per_token(4096) == j.flops_per_token(1)


def test_unknown_arch_and_family_raise():
    with pytest.raises(ValueError, match="unknown --arch"):
        TC.get_config("gpt-2")
    with pytest.raises(ValueError, match="unknown family"):
        TC.ModelConfig(family="rnn")


@pytest.mark.parametrize("arch", [a for a in TC.ARCH_IDS if TC.get_config(a).d_ff > 0])
def test_upcycle_config_keeps_the_jax_family(arch):
    """``upcycle_config`` turns a dense family into ``moe`` and leaves every
    other family as the JAX version leaves it (vlm, encdec, hybrid, moe)."""
    from repro.core.upcycle import upcycle_config as j_up
    from repro_torch.core.upcycle import upcycle_config as t_up

    kw = dict(num_experts=4, top_k=2, moe_layer_freq=2 if arch.startswith("jamba") else 1)
    j = j_up(JC.get_config(arch), JC.MoEConfig(**kw))
    t = t_up(TC.get_config(arch), TC.MoEConfig(**kw))
    assert t.family == j.family and t.name == j.name
    _fields_equal(j, t)


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-medium"])
def test_upcycled_vlm_and_encdec_loss_match_jax(rng, arch):
    """The upcycled llava (its ``embeds`` prefix kept) and seamless (its
    encoder kept) smoke configs: JAX's ``upcycle_params`` carried across,
    the port's loss metrics equal JAX's (fp32; 1e-4 relative: seamless's
    random smoke stack parts the same fp32 arithmetic in another order by
    up to 3.2e-5 of its loss on some batches, ``test_torch_encdec.py``)."""
    from repro.core.upcycle import upcycle_config as j_up
    from repro.core.upcycle import upcycle_params as j_upp
    from repro_torch.core.upcycle import upcycle_config as t_up

    jd, td = _pair(arch)
    kw = dict(num_experts=4, top_k=2, capacity_factor=None, dispatcher="sorted")
    jm, tm = j_up(jd, JC.MoEConfig(**kw)), t_up(td, TC.MoEConfig(**kw))
    assert tm.family == jm.family == jd.family
    jp = j_upp(jd, jm, jax_params(jd), jax.random.PRNGKey(3))
    tp = to_torch(jp)
    b = _batch(rng, jd, 2, 12)
    _, jmet = j_loss_fn(jm, None, jp, {k: jnp.asarray(v) for k, v in b.items()})
    _, tmet = t_loss_fn(tm, tp, {k: torch.from_numpy(v) for k, v in b.items()}, use_kernel=True)
    for k in ("loss", "ce", "load_balance_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, atol=1e-8, err_msg=k)


def test_upcycled_vlm_trains_with_its_embeds(capsys):
    """``--upcycle`` on llava keeps the vlm family, so the train CLI's
    batches carry the ``embeds`` stub (the moe family would drop it and
    train another function than JAX's)."""
    from repro_torch.launch.train import main as train_cli

    tr = train_cli(["--arch", "llava-next-34b", "--smoke", "--upcycle", "4", "--top-k", "2", "--cf", "-1",
                    "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert tr.cfg.family == "vlm" and tr.cfg.moe is not None
    batch = next(tr.data_iter)
    assert batch["embeds"].shape == (2, tr.cfg.num_prefix_embeds, tr.cfg.d_model)
    assert tr.state.step == 2 and np.isfinite(tr.history[-1]["loss"])
    assert "final held-out CE" in capsys.readouterr().out


def _pair(arch):
    """(JAX, port) fp32 smoke configs of ``arch``."""
    j = JC.smoke_config(JC.get_config(arch)).replace(dtype="float32")
    t = TC.smoke_config(TC.get_config(arch)).replace(dtype="float32")
    return j, t


def _batch(rng, cfg, B, S):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        out["embeds"] = (rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((B, 24, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_entry_points_match_jax(rng, arch):
    """forward (logits over text positions only), loss_fn (ce and aux),
    a bucketed prefill (valid_len) and two decode steps against the JAX
    package, fp32, the port's kernel path (the kernels' plain versions on
    the CPU) against the JAX plain path."""
    jcfg, tcfg = _pair(arch)
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    b = _batch(rng, jcfg, 2, 12)
    jb, tb = ({k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()})
    jl, jaux = j_forward(jcfg, None, jp, jb)
    tl, taux = t_forward(tcfg, tp, tb, use_kernel=True)
    assert tuple(tl.shape) == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    jloss, jm = j_loss_fn(jcfg, None, jp, jb)
    tloss, tm = t_loss_fn(tcfg, tp, tb, use_kernel=True)
    for k in ("loss", "ce", "load_balance_loss", "z_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-8, err_msg=k)

    # bucketed prefill of an 11-token prompt in a 16 bucket, then two decode steps
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = b["tokens"][0, :11]
    vl = np.array([11], np.int32)
    pb = {"tokens": toks}
    if jcfg.family == "vlm":
        pb["embeds"] = b["embeds"][:1]
    P = jcfg.num_prefix_embeds
    jl, jc = j_prefill(jcfg, None, jp, {k: jnp.asarray(v) for k, v in pb.items()}, cache_len=P + 24,
                       valid_len=jnp.asarray(vl))
    tl, tc = t_prefill(tcfg, tp, {k: torch.from_numpy(v) for k, v in pb.items()}, cache_len=P + 24,
                       use_kernel=True, valid_len=torch.from_numpy(vl))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["pos"][0]) == P + 11
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, 1).astype(np.int32)
        jl, jc = j_decode(jcfg, None, jp, jc, jnp.asarray(tok))
        tl, tc = t_decode(tcfg, tp, tc, torch.from_numpy(tok), use_kernel=True)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)


def test_family_features_reach_the_params():
    """The features each new architecture exercises are in its smoke
    config's parameters: tied embeddings, QKV bias, LayerNorm's bias, the
    128-expert configs' dense residual."""
    from repro_torch.models.model import model_decl

    decl = {a: model_decl(TC.smoke_config(TC.get_config(a))) for a in NEW_ARCHS}
    assert "unembedding" not in decl["llama3.2-3b"]["embed"] and "unembedding" in decl["qwen3-moe-30b-a3b"]["embed"]
    assert "bq" in decl["qwen2.5-14b"]["stack"]["slot0"]["mixer"]
    assert "bias" in decl["stablelm-1.6b"]["stack"]["slot0"]["norm1"]
    assert "dense_residual" in decl["arctic-480b"]["stack"]["slot0"]["ffn"]
    assert "dense_residual" not in decl["qwen3-moe-30b-a3b"]["stack"]["slot0"]["ffn"]


@pytest.mark.parametrize("dispatcher,cf", [("sorted", None), ("allgather", 1.0), ("allgather", 2.0)])
def test_top8_forward_and_grads_match_jax(rng, dispatcher, cf):
    """An explicit 16-expert top-8 config (smoke_config caps top-k at 2):
    logits and the router's and experts' gradients through the sorted and
    padded dispatchers, whose per-token sums now have 8 addends (the
    order-fixed combine). Gradients within 1e-4 of max|g| per parameter."""
    jcfg, tcfg = configs(moe_kw=dict(num_experts=16, top_k=8, capacity_factor=cf, dispatcher=dispatcher))
    jp = jax_params(jcfg)
    tp = to_torch(jp)
    b = _batch(rng, jcfg, 2, 16)
    jb, tb = ({k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()})
    jl, _ = j_forward(jcfg, None, jp, jb)
    tl, _ = t_forward(tcfg, tp, tb, use_kernel=True)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=FP32_ATOL)
    jg = jax.grad(lambda p: j_loss_fn(jcfg, None, p, jb)[0])(jp)
    leaves = {k: v for k, v in tp["stack"]["slot0"]["ffn"].items()}
    named = [("router", leaves["router"]["w_g"])] + [(k, leaves["experts"][k]) for k in ("w_gate", "w_down")]
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = t_loss_fn(tcfg, tp, tb, use_kernel=True)
    tg = torch.autograd.grad(loss, [t for _, t in named])
    jf = jg["stack"]["slot0"]["ffn"]
    for (name, _), g, ref in zip(named, tg, (jf["router"]["w_g"], jf["experts"]["w_gate"], jf["experts"]["w_down"])):
        ref = f32(ref)
        assert float(np.abs(f32(g) - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name


def test_vlm_on_the_clis(capsys):
    """The train CLI feeds a vlm its ``embeds`` stub; the serve CLI serves
    its text path."""
    from repro_torch.launch.serve import main as serve_cli
    from repro_torch.launch.train import main as train_cli

    tr = train_cli(["--arch", "llava-next-34b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu"])
    assert tr.state.step == 2 and np.isfinite(tr.history[-1]["loss"])
    out = serve_cli(["--arch", "llava-next-34b", "--smoke", "--requests", "2", "--max-new", "3", "--use-kernel",
                     "--device", "cpu"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert "final held-out CE" in capsys.readouterr().out
