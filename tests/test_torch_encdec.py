"""Port parity for the encoder-decoder family (seamless-m4t-medium): the
smoke config's forward, loss and gradients with stub ``frames``, a prefill
whose ring cache holds each decoder layer's cross k/v, decode steps
against it, ``prefill_reference``, a train-CLI step, and the serving
engine's refusal (the JAX engine cannot serve encdec: its prefill reads
``batch["frames"]``, which the engine never passes).

Tolerances. The random-weight smoke stack (LayerNorm, d_ff 512) grows
the decoder's residual stream to ~10^2 and its encoder's output feeds
every layer's cross-attention, so the same fp32 arithmetic in another
summation order parts by ~1e-4 to ~2e-3 of max|logits| on most batches;
``ENC_REL`` = 5e-3 of max|ref| holds the prefill and decode logits and
cache leaves (a wrong wiring parts by O(1)). On some batches fp32
rounding alone moves the logits by ~1e-2 and the encoder's attention
gradients by several percent of max|g| (the port's and JAX's alike,
against the fp64 graph), so the training forward's logits, loss metrics
and gradients are held against the port's graph in fp64 with the measured
spread of fp32 rounding (``torch_parity.check_grads_fp64``'s rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import Float64, check_grads_fp64, f32, jax_params, named, to_torch

import repro.config as JC
import repro_torch.config as TC
from repro.models.model import decode_step as j_decode
from repro.models.model import forward as j_forward
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill_forward as j_prefill
from repro_torch.models.model import decode_step as t_decode
from repro_torch.models.model import forward as t_forward
from repro_torch.models.model import prefill_forward as t_prefill
from repro_torch.models.model import prefill_reference as t_prefill_ref
from repro_torch.params import tree_leaves, tree_map

ARCH = "seamless-m4t-medium"
ENC_REL = 5e-3
_CACHE = {}


def _params():
    if not _CACHE:
        j = JC.smoke_config(JC.get_config(ARCH)).replace(dtype="float32")
        t = TC.smoke_config(TC.get_config(ARCH)).replace(dtype="float32")
        jp = jax_params(j)
        _CACHE.update(j=j, t=t, jp=jp, tp=to_torch(jp))
    return _CACHE["j"], _CACHE["t"], _CACHE["jp"], _CACHE["tp"]


def _rel(out, ref, rel=ENC_REL):
    out, ref = f32(out), f32(ref)
    assert float(np.abs(out - ref).max()) <= rel * float(np.abs(ref).max())


def _batch(rng, cfg, B=2, S=16, Se=24):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "frames": (rng.standard_normal((B, Se, cfg.d_model)) * 0.02).astype(np.float32)}


def test_encdec_decl_matches_jax():
    """The encoder stack, its norm and each decoder slot's norm_cross and
    cross-attention are declared with the JAX package's keys and shapes."""
    from repro.models.model import model_decl as jd
    from repro_torch.models.model import model_decl as td

    j, t = JC.smoke_config(JC.get_config(ARCH)), TC.smoke_config(TC.get_config(ARCH))
    jdecl, tdecl = jd(j), td(t)
    assert set(jdecl) == set(tdecl) == {"embed", "stack", "final_norm", "encoder", "encoder_norm"}
    assert set(tdecl["stack"]["slot0"]) == {"norm1", "mixer", "norm_cross", "cross", "norm2", "ffn"}
    jn, tn = named(jdecl), named(tdecl)
    assert sorted(jn) == sorted(tn)
    assert all(tuple(jn[k].shape) == tn[k].shape for k in jn)


def test_forward_loss_and_grads_match_jax():
    """Smoke seamless (2 encoder + 2 decoder layers, LayerNorm): logits over
    the text positions, the loss and every parameter's gradient, the
    encoder's included (the port's kernel path on the decoder, the plain
    encoder and cross-attention, as in JAX)."""
    j, t, jp, tp = _params()
    b = _batch(np.random.default_rng(2), j)
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}
    jl, _ = j_forward(j, None, jp, jb)
    tl, _ = t_forward(t, tp, tb, use_kernel=True)
    assert tuple(tl.shape) == (2, 16, t.padded_vocab)
    # logits by the gradients' rule: against the port's graph in fp64, with
    # the spread of fp32 rounding measured on it (this batch's fp32 logits,
    # either package's, sit up to ~1e-2 of max|logits| from the fp64 ones)
    plain = t.replace(remat="none")

    def logits64(noise=None):
        p64 = tree_map(lambda x: x.double().requires_grad_(True), tp)
        with Float64(noise):
            return t_forward(plain, p64, tb)[0].detach().numpy()

    l64 = logits64()
    scale = np.abs(l64).max()
    noise = max(np.abs(logits64(i) - l64).max() for i in range(3)) / scale
    e_port, e_jax = np.abs(f32(tl) - l64).max() / scale, np.abs(f32(jl) - l64).max() / scale
    assert e_port <= 1.5 * (e_jax + noise) + 1e-6 and e_jax <= 10 * noise + 1e-6, (e_port, e_jax, noise)
    (_, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(j, None, p, jb), has_aux=True))(jp)
    check_grads_fp64(t, tp, tb, jm, jg)


@pytest.mark.parametrize("bucket", [None, 16])
def test_prefill_and_decode_with_the_cross_cache(bucket):
    """Prefill an 11-token prompt (unpadded, or in a 16 bucket) over 24
    stub frames, then three decode steps: logits, ``slot_pos`` and the
    cross k/v (periods, B, Se, KV, hd) against the JAX package; the port's
    ``prefill_reference`` gives the same logits and cache."""
    j, t, jp, tp = _params()
    rng = np.random.default_rng(3)
    b = _batch(rng, j, B=1)
    toks = b["tokens"][:, :11] if bucket is None else np.pad(b["tokens"][:, :11], ((0, 0), (0, bucket - 11)))
    pb = {"tokens": toks, "frames": b["frames"]}
    kw = {} if bucket is None else {"valid_len": np.array([11], np.int32)}
    jl, jc = j_prefill(j, None, jp, {k: jnp.asarray(v) for k, v in pb.items()}, cache_len=32,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc = t_prefill(t, tp, {k: torch.from_numpy(v) for k, v in pb.items()}, cache_len=32, use_kernel=True,
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    _rel(tl, jl)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    cross = tc["stack"]["slot0"]["cross"]
    assert tuple(cross["k"].shape) == (t.num_layers, 1, 24, t.num_kv_heads, t.head_dim_)
    for k in ("k", "v"):
        _rel(cross[k], jc["stack"]["slot0"]["cross"][k])
    if bucket is None:
        rl, rc = t_prefill_ref(t, tp, {k: torch.from_numpy(v) for k, v in pb.items()}, cache_len=32)
        _rel(rl, tl)
        for a, r in zip(tree_leaves(rc["stack"]), tree_leaves(tc["stack"])):
            _rel(a, r)
    for _ in range(3):
        tok = rng.integers(0, j.vocab_size, 1).astype(np.int32)
        jl, jc = j_decode(j, None, jp, jc, jnp.asarray(tok))
        tl, tc = t_decode(t, tp, tc, torch.from_numpy(tok), use_kernel=True)
        _rel(tl, jl)


def test_train_cli_feeds_frames(capsys):
    """The train CLI gives an encdec batch its ``frames`` stub (B, seq,
    d_model), as the JAX launcher does, and trains through it."""
    from repro_torch.data.pipeline import make_train_iter, stub_inputs
    from repro_torch.launch.train import main as train_cli

    t = TC.smoke_config(TC.get_config(ARCH))
    assert stub_inputs(t, 2, 32) == {"frames": (2, 32, t.d_model)}
    batch = next(make_train_iter(t.vocab_size, 32, 2, extra=stub_inputs(t, 2, 32)))
    assert batch["frames"].shape == (2, 32, t.d_model)
    tr = train_cli(["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "32", "--use-kernel",
                    "--device", "cpu"])
    assert tr.state.step == 2 and np.isfinite(tr.history[-1]["loss"])
    assert "final held-out CE" in capsys.readouterr().out


def test_serving_engine_refuses_encdec():
    """The reference engine cannot serve encdec (``KeyError: 'frames'`` in
    its prefill); the port's engine says so with a ``ValueError``, on the
    serve CLI too, and the page pool refuses cross-attention stacks."""
    from repro_torch.launch.serve import main as serve_cli
    from repro_torch.models.model import paged_stack_decl
    from repro_torch.serving.engine import ServingEngine

    j, t, jp, tp = _params()
    with pytest.raises(ValueError, match="encdec"):
        ServingEngine(t, tp, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        serve_cli(["--arch", ARCH, "--smoke", "--requests", "1", "--max-new", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="GQA attention stacks only"):
        paged_stack_decl(t, 8, 16)
    from repro.serving.engine import Request, ServingEngine as JEngine

    with pytest.raises(KeyError, match="frames"):
        JEngine(j, jp, max_batch=1, max_seq=32).run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                                             max_new_tokens=2)])
