"""Port parity for the training slice: ``cross_entropy``, ``loss_fn``
values and gradients (dense and MoE, plain and kernel paths, remat on and
off), the port's ``Trainer`` against the JAX ``Trainer`` started from one
state (``train_state_from_numpy``), the in-step guard, and the training CLI.

Tolerances (fp32 configs): losses and aux losses 1e-5 relative (the same
fp32 arithmetic, other summation order); gradients ``GRAD_TOL`` of max
|ref| per parameter, except in ``test_loss_fn_value_and_grads_match_jax``:
there the tiny random model's attention logits span ~150, so the softmax
turns the fp32 rounding of q and k (2**-24 relative, ~1e-5 absolute in a
logit) into gradient errors of up to ~1.5e-4 of max|g| in either package,
depending on the batch. That test measures the conditioning instead: both
fp32 gradients are held against the port's graph evaluated in fp64
(``torch_parity.Float64``) and against the spread that fp32-sized noise
gives that graph. Adam amplifies differences where |g| is near eps:
its update m / (sqrt(v) + eps) is O(lr) whatever |g| is, and a gradient
element that is a cancelling sum (an embedding element of 5.8e-7 from
terms of ~0.1, clipped 20x to ~3e-8) carries a large relative rounding
error. So after the first update the grad norm may differ by
``GNORM_RTOL`` and the params after 3 steps at lr 1e-3 by ``PARAM_ATOL``
(half of one step at the peak lr; the CPU measures 1.9e-4), with at most
1% of the elements more than 1e-5 apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import Float64, configs, f32, jax_params, to_torch

from repro.config import TrainConfig as JTrainConfig
from repro.data.pipeline import make_train_iter as j_make_train_iter
from repro.models.layers import cross_entropy as j_ce
from repro.models.model import loss_fn as j_loss_fn
from repro.train.callbacks import LoggingCallback as JLogging
from repro.train.state import state_to_tree as j_state_to_tree
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.launch.train import main as train_cli
from repro_torch.models.layers import cross_entropy as t_ce
from repro_torch.models.model import loss_fn as t_loss_fn
from repro_torch.optim import adamw_init
from repro_torch.params import train_state_from_numpy, tree_leaves, tree_map
from repro_torch.resilience import HangError
from repro_torch.train.callbacks import EvalCallback
from repro_torch.train.callbacks import LoggingCallback as TLogging
from repro_torch.train.state import state_to_tree, tree_to_state
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.train.trainer import make_train_step

GRAD_TOL = 1e-4
GNORM_RTOL = 2e-4
PARAM_ATOL = 5e-4
METRICS = ("loss", "ce", "load_balance_loss", "z_loss", "lr", "grad_norm")


def test_cross_entropy_matches_jax(rng):
    logits = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)  # padded vocab 50..63 never a label
    j = j_ce(jnp.asarray(logits), jnp.asarray(labels), 50)
    jg = jax.grad(lambda x: j_ce(x, jnp.asarray(labels), 50))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    t = t_ce(x, torch.from_numpy(labels), 50)
    t.backward()
    np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-6)
    np.testing.assert_allclose(f32(x.grad), f32(jg), atol=1e-7)


def _batch(cfg, rng, B=2, S=16):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_grads(jcfg, jp, batch, use_kernel):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, met), g = jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, None, p, jb, None, use_kernel), has_aux=True)(jp)
    return met, g


def _torch_grads(tcfg, tp, batch, use_kernel):
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, met = t_loss_fn(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, None, use_kernel)
    return met, torch.autograd.grad(loss, leaves)


NOISE_DRAWS = 3  # fp32-noise draws of the fp64 graph that measure its conditioning
PORT_VS_JAX = 1.5  # the port's fp32 error may be 1.5x JAX's, plus 1.5x the measured noise
JAX_VS_NOISE = 10.0  # JAX's fp32 error within 10x the measured noise (seen: up to 6.2x)
REL_FLOOR = 1e-6  # of max|g|: 16 fp32 ulps, for leaves whose errors all round to 0


@functools.lru_cache(maxsize=None)
def _fp64_side(moe: bool, seed: int):
    """The port's loss graph in fp64 on seed ``seed``'s batch: (grads,
    per-leaf noise) as numpy. The noise of a leaf is the largest max|g_noisy
    - g| / max|g| over ``NOISE_DRAWS`` evaluations with every fp64 result
    perturbed at fp32's rounding size (``Float64(noise=i)``)."""
    jcfg, tcfg = configs(moe=moe)
    jp, batch, tcfg = jax_params(jcfg), _batch(jcfg, np.random.default_rng(seed)), tcfg.replace(remat="none")

    def grads(noise=None):
        tp = tree_map(lambda t: t.double(), to_torch(jp))
        with Float64(noise):
            return [g.numpy() for g in _torch_grads(tcfg, tp, batch, False)[1]]

    g64 = grads()
    draws = [grads(i) for i in range(NOISE_DRAWS)]
    noise = [max(np.abs(d[i] - g).max() for d in draws) / np.abs(g).max() for i, g in enumerate(g64)]
    return g64, noise


LOSS_CASES = [(uk, moe, seed) for seed in (0, 15) for moe in (False, True) for uk in (False, True)]


@pytest.mark.parametrize("use_kernel,moe,seed", LOSS_CASES, ids=[
    f"{'kernel' if uk else 'plain'}-{'moe' if moe else 'dense'}{'' if seed == 0 else f'-seed{seed}'}"
    for uk, moe, seed in LOSS_CASES])
def test_loss_fn_value_and_grads_match_jax(use_kernel, moe, seed):
    """Loss values against JAX; gradients against the fp64 graph: per leaf,
    with e = max|g32 - g64| / max|g64|, e_port <= 1.5 e_jax + 1.5 noise +
    1e-6 and e_jax <= 10 noise + 1e-6 (the second ties the fp64 graph,
    which is the port's, to JAX)."""
    jcfg, tcfg = configs(moe=moe)
    jp = jax_params(jcfg)
    batch = _batch(jcfg, np.random.default_rng(seed))
    jm, jg = _jax_grads(jcfg, jp, batch, use_kernel)
    tm, tg = _torch_grads(tcfg, to_torch(jp), batch, use_kernel)
    assert sorted(tm) == sorted(jm) == ["ce", "load_balance_loss", "loss", "z_loss"]
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-8)
    g64, noise = _fp64_side(moe, seed)
    for a, b, c, n in zip(tg, jax.tree.leaves(jg), g64, noise):
        scale = np.abs(c).max()
        e_port, e_jax = np.abs(f32(a) - c).max() / scale, np.abs(f32(b) - c).max() / scale
        assert e_port <= PORT_VS_JAX * (e_jax + n) + REL_FLOOR, (a.shape, e_port, e_jax, n)
        assert e_jax <= JAX_VS_NOISE * n + REL_FLOOR, (a.shape, e_jax, n)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_remat_on_equals_remat_off(rng, use_kernel):
    jcfg, tcfg = configs(moe=True)
    jp = jax_params(jcfg)
    batch = _batch(jcfg, rng)
    out = {}
    for remat in ("none", "full"):
        out[remat] = _torch_grads(tcfg.replace(remat=remat), to_torch(jp), batch, use_kernel)
    for k in out["none"][0]:
        assert float(out["none"][0][k]) == float(out["full"][0][k])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


TRAIN_CASES = [  # (use_kernel, cfg.train_microbatches)
    (False, 1),
    (True, 1),
    (False, 2),
]


@pytest.mark.parametrize("use_kernel,micro", TRAIN_CASES, ids=["plain", "kernel", "plain-micro2"])
def test_trainer_matches_jax_trainer(use_kernel, micro):
    """Both Trainers from one state, 3 steps of the same batches in fp32:
    per-step metrics and the params after."""
    jcfg, tcfg = configs(moe=True, train_microbatches=micro)
    kw = dict(global_batch=4, seq_len=16, lr=1e-3, lr_min=1e-5, warmup_steps=2, total_steps=6, seed=7,
              log_every=1)
    jt = JTrainer(jcfg, JTrainConfig(**kw), params=jax_params(jcfg),
                  data_iter=j_make_train_iter(jcfg.vocab_size, 16, 4, seed=7), use_kernel=use_kernel)
    tree = jax.tree.map(np.array, j_state_to_tree(jt.state))
    tt = TTrainer(tcfg, TTrainConfig(**kw), state=train_state_from_numpy(tree, "cpu"),
                  data_iter=t_make_train_iter(tcfg.vocab_size, 16, 4, seed=7), use_kernel=use_kernel)
    jt.run(3, callbacks=[JLogging(log=lambda *a: None, log_every=1)])
    tt.run(3, callbacks=[TLogging(log=lambda *a: None, log_every=1)])
    assert [r["step"] for r in tt.history] == [r["step"] for r in jt.history] == [1, 2, 3]
    for a, b in zip(tt.history, jt.history):
        for k in METRICS:
            rtol = GNORM_RTOL if k == "grad_norm" and a["step"] > 1 else 1e-5
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-9, err_msg=f"{k} at step {a['step']}")
        assert a["skipped"] == b["skipped"] == 0.0
    assert tt.state.step == tt.opt_state.step == 3
    for a, b in zip(tree_leaves(tt.params), jax.tree.leaves(jt.params)):
        diff = np.abs(f32(a) - f32(b))
        assert diff.max() <= PARAM_ATOL and (diff > 1e-5).mean() <= 0.01, (a.shape, diff.max())


def _poison_embedding(tp, batch, value):
    tp["embed"]["embedding"].data[int(batch["tokens"][0, 0])] = value


def _poison_norm(tp, batch, value):
    tp["final_norm"]["scale"].data[0] = value


GUARD_CASES = {  # id: (poison, loss_ceiling); each trips the guard on its own
    "nan_grads": (lambda tp, b: _poison_embedding(tp, b, float("nan")), float("inf")),
    "ceiling": (None, 0.0),
    "inf_loss": (lambda tp, b: _poison_norm(tp, b, float("inf")), float("inf")),
}


def _bits(t):
    return t.detach().view(torch.int32 if t.dtype == torch.float32 else torch.int16).clone()


@pytest.mark.parametrize("guard", list(GUARD_CASES), ids=list(GUARD_CASES))
def test_guard_skips_the_update_cleanly(rng, guard):
    """A NaN embedding row of a batch token, an inf norm scale (non-finite
    loss and grads) or a ceiling below the loss skips the update: params
    bitwise untouched, optimizer clock frozen. Clean again, the step runs."""
    poison, ceiling = GUARD_CASES[guard]
    _, tcfg = configs(moe=True)
    tp = to_torch(jax_params(configs(moe=True)[0]))
    opt = adamw_init(tp)
    clean = [t.clone() for t in tree_leaves(tp)]
    step = make_train_step(tcfg, TTrainConfig(lr=1e-3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, rng).items()}
    if poison is not None:
        poison(tp, batch)
        assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), clean))
    before = [_bits(t) for t in tree_leaves(tp)]
    _, opt, met = step(tp, opt, batch, None, ceiling)
    assert float(met["skipped"]) == 1.0 and opt.step == 0
    assert poison is None or not np.isfinite(float(met["loss"]))
    assert all(torch.equal(_bits(a), b) for a, b in zip(tree_leaves(tp), before))
    with torch.no_grad():
        for a, b in zip(tree_leaves(tp), clean):
            a.copy_(b)
    _, opt, met = step(tp, opt, batch, None, float("inf"))
    assert float(met["skipped"]) == 0.0 and opt.step == 1


def test_step_timeout_raises_hang_error():
    _, tcfg = configs(moe=False)
    tr = TTrainer(tcfg, TTrainConfig(global_batch=2, seq_len=8), params=to_torch(jax_params(configs(moe=False)[0])),
                  data_iter=t_make_train_iter(tcfg.vocab_size, 8, 2), step_timeout_s=1e-9, device="cpu")
    with pytest.raises(HangError):
        tr.run(1, callbacks=[])


def test_eval_loss_and_eval_callback_match_jax():
    """Held-out CE on the blend's eval stream, same params in both
    packages; the callback records it every ``every`` steps."""
    jcfg, tcfg = configs(moe=True)
    jp = jax_params(jcfg)
    kw = dict(global_batch=2, seq_len=16, seed=5)
    jt = JTrainer(jcfg, JTrainConfig(**kw), params=jp)
    tt = TTrainer(tcfg, TTrainConfig(**kw), params=to_torch(jp), device="cpu",
                  data_iter=t_make_train_iter(tcfg.vocab_size, 16, 2, seed=5))
    np.testing.assert_allclose(tt.eval_loss(batches=2), jt.eval_loss(batches=2), rtol=1e-5)
    tt.run(2, callbacks=[EvalCallback(every=2, batches=1, log=lambda *a: None)])
    assert [r["step"] for r in tt.history] == [2] and np.isfinite(tt.history[0]["eval_ce"])


def test_state_tree_round_trip_keeps_bf16(rng):
    _, tcfg = configs(moe=True, fp32=False)
    tr = TTrainer(tcfg, TTrainConfig(seed=3), device="cpu", data_iter=t_make_train_iter(tcfg.vocab_size, 8, 2))
    tr.run(1, callbacks=[])
    back = tree_to_state(state_to_tree(tr.state), tcfg, "cpu")
    assert back.step == tr.state.step == 1 and back.opt_state.step == 1
    for a, b in zip(tree_leaves(back.params), tree_leaves(tr.params)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    for a, b in zip(tree_leaves(back.opt_state.m), tree_leaves(tr.opt_state.m)):
        assert torch.equal(a, b)
    assert torch.equal(back.gen.get_state(), tr.state.gen.get_state())


def test_train_cli_on_the_cpu(capsys):
    tr = train_cli(["--arch", "llama3-8b", "--smoke", "--upcycle", "4", "--top-k", "2", "--cf", "-1",
                    "--dispatcher", "sorted", "--use-kernel", "--steps", "2", "--batch", "2", "--seq", "32",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training llama3-8b-e4t2" in out and "step     1 loss" in out and "final held-out CE" in out
    assert tr.state.step == 2 and tr.opt_state.step == 2
    assert np.isfinite(tr.history[0]["loss"])


def test_train_cli_defaults_to_the_card_and_autotunes_on_request(tmp_path, monkeypatch):
    """The card is the default device; ``--autotune --device cpu`` trains one
    step and resolves its tiles through the tuner (the checkpoint flags:
    ``tests/test_torch_checkpoint.py``)."""
    from repro_torch.kernels import autotune

    argv = ["--arch", "llama3-8b", "--smoke", "--steps", "1", "--batch", "2", "--seq", "16"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli(argv)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tiles.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")  # teardown removes what the CLI sets
    autotune.reset()
    tr = train_cli(argv + ["--upcycle", "4", "--top-k", "2", "--cf", "-1", "--use-kernel", "--autotune",
                           "--device", "cpu"])
    assert tr.state.step == 1 and np.isfinite(tr.history[0]["loss"])
    assert autotune.enabled() and autotune.stats()["misses"] >= 1
    autotune.reset()
