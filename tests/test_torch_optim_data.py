"""Port parity for the optimizer, the LR schedule and the data pipeline:
``cosine_schedule``, ``adamw_init``/``adamw_update`` against
``repro.optim``, and the port's copy of ``repro.data.pipeline``
(byte-identical batches, ``state``/``restore``, corrupt-batch skipping).

Tolerances: the schedule is computed in fp32 on both sides with the same
operations (rtol 1e-7, one fp32 ulp). AdamW in fp32: 1e-6 relative (XLA may
fuse the moment updates into FMAs where torch rounds each op); with bf16
params the new params are the fp32 master cast once, so they may differ by
one bf16 ulp where the masters straddle a rounding boundary.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32

from repro.config import TrainConfig as JTrainConfig
from repro.data.pipeline import make_train_iter as j_make_train_iter
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine
from repro.resilience import faults
from repro.resilience.faults import FaultSpec
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.optim import adamw_update as t_adamw_update
from repro_torch.optim import cosine_schedule as t_cosine
from repro_torch.optim import adamw as t_adamw
from repro_torch.resilience import DataCorruptionError


@pytest.mark.parametrize("step", [0, 1, 4, 9, 10, 11, 55, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    kw = dict(lr=3e-4, lr_min=3e-6, warmup_steps=10, total_steps=100)
    j = float(j_cosine(step, **kw))
    t = float(t_cosine(step, **kw))
    np.testing.assert_allclose(t, j, rtol=1e-7)
    if step == 0:
        assert t > 0  # 1-indexed warmup: the first update already moves


def _tree(rng):
    shapes = {"w": (6, 5), "stack": {"e": (2, 4, 3), "scale": (5,)}, "bias": (3,)}
    mk = lambda s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    params = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    return params, grads


def _torch_tree(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clip_on", "clip_off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(rng, clip, dtype):
    """Three AdamW updates from one state; the grads' global norm is ~4, so
    grad_clip 0.5 clips every step and 1e9 never does."""
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jcfg, tcfg = JTrainConfig(**cfg_kw), TTrainConfig(**cfg_kw)
    params, grads = _tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = _torch_tree(params, tdt)
    js, ts = j_adamw_init(jp), t_adamw_init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1) / 3
        jp, js = j_adamw_update(jcfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js, jnp.float32(lr))
        tp, ts = t_adamw_update(tcfg, _torch_tree(g, tdt), ts, torch.tensor(lr, dtype=torch.float32), tp)
    assert ts.step == int(js.step) == 3
    for name in ("master", "m", "v"):
        for a, b in zip(jax.tree.leaves(getattr(ts, name)), jax.tree.leaves(getattr(js, name))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(f32(a), f32(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == tdt
        ulp = 1e-6 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(f32(a), f32(b), rtol=ulp, atol=1e-7)


def test_adamw_chunks_give_the_same_update(rng, monkeypatch):
    """The chunked in-place update equals the unchunked one up to fp32
    rounding (the chunked sum of squares adds in another order, and a
    vectorised loop's tail is computed by scalar code)."""
    params, grads = _tree(rng)
    cfg = TTrainConfig(lr=1e-2, grad_clip=0.5)
    out = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(t_adamw, "CHUNK", chunk)
        tp = _torch_tree(params, torch.float32)
        ts = t_adamw_init(tp)
        for g in grads:
            t_adamw_update(cfg, _torch_tree(g, torch.float32), ts, 1e-2, tp)
        out.append(jax.tree.leaves(tp))
    for a, b in zip(*out):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_data_batches_byte_identical(seed):
    j = j_make_train_iter(256, 16, 4, seed=seed)
    t = t_make_train_iter(256, 16, 4, seed=seed)
    for _ in range(4):
        a, b = next(j), next(t)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_data_state_restore_and_cross_package_resume():
    t = t_make_train_iter(256, 16, 4, seed=5)
    j = j_make_train_iter(256, 16, 4, seed=5)
    for _ in range(3):
        next(t), next(j)
    st = t.state()
    assert st == j.state()
    want = [next(t)["tokens"].tobytes() for _ in range(2)]
    again = t_make_train_iter(256, 16, 4, seed=5).restore(st)
    assert [next(again)["tokens"].tobytes() for _ in range(2)] == want
    from_jax = t_make_train_iter(256, 16, 4, seed=5).restore(j.state())
    assert [next(from_jax)["tokens"].tobytes() for _ in range(2)] == want


def _corrupt_at(it, index):
    """Make the port's iterator draw a bad token id at batch ``index``, the
    same corruption the JAX ``data.batch`` fault site injects."""
    draw = it._draw

    def bad():
        b = draw()
        if it._batches == index:
            b = dict(b)
            b["tokens"] = b["tokens"].copy()
            b["tokens"].flat[0] = it.ds.vocab_size + 7
        return b
    it._draw = bad


def test_corrupt_batch_skipped_like_jax():
    j = j_make_train_iter(256, 16, 4, seed=11)
    t = t_make_train_iter(256, 16, 4, seed=11)
    _corrupt_at(t, 1)
    with faults.inject(FaultSpec("data.batch", "corrupt_batch", at=1)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = [next(j) for _ in range(3)]
        with pytest.warns(UserWarning, match="corrupt"):
            tb = [next(t) for _ in range(3)]
    for a, b in zip(jb, tb):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
    assert t.state()["skipped"] == j.state()["skipped"] == [1]
    resumed = t_make_train_iter(256, 16, 4, seed=11).restore(t.state())
    assert resumed.state()["skipped"] == [1]
    assert next(resumed)["tokens"].tobytes() == next(j)["tokens"].tobytes()


def test_corrupt_batch_budget_exhaustion_raises():
    t = t_make_train_iter(256, 16, 4, seed=11, skip_budget=2)
    t._validate = lambda b: "forced"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(DataCorruptionError, match="skip budget of 2"):
            next(t)
    assert t.state()["skipped"] == [0, 1, 2]


def test_train_config_fields_match_jax():
    assert dataclasses.asdict(TTrainConfig()) == dataclasses.asdict(JTrainConfig())
