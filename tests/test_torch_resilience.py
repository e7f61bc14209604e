"""Port parity for the fault harness and the recovery paths
(``repro_torch.resilience``; the chaos suite ``tests/test_resilience.py``
case by case on the port's side). Where a case has a JAX counterpart on
the same inputs, the two must match: the injector's ``fired`` log, the
bytes a torn or bit-flipped shard leaves on disk, the supervisor's skips
and rollbacks, and the tokens served after ``alloc_fail``.

Every watchdog case injects a sleep of at least twice its budget; every
async save is joined before its files are read.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, jax_params, to_torch

from repro.checkpoint import CheckpointManager as JManager
from repro.resilience import FaultSpec as JFaultSpec
from repro.resilience import faults as jfaults
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_verified_step,
    list_steps,
    restore_tree,
    verified_steps,
    verify_checkpoint,
)
from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import make_train_iter
from repro_torch.resilience import (
    CheckpointCorruptionError,
    DataCorruptionError,
    FaultSpec,
    HangError,
    InjectedFault,
    ShardCorruptionError,
    ShedError,
    TrainingDivergedError,
    faults,
    retry_io,
)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.callbacks import AnomalySupervisor, CheckpointCallback
from repro_torch.train.state import state_to_tree
from repro_torch.train.trainer import Trainer

QUIET = lambda *a: None  # noqa: E731


def _jtree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "a": jnp.asarray(r.standard_normal((6, 4)), jnp.float32),
        "b": {"c": jnp.asarray(r.standard_normal(8), jnp.float32).astype(jnp.bfloat16), "step": jnp.int32(seed)},
    }


def _tree(seed=0):
    return to_torch(_jtree(seed))


def _bits(tree) -> dict:
    from repro_torch.checkpoint.sharded import flatten_tree

    out = {}
    for k, v in flatten_tree(tree).items():
        t = torch.as_tensor(v).detach().cpu()
        out[k] = (t.dtype, tuple(t.shape), (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return out


def _same(a, b) -> bool:
    return _bits(a) == _bits(b)


def _a_shard_file(ckpt_dir, step):
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    return os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0])


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


# -- the harness ----------------------------------------------------------------


def _drive(fire, inject, spec_cls, seed):
    with inject(spec_cls("site.x", "boom", at=1, count=2), spec_cls("site.y", "tick", at=1, every=3), seed=seed) as inj:
        hits = [bool(fire("site.x")) for _ in range(5)]
        ticks = [bool(fire("site.y")) for _ in range(7)]
        draw = int(inj.rng.integers(0, 1 << 30))
        return hits, ticks, list(inj.fired), inj.events("site.x"), draw


def test_injector_is_deterministic_scoped_and_matches_jax():
    got = _drive(faults.fire, faults.inject, FaultSpec, 7)
    assert got[0] == [False, True, True, False, False]
    assert got[1] == [False, True, False, False, True, False, False]
    assert got[2] == [("site.x", "boom", 1), ("site.x", "boom", 2), ("site.y", "tick", 1), ("site.y", "tick", 4)]
    assert got == _drive(jfaults.fire, jfaults.inject, JFaultSpec, 7)  # fired log, counts and payload rng
    with faults.inject(FaultSpec("site.x", "outer")) as outer:
        with faults.inject(FaultSpec("site.x", "inner")) as inner:
            assert faults.fire("site.x")[0].kind == "inner" and faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None and faults.fire("site.x") == []


def test_retry_io_backoff_and_exhaustion():
    sleeps, calls = [], {"n": 0}

    def flaky(fail_times):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise OSError("transient")
        return "ok"

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert retry_io(flaky, 2, attempts=3, sleep=sleeps.append) == "ok"
        assert calls["n"] == 3 and sleeps == [0.01, 0.02]
        calls["n"] = 0
        with pytest.raises(OSError):
            retry_io(flaky, 99, attempts=3, sleep=sleeps.append)
    with pytest.raises(ValueError):  # not retried
        retry_io(lambda: (_ for _ in ()).throw(ValueError("x")), sleep=sleeps.append)


@pytest.mark.parametrize("kind", ["truncate", "flip"])
def test_corruption_payloads_match_jax(tmp_path, kind):
    """``truncate_file`` and ``flip_bit`` leave the JAX package's bytes."""
    data = np.random.default_rng(3).integers(0, 255, 4096, dtype=np.uint8).tobytes()
    paths = [tmp_path / "port.bin", tmp_path / "jax.bin"]
    for p in paths:
        p.write_bytes(data)
    if kind == "truncate":
        faults.truncate_file(str(paths[0]), 0.3)
        jfaults.truncate_file(str(paths[1]), 0.3)
    else:
        offs = [faults.flip_bit(str(paths[0]), np.random.default_rng(11)),
                jfaults.flip_bit(str(paths[1]), np.random.default_rng(11))]
        assert offs[0] == offs[1]
    assert paths[0].read_bytes() == paths[1].read_bytes() != data


# -- checkpoint integrity ---------------------------------------------------------


def test_transient_write_fault_recovered_by_retry(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, async_save=False)
    with faults.inject(FaultSpec("ckpt.shard_write", "write_fail", at=1)) as inj:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m.save(_tree(1), 1)
    assert inj.fired == [("ckpt.shard_write", "write_fail", 1)]
    assert any("retrying" in str(x.message) for x in w)
    verify_checkpoint(os.path.join(d, "step_00000001"), deep=True)
    assert _same(restore_tree(d, device="cpu")[0], _tree(1))


def test_persistent_write_fault_is_loud_and_preserves_last_good(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, async_save=True)
    m.save(_tree(1), 1)
    m.wait()
    with faults.inject(FaultSpec("ckpt.shard_write", "write_fail", at=0, count=10_000)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.save(_tree(2), 2)
        with pytest.raises(InjectedFault):
            m.wait()  # the async writer's failure surfaces here
    assert list_steps(d) == [1]
    assert _same(restore_tree(d, device="cpu")[0], _tree(1))


@pytest.mark.parametrize("kind", ["torn", "bitflip"])
def test_corrupt_write_falls_back_to_newest_verified(tmp_path, kind):
    """Corruption injected at write time into every shard of step 2: the
    files left on disk are byte for byte the JAX package's under the same
    fault and seed, and restore lands on step 1 with a warning."""
    d, jd = str(tmp_path / "ck"), str(tmp_path / "jax")
    logs = []
    for mgr, inject, spec, tree in ((CheckpointManager(d, async_save=False), faults.inject, FaultSpec, _tree),
                                    (JManager(jd, async_save=False), jfaults.inject, JFaultSpec, _jtree)):
        mgr.save(tree(1), 1)
        with inject(spec("ckpt.shard_write", kind, at=0, count=10_000), seed=5) as inj:
            mgr.save(tree(2), 2)
        logs.append(inj.fired)
    assert logs[0] == logs[1] and logs[0]
    step2 = [os.path.join(x, "step_00000002") for x in (d, jd)]
    assert {k: v for k, v in _files(step2[0]).items() if k != "manifest.json"} == \
        {k: v for k, v in _files(step2[1]).items() if k != "manifest.json"}
    assert list_steps(d) == [1, 2] and latest_verified_step(d) == 1
    if kind == "bitflip":
        verify_checkpoint(step2[0], deep=False)  # the structural pass cannot see a flipped bit
    with pytest.raises(ShardCorruptionError):
        verify_checkpoint(step2[0], deep=True)
    m = CheckpointManager(d, async_save=False)
    with pytest.warns(UserWarning, match="skipping"):
        tree, manifest = m.restore(device="cpu")
    assert manifest["step"] == 1 and _same(tree, _tree(1)) and m.restore_fallbacks == 1


def test_posthoc_truncation_detected_structurally(tmp_path):
    d = str(tmp_path / "ck")
    CheckpointManager(d, async_save=False).save(_tree(1), 1)
    faults.truncate_file(_a_shard_file(d, 1), keep_fraction=0.2)
    with pytest.raises(ShardCorruptionError, match="torn write"):
        verify_checkpoint(os.path.join(d, "step_00000001"), deep=False)
    with pytest.raises(ShardCorruptionError):
        verify_checkpoint(os.path.join(d, "step_00000001"), deep=True)


def test_pinned_restore_never_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, async_save=False)
    m.save(_tree(1), 1)
    m.save(_tree(2), 2)
    faults.flip_bit(_a_shard_file(d, 2))
    with pytest.raises(CheckpointCorruptionError, match="step 2"):
        restore_tree(d, step=2, device="cpu")


def test_all_corrupt_raises_listing_every_step(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, async_save=False)
    m.save(_tree(1), 1)
    m.save(_tree(2), 2)
    for s in (1, 2):
        faults.flip_bit(_a_shard_file(d, s))
    with pytest.raises(CheckpointCorruptionError) as ei:
        restore_tree(d, device="cpu")
    assert "step 1" in str(ei.value) and "step 2" in str(ei.value)


def test_retention_counts_only_verified(tmp_path):
    d = str(tmp_path / "ck")
    m = CheckpointManager(d, keep_last=1, async_save=False)
    m.save(_tree(1), 1)
    with faults.inject(FaultSpec("ckpt.shard_write", "torn", at=0, count=10_000)):
        m.save(_tree(2), 2)  # committed, every shard torn
    assert list_steps(d) == [1, 2] and verified_steps(d, deep=True) == [1]
    with pytest.warns(UserWarning, match="skipping"):
        _, manifest = m.restore(device="cpu")
    assert manifest["step"] == 1
    m.save(_tree(3), 3)  # a new verified step supersedes both
    assert list_steps(d) == [3] and _same(restore_tree(d, device="cpu")[0], _tree(3))


def test_transient_read_fault_recovered_by_retry(tmp_path):
    d = str(tmp_path / "ck")
    CheckpointManager(d, async_save=False).save(_tree(1), 1)
    with faults.inject(FaultSpec("ckpt.shard_read", "read_fail", at=0)) as inj, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tree, _ = restore_tree(d, verify=False, device="cpu")
    assert inj.fired == [("ckpt.shard_read", "read_fail", 0)] and _same(tree, _tree(1))


# -- training anomaly supervision ---------------------------------------------------


def _tcfg():
    return TrainConfig(global_batch=4, seq_len=16, lr=3e-3, lr_min=3e-4, warmup_steps=5, total_steps=30,
                       log_every=1, seed=3)


def _trainer(**kw):
    _, cfg = configs(moe=False, fp32=False, num_layers=1)
    tcfg = _tcfg()
    it = make_train_iter(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, tcfg.blend_ratio, tcfg.seed)
    return Trainer(cfg, tcfg, data_iter=it, device="cpu", **kw)


def _jtrainer():
    from repro.config import TrainConfig as JTrainConfig
    from repro.data.pipeline import make_train_iter as j_make_train_iter
    from repro.train.trainer import Trainer as JTrainer

    jcfg, _ = configs(moe=False, fp32=False, num_layers=1)
    t = _tcfg()
    kw = {f: getattr(t, f) for f in ("global_batch", "seq_len", "lr", "lr_min", "warmup_steps", "total_steps",
                                     "log_every", "seed")}
    return JTrainer(jcfg, JTrainConfig(**kw), data_iter=j_make_train_iter(jcfg.vocab_size, 16, 4, 0.7, t.seed))


def test_nan_step_skipped_bitwise_clean():
    """An injected NaN-gradient step leaves params and optimizer state
    bitwise untouched and the optimizer clock still, and consumes its
    batch; the next clean step trains."""
    tr = _trainer()
    sup = AnomalySupervisor(rollback_after=100, log=QUIET)
    tr.run(2, callbacks=[sup])
    before = _bits(state_to_tree(tr.state))
    with faults.inject(FaultSpec("train.step", "nan_grads", at=0)) as inj:
        tr.run(1, callbacks=[sup])
    assert inj.fired == [("train.step", "nan_grads", 0)]
    after = _bits(state_to_tree(tr.state))
    assert {k: v for k, v in after.items() if k != "step"} == {k: v for k, v in before.items() if k != "step"}
    assert tr.state.step == 3 and tr.opt_state.step == 2
    assert sup.skips == 1 and sup.rollbacks == 0
    tr.run(1, callbacks=[sup])
    assert _bits(tr.params) != {k[len("params::"):]: v for k, v in after.items() if k.startswith("params::")}


def _spiked(tr, tmp, target):
    """10 iterations: 5 clean, 2 spiked and skipped (strikes 1, 2 ->
    rollback to the step-4 checkpoint), 3 replayed: the step lands at 7."""
    if isinstance(tr, Trainer):
        ckpt_cls, sup_cls, inject, spec = CheckpointCallback, AnomalySupervisor, faults.inject, FaultSpec
    else:
        from repro.train.callbacks import AnomalySupervisor as JSupervisor
        from repro.train.callbacks import CheckpointCallback as JCheckpointCallback

        ckpt_cls, sup_cls, inject, spec = JCheckpointCallback, JSupervisor, jfaults.inject, JFaultSpec
    ck = ckpt_cls(tmp, every=2, async_save=True)
    sup = sup_cls(ckpt=ck, rollback_after=2, warmup_steps=3, log=QUIET)
    with inject(spec("train.step", "loss_spike", at=5, count=2, args={"shift": 1e5})) as inj:
        tr.run(target, log=QUIET, callbacks=[ck, sup])
    return sup, ck, inj.fired


def test_spike_rollback_recovers_to_bitwise_parity(tmp_path):
    """Loss spikes past the strike limit roll the run back; it then ends
    bit for bit at the clean run's state. The skips and the rollback are
    the JAX supervisor's on the same schedule."""
    target = 10
    straight = _trainer()
    straight.run(target, callbacks=[])
    tr = _trainer()
    sup, ck, fired = _spiked(tr, str(tmp_path / "port"), target)
    assert len(fired) == 2 and sup.rollbacks == 1 and sup.skips == 2
    assert tr.state.step == 7
    tr.run(target - tr.state.step, callbacks=[ck, sup])
    assert _bits(state_to_tree(tr.state)) == _bits(state_to_tree(straight.state))
    jsup, _, jfired = _spiked(_jtrainer(), str(tmp_path / "jax"), target)
    key = lambda iv: {k: v for k, v in iv.items() if k != "loss"}  # noqa: E731
    assert jfired == fired and [key(i) for i in jsup.interventions] == [key(i) for i in sup.interventions]


def test_supervisor_diverged_without_checkpoint():
    tr = _trainer()
    sup = AnomalySupervisor(ckpt=None, rollback_after=2, log=QUIET)
    with faults.inject(FaultSpec("train.step", "nan_grads", at=0, count=10)), pytest.raises(TrainingDivergedError):
        tr.run(4, callbacks=[sup])


def test_train_hang_watchdog():
    tr = _trainer()
    tr.run(1, callbacks=[])
    tr.step_timeout_s = 60.0
    tr.run(1, callbacks=[])  # a generous budget passes
    tr.step_timeout_s = 0.1
    with faults.inject(FaultSpec("train.step", "hang", at=0, args={"seconds": 0.2})), \
            pytest.raises(HangError, match="wall"):
        tr.run(1, callbacks=[])


# -- data pipeline -------------------------------------------------------------------


def test_corrupt_batch_skipped_with_stream_parity():
    """The batch the ``data.batch`` site corrupts is dropped: the stream is
    the clean one without it, token for token the JAX pipeline's under the
    same fault."""
    from repro.data.pipeline import make_train_iter as j_make_train_iter

    clean = make_train_iter(256, 16, 4, seed=11)
    ref = [next(clean) for _ in range(4)]
    streams = []
    for make, inject, spec in ((make_train_iter, faults.inject, FaultSpec),
                               (j_make_train_iter, jfaults.inject, JFaultSpec)):
        it = make(256, 16, 4, seed=11)
        with inject(spec("data.batch", "corrupt_batch", at=1)) as inj, pytest.warns(UserWarning, match="corrupt"):
            streams.append(([next(it) for _ in range(3)], inj.fired, it.state()))
    (got, fired, state), (jgot, jfired, jstate) = streams
    assert fired == jfired == [("data.batch", "corrupt_batch", 1)] and state == jstate
    for g, jg, r in zip(got, jgot, (ref[0], ref[2], ref[3])):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
        np.testing.assert_array_equal(g["tokens"], jg["tokens"])
    assert state["skipped"] == [1]
    it2 = make_train_iter(256, 16, 4, seed=11).restore(state)
    assert it2.state()["skipped"] == [1]
    np.testing.assert_array_equal(next(it2)["tokens"], next(clean)["tokens"])


def test_corrupt_batch_budget_exhaustion_raises():
    it = make_train_iter(256, 16, 4, seed=11, skip_budget=2)
    with faults.inject(FaultSpec("data.batch", "corrupt_batch", at=0, count=100)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(DataCorruptionError, match="budget"):
            next(it)


def test_genuinely_bad_tokens_caught_without_injection():
    it = make_train_iter(256, 16, 4, seed=11, skip_budget=1)
    real = it._draw

    def poisoned():
        b = real()
        b["tokens"] = b["tokens"].copy()
        b["tokens"][0, 0] = -3
        return b

    it._draw = poisoned
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(DataCorruptionError):
            next(it)


# -- serving degradation -----------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_setup():
    jcfg, tcfg = configs(moe=False, num_layers=1, vocab_size=64)
    jp = jax_params(jcfg)
    return jcfg, jp, tcfg, to_torch(jp)


def _mk_reqs(cls, n, L=10, mnt=6, seed=7, vocab=64):
    r = np.random.default_rng(seed)
    return [cls(i, r.integers(1, vocab, size=L).astype(np.int32), max_new_tokens=mnt) for i in range(n)]


def test_admission_sheds_loudly_not_deadlocks(serve_setup):
    _, _, cfg, params = serve_setup
    eng = ServingEngine(cfg, params, cache_mode="paged", max_batch=2, max_seq=64, page_size=8, num_pages=8,
                        max_queue=2, shed_watermark=1, device="cpu")
    accepted, shed = [], []
    for r in _mk_reqs(Request, 5):
        try:
            eng.submit(r)
            accepted.append(r)
        except ShedError:
            shed.append(r.rid)
    assert shed and eng.sched.shed_count == len(shed)
    for _ in range(200):
        if not eng.sched.has_work:
            break
        eng.step()
    assert all(len(r.output) == r.max_new_tokens for r in accepted)
    h = eng.health()
    assert h["shed_count"] == len(shed) and h["resident_pages"] == 0


def test_pool_exhaustion_alloc_faults_recover_with_parity(serve_setup):
    """Transient ``alloc_fail`` at the ``serving.alloc`` site stalls a
    request a step; the tokens equal the clean run's and the JAX engine's
    under the same fault, and the two injectors fire alike."""
    jcfg, jp, cfg, params = serve_setup
    out = {}
    for label, eng, inject, spec, req in (
            ("clean", ServingEngine(cfg, params, cache_mode="paged", max_batch=2, max_seq=64, page_size=8,
                                    device="cpu"), faults.inject, None, Request),
            ("faulty", ServingEngine(cfg, params, cache_mode="paged", max_batch=2, max_seq=64, page_size=8,
                                     device="cpu"), faults.inject, FaultSpec, Request),
            ("jax", JEngine(jcfg, jp, cache_mode="paged", max_batch=2, max_seq=64, page_size=8), jfaults.inject,
             JFaultSpec, JRequest)):
        specs = [spec("serving.alloc", "alloc_fail", at=1, count=3)] if spec else []
        with inject(*specs) as inj:
            out[label] = (eng.run(_mk_reqs(req, 3), max_steps=300), list(inj.fired))
    assert out["faulty"][1] == out["jax"][1] and len(out["faulty"][1]) == 3
    assert out["clean"][0] == out["faulty"][0] == out["jax"][0]


def test_deadline_eviction_reclaims_pages(serve_setup):
    _, _, cfg, params = serve_setup
    eng = ServingEngine(cfg, params, cache_mode="paged", max_batch=2, max_seq=64, page_size=8, deadline_steps=4,
                        device="cpu")
    reqs = _mk_reqs(Request, 2, mnt=40) + _mk_reqs(Request, 1, mnt=4, seed=9)
    reqs[2].rid, reqs[2].deadline_steps = 2, 1000
    out = eng.run(reqs, max_steps=300)
    assert reqs[0].status == reqs[1].status == "deadline"
    assert reqs[2].status == "ok" and len(out[2]) == 4
    h = eng.health()
    assert h["deadline_evictions"] == 2 and h["resident_pages"] == 0 and h["free_pages"] == h["num_pages"]


def test_serving_hang_watchdog(serve_setup):
    _, _, cfg, params = serve_setup
    eng = ServingEngine(cfg, params, cache_mode="paged", max_batch=2, max_seq=64, page_size=8,
                        step_timeout_s=60.0, device="cpu")
    eng.submit(_mk_reqs(Request, 1)[0])
    eng.step()
    eng.step()
    eng.step_timeout_s = 0.1
    with faults.inject(FaultSpec("serving.step", "hang", at=0, args={"seconds": 0.2})), \
            pytest.raises(HangError, match="wall"):
        eng.step()


def test_ring_mode_rejects_paged_only_knobs(serve_setup):
    _, _, cfg, params = serve_setup
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, cache_mode="ring", deadline_steps=5, device="cpu")
