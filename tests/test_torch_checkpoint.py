"""Port parity for checkpointing (``repro_torch.checkpoint``,
``train/state.py``, ``CheckpointCallback`` and the train CLI's checkpoint
flags) against ``repro.checkpoint``.

Checkpoints cross between the packages bit for bit, both ways, bf16 and
0-d scalars included, and the port writes the JAX package's manifest and
bytes for the same tree (only ``meta.wall_time`` differs). Within the port,
k steps + save + restore + n steps equal k + n straight steps bit for bit
on the CPU. A JAX full-state checkpoint resumed in the port follows the
JAX run within ``test_torch_train``'s train tolerances (``PARAM_ATOL`` of
the params after the steps, at most 1% of the elements more than 1e-5
apart), since the two packages' steps differ in summation order.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, f32, jax_params, to_torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import restore_tree as j_restore_tree
from repro.checkpoint import save_checkpoint as j_save
from repro.checkpoint import upcycle_on_load as j_upcycle_on_load
from repro.config import MoEConfig as JMoEConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core.upcycle import upcycle_config as j_upcycle_config
from repro.core.upcycle import upcycle_provenance as j_provenance
from repro.data.pipeline import make_train_iter as j_make_train_iter
from repro.sharding.rules import spec_to_json as j_spec_to_json
from repro.train.callbacks import CheckpointCallback as JCheckpointCallback
from repro.train.state import restore_train_state as j_restore_train_state
from repro.train.state import state_to_tree as j_state_to_tree
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    list_steps,
    load_checkpoint,
    restore_tree,
    save_checkpoint,
    upcycle_on_load,
)
from repro_torch.checkpoint.sharded import flatten_tree, spec_from_json, spec_to_json
from repro_torch.config import MoEConfig as TMoEConfig
from repro_torch.config import TrainConfig as TTrainConfig
from repro_torch.core.upcycle import upcycle_config, upcycle_provenance
from repro_torch.data.pipeline import make_train_iter as t_make_train_iter
from repro_torch.launch.train import main as train_cli
from repro_torch.resilience import DataCorruptionError, FaultSpec, faults
from repro_torch.train.callbacks import AnomalySupervisor, CheckpointCallback, LoggingCallback
from repro_torch.train.state import restore_train_state, rng_words, state_to_tree
from repro_torch.train.trainer import Trainer

PARAM_ATOL = 5e-4  # test_torch_train.PARAM_ATOL
QUIET = lambda *a: None  # noqa: E731
KW = dict(global_batch=4, seq_len=16, lr=1e-3, lr_min=1e-5, warmup_steps=2, total_steps=8, seed=7, log_every=1)


def _bits(x):
    """(dtype name, shape, bytes) of a torch tensor, JAX array or numpy
    array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_same(t1, t2, skip=()):
    f1 = {k: v for k, v in flatten_tree(t1).items() if k not in skip}
    f2 = {k: v for k, v in flatten_tree(t2).items() if k not in skip}
    assert sorted(f1) == sorted(f2)
    for k in f1:
        assert _bits(f1[k]) == _bits(f2[k]), k


def _jtree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "a": jnp.asarray(r.standard_normal((6, 4)), jnp.float32),
        "b": {"c": jnp.asarray(r.standard_normal(8), jnp.float32).astype(jnp.bfloat16), "step": jnp.int32(5)},
        "rng": jax.random.PRNGKey(seed),
    }


def _ttree(seed=0):
    return to_torch(_jtree(seed))


def _dir_files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d)) if n != "manifest.json"}


def _manifest(d):
    m = json.load(open(os.path.join(d, "manifest.json")))
    m["meta"].pop("wall_time", None)
    return m


# -- trees cross between the packages bit for bit ----------------------------


@pytest.mark.parametrize("layout", ["flat", "manager"])
def test_jax_tree_loads_into_port_bitwise(tmp_path, layout):
    jt = _jtree(1)
    if layout == "flat":
        j_save(str(tmp_path), jt, step=3)
        got = load_checkpoint(str(tmp_path), device="cpu")
    else:
        JManager(str(tmp_path), async_save=False).save(jt, 3)
        got, manifest = restore_tree(str(tmp_path), device="cpu")
        assert manifest["step"] == 3
    _assert_same(got, jt)
    assert got["b"]["c"].dtype == torch.bfloat16 and got["b"]["step"].shape == ()


@pytest.mark.parametrize("layout", ["flat", "manager"])
def test_port_tree_loads_into_jax_bitwise(tmp_path, layout):
    tt = _ttree(2)
    if layout == "flat":
        save_checkpoint(str(tmp_path), tt, step=4)
        got = j_load(str(tmp_path))
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(tt, 4)
        got, manifest = j_restore_tree(str(tmp_path))
        assert manifest["step"] == 4
    _assert_same(got, tt)
    assert got["b"]["c"].dtype == jnp.bfloat16


@pytest.mark.parametrize("layout", ["flat", "manager"])
def test_manifest_and_bytes_equal_jax(tmp_path, layout):
    """Same tree, same step and meta: the same file names and bytes, and
    the same manifest (with its CRC32s) apart from ``meta.wall_time``."""
    meta = {"arch": "tiny", "wall_time": 1.0}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    if layout == "flat":
        j_save(jd, _jtree(3), step=7, meta=meta)
        save_checkpoint(td, _ttree(3), step=7, meta=dict(meta, wall_time=2.0))
    else:
        for mgr, tree, m in ((JManager(jd), _jtree(3), meta), (CheckpointManager(td), _ttree(3), dict(meta, wall_time=2.0))):
            mgr.save(tree, 7, m)
            mgr.wait()
        jd, td = os.path.join(jd, "step_00000007"), os.path.join(td, "step_00000007")
    assert _manifest(td) == _manifest(jd)
    assert _dir_files(td) == _dir_files(jd)
    assert all("crc32" in s for e in _manifest(td)["leaves"].values() for s in e["shards"])


def test_format1_checkpoint_loads(tmp_path):
    """Format-1 manifests (one whole-array .npy per leaf, bf16 as a uint16
    view) load in both packages alike."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    e = np.asarray(jnp.asarray(np.ones(8, np.float32) * 1.5).astype(jnp.bfloat16))
    np.save(tmp_path / "layer__w.npy", w)
    np.save(tmp_path / "layer__e.npy", e.view(np.uint16))
    (tmp_path / "manifest.json").write_text(json.dumps({"step": 7, "meta": {}, "leaves": {
        "layer::w": {"file": "layer__w.npy", "dtype": "float32"},
        "layer::e": {"file": "layer__e.npy", "dtype": "bfloat16"},
    }}))
    got = load_checkpoint(str(tmp_path), device="cpu")
    assert got["layer"]["e"].dtype == torch.bfloat16
    _assert_same(got, j_load(str(tmp_path)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_shard_leaf_reassembles(tmp_path, dtype):
    """A leaf stored as several shard files (as the JAX package saves one
    under a mesh, with its spec) is reassembled by the port as by the JAX
    loader."""
    from repro_torch.checkpoint.sharded import write_leaf, write_manifest

    a = np.asarray(jnp.asarray(np.random.default_rng(5).standard_normal((6, 4)), dtype))
    stored = a.view(np.uint16) if dtype == "bfloat16" else a
    entry = {"dtype": dtype, "shape": [6, 4], "spec": ["expert", None]}
    leaf = write_leaf(str(tmp_path), "w", entry, [([[0, 3], [0, 4]], stored[:3]), ([[3, 6], [0, 4]], stored[3:])])
    write_manifest(str(tmp_path), 1, {"w": leaf})
    assert [r["file"] for r in leaf["shards"]] == ["w__s0.npy", "w__s1.npy"]
    got, ref = load_checkpoint(str(tmp_path), device="cpu")["w"], j_load(str(tmp_path))["w"]
    assert _bits(got) == _bits(ref) == _bits(a)


def test_spec_json_matches_jax():
    from jax.sharding import PartitionSpec as P

    spec = P("expert", None, ("data", "model"))
    assert spec_to_json(tuple(spec)) == j_spec_to_json(spec)
    assert spec_from_json(j_spec_to_json(spec)) == tuple(spec)
    assert spec_to_json(None) is None and spec_from_json(None) is None


# -- full train state ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer (fp32 MoE) that checkpointed its full state at step 2,
    and its continuation to step 4."""
    jcfg, tcfg = configs(moe=True)
    d = str(tmp_path_factory.mktemp("jax_full"))
    jt = JTrainer(jcfg, JTrainConfig(**KW), params=jax_params(jcfg),
                  data_iter=j_make_train_iter(jcfg.vocab_size, 16, 4, seed=7))
    jt.run(2, log=QUIET, callbacks=[JCheckpointCallback(d, every=2, async_save=False)])
    at2 = jax.tree.map(np.array, j_state_to_tree(jt.state))
    jt.run(2, log=QUIET, callbacks=[])
    return jcfg, tcfg, d, at2, jt


def test_jax_full_state_restores_in_port_bitwise(jax_run):
    jcfg, tcfg, d, at2, _ = jax_run
    state, manifest = restore_train_state(d, tcfg, device="cpu")
    assert state.step == state.opt_state.step == 2 and manifest["meta"]["data_state"]["batches"] == 2
    _assert_same(state.params, at2["params"])
    for k in ("master", "m", "v"):
        _assert_same(getattr(state.opt_state, k), at2["opt"][k])
    words = at2["rng"].astype(np.uint64)
    assert state.gen.initial_seed() == int(words[0]) << 32 | int(words[1])


def test_jax_checkpoint_resumes_in_port(jax_run):
    """The port resumes the JAX checkpoint: the same data stream and, after
    2 more steps, params within the train tolerance of the JAX run's."""
    jcfg, tcfg, d, _, jt = jax_run
    state, manifest = restore_train_state(d, tcfg, device="cpu")
    it = t_make_train_iter(tcfg.vocab_size, 16, 4, seed=7).restore(manifest["meta"]["data_state"])
    tt = Trainer(tcfg, TTrainConfig(**KW), state=state, data_iter=it, device="cpu")
    tt.run(2, callbacks=[])
    assert tt.state.step == 4 and it.state()["rng"] == jt.data_iter.state()["rng"]
    tp, jp = flatten_tree(tt.params), flatten_tree(jax.tree.map(np.asarray, jt.params))
    for k in tp:
        diff = np.abs(f32(tp[k]) - f32(jp[k]))
        assert diff.max() <= PARAM_ATOL and (diff > 1e-5).mean() <= 0.01, (k, diff.max())


def test_port_full_state_restores_in_jax_bitwise(tmp_path):
    """A port checkpoint of a bf16 MoE run restores through the JAX
    package's ``restore_train_state``: params, optimizer state and step bit
    for bit, and the rng key is the generator's seed."""
    jcfg, tcfg = configs(moe=True, fp32=False)
    tr = Trainer(tcfg, TTrainConfig(**KW), device="cpu", data_iter=t_make_train_iter(tcfg.vocab_size, 16, 4, seed=7))
    tr.run(2, callbacks=[CheckpointCallback(str(tmp_path), every=2)])
    jstate, manifest = j_restore_train_state(str(tmp_path), jcfg)
    assert int(jstate.step) == int(jstate.opt_state.step) == 2
    assert jstate.params["stack"]["slot0"]["mixer"]["wq"].dtype == jnp.bfloat16
    _assert_same(jstate.params, tr.params)
    for k in ("master", "m", "v"):
        _assert_same(getattr(jstate.opt_state, k), getattr(tr.opt_state, k))
    assert np.array_equal(np.asarray(jstate.rng), rng_words(tr.state.gen))
    assert manifest["meta"]["data_state"] == json.loads(json.dumps(tr.data_iter.state()))


# -- the port's own checkpoints ------------------------------------------------


def _trainer(cfg, params=None, **kw):
    return Trainer(cfg, TTrainConfig(**KW), params=params, device="cpu",
                   data_iter=t_make_train_iter(cfg.vocab_size, 16, 4, seed=7), **kw)


def _state_bits(state):
    return {k: _bits(v) for k, v in flatten_tree(state_to_tree(state)).items()}


def test_async_save_takes_a_copy(tmp_path):
    """The async save snapshots the state at save time: two more in-place
    steps before ``wait()`` must not reach the bytes on disk."""
    _, tcfg = configs(moe=True, fp32=False)
    tr = _trainer(tcfg)
    cb = CheckpointCallback(str(tmp_path), every=2, async_save=True)
    tr.run(2, callbacks=[cb])
    at2 = _state_bits(tr.state)
    tr.run(2, callbacks=[cb])  # in-place updates while step 2's write may be in flight
    cb.manager.wait()
    tree2, _ = restore_tree(str(tmp_path), step=2, device="cpu")
    tree4, _ = restore_tree(str(tmp_path), step=4, device="cpu")
    assert {k: _bits(v) for k, v in flatten_tree(tree2).items()} == at2
    assert {k: _bits(v) for k, v in flatten_tree(tree4).items()} == _state_bits(tr.state)
    assert _bits(tree2["params"]["embed"]["embedding"]) != _bits(tree4["params"]["embed"]["embedding"])


def _upcycled(tcfg_dense):
    from repro_torch.core.upcycle import upcycle_params

    moe_cfg = upcycle_config(tcfg_dense, TMoEConfig(num_experts=4, top_k=2, capacity_factor=None, dispatcher="sorted"))
    dense = _trainer(tcfg_dense)
    dense.run(2, callbacks=[])
    with torch.no_grad():
        return moe_cfg, upcycle_params(tcfg_dense, moe_cfg, dense.params, 9)


@pytest.mark.parametrize("start", ["dense", "upcycled"])
def test_resume_bitwise_parity(tmp_path, start):
    """k steps + save + restore in a fresh Trainer + n steps == k + n
    straight steps, bit for bit: params, fp32 master and moments, the
    generator and the logged metrics; after upcycling too."""
    jcfg, cfg = configs(moe=False, fp32=False)
    params = None
    if start == "upcycled":
        cfg, params = _upcycled(cfg)
    straight = _trainer(cfg, params)
    straight.run(5, callbacks=[LoggingCallback(log=QUIET, log_every=1)])
    tr1 = _trainer(cfg, params)
    cb = CheckpointCallback(str(tmp_path), every=3, extra_meta={"provenance": {"upcycled": start == "upcycled"}})
    tr1.run(3, callbacks=[cb])
    del tr1
    state, manifest = restore_train_state(str(tmp_path), cfg, device="cpu")
    assert manifest["step"] == 3 and manifest["meta"]["provenance"]["upcycled"] == (start == "upcycled")
    it = t_make_train_iter(cfg.vocab_size, 16, 4, seed=7).restore(manifest["meta"]["data_state"])
    tr2 = Trainer(cfg, TTrainConfig(**KW), state=state, data_iter=it, device="cpu")
    tr2.run(2, callbacks=[LoggingCallback(log=QUIET, log_every=1)])
    assert tr2.state.step == tr2.opt_state.step == 5
    assert _state_bits(tr2.state) == _state_bits(straight.state)
    ref = {r["step"]: r for r in straight.history}
    for r in tr2.history:
        for k in ("loss", "ce", "lr", "grad_norm"):
            assert r[k] == ref[r["step"]][k], (r["step"], k)


def test_embedding_backward_is_bit_reproducible():
    """Exact resume needs a bit-reproducible step: the embedding's gradient
    over repeated tokens (here 1024 draws of 64 ids) comes out the same
    bits on every call, whatever the CPU threads' schedule."""
    from repro_torch.models.layers import embed_apply

    g = torch.Generator().manual_seed(0)
    table = torch.randn(64, 32, generator=g, requires_grad=True)
    tokens = torch.randint(0, 64, (8, 128), generator=g)
    dy = torch.randn(8, 128, 32, generator=g)
    grads = [torch.autograd.grad(embed_apply({"embedding": table}, tokens, torch.float32), table, dy)[0]
             for _ in range(6)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])


def test_restore_rejects_wrong_config(tmp_path):
    _, cfg = configs(moe=False, fp32=False)
    _trainer(cfg).run(1, callbacks=[CheckpointCallback(str(tmp_path), every=1, async_save=False)])
    _, other = configs(moe=False, fp32=False, num_layers=3)
    with pytest.raises(AssertionError, match="do(es)? not match"):
        restore_train_state(str(tmp_path), other, device="cpu")


def test_default_callbacks_checkpoint_when_ckpt_every(tmp_path):
    _, cfg = configs(moe=False, fp32=False)
    tr = Trainer(cfg, TTrainConfig(**dict(KW, ckpt_every=2, ckpt_dir=str(tmp_path))), device="cpu",
                 data_iter=t_make_train_iter(cfg.vocab_size, 16, 4, seed=7))
    tr.run(4, log=QUIET)
    assert list_steps(str(tmp_path)) == [2, 4]


# -- upcycling on load -----------------------------------------------------------


def test_upcycle_on_load_matches_jax(tmp_path):
    """A dense bf16 checkpoint upcycled on load in both packages: every
    expert and non-expert leaf bit-equal; the routers (drawn by each
    package's own generator) of the same shape and dtype."""
    jdense, tdense = configs(moe=False, fp32=False)
    moe_kw = dict(num_experts=4, top_k=2, capacity_factor=None, dispatcher="sorted")
    jmoe, tmoe = j_upcycle_config(jdense, JMoEConfig(**moe_kw)), upcycle_config(tdense, TMoEConfig(**moe_kw))
    j_save(str(tmp_path), jax_params(jdense, seed=4, fp32=False))
    jp, hlo = j_upcycle_on_load(str(tmp_path), jdense, jmoe, None, jax.random.PRNGKey(9))
    tp, none = upcycle_on_load(str(tmp_path), tdense, tmoe, seed=9, device="cpu")
    assert hlo is None and none is None
    ft, fj = flatten_tree(tp), flatten_tree(jp)
    routers = [k for k in ft if "router" in k]
    assert routers and sorted(ft) == sorted(fj)
    for k in ft:
        if k in routers:
            assert _bits(ft[k])[:2] == _bits(fj[k])[:2], k
        else:
            assert _bits(ft[k]) == _bits(fj[k]), k
    assert upcycle_provenance(tdense, tmoe, "src") == j_provenance(jdense, jmoe, "src")


# -- the train CLI ---------------------------------------------------------------

CLI = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--seq", "32", "--device", "cpu"]
UPCYCLE = ["--upcycle", "4", "--top-k", "2", "--cf", "-1", "--dispatcher", "sorted", "--use-kernel"]


@pytest.fixture(scope="module")
def dense_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dense"))
    train_cli(CLI + ["--steps", "2", "--save-ckpt", d])
    return d


def test_train_cli_from_ckpt_resume_and_save(tmp_path, dense_ckpt, capsys):
    """``--from-ckpt`` upcycles the dense checkpoint; a run stopped after
    its step-4 checkpoint (17 corrupt batches exhaust the skip budget) and
    resumed with ``--resume`` ends bit for bit where a straight run does;
    ``--save-ckpt`` leaves the flat params checkpoint; ``--steps 8
    --resume`` continues the run to step 8."""
    run, straight_dir = str(tmp_path / "run"), str(tmp_path / "straight")
    argv = CLI + UPCYCLE + ["--from-ckpt", dense_ckpt, "--steps", "6", "--ckpt-every", "2", "--ckpt-keep", "2"]
    with faults.inject(FaultSpec("data.batch", "corrupt_batch", at=4, count=17)), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(DataCorruptionError):
            train_cli(argv + ["--blocking-ckpt", "--save-ckpt", run])
    assert list_steps(run) == [2, 4]
    resumed = train_cli(argv + ["--save-ckpt", run, "--resume"])
    straight = train_cli(argv + ["--save-ckpt", straight_dir])
    out = capsys.readouterr().out
    assert "upcycled llama3-8b -> llama3-8b-e4t2" in out and "resumed step 4" in out and "(upcycled run)" in out
    assert _state_bits(resumed.state) == _state_bits(straight.state)
    assert list_steps(run) == [4, 6] and latest_step(run) == 6
    manifest = json.load(open(os.path.join(run, "step_00000006", "manifest.json")))
    assert manifest["meta"]["provenance"]["source_ckpt"] == dense_ckpt
    _assert_same(load_checkpoint(run, device="cpu"), resumed.params)
    more = train_cli(argv + ["--save-ckpt", run, "--resume", "--steps", "8"])
    assert more.state.step == 8 and latest_step(run) == 8


def test_train_cli_supervise_rolls_back(tmp_path, dense_ckpt):
    """``--supervise``: two injected loss spikes after the 5 warm-up steps
    are skipped, and the second strike rolls the run back to the step-6
    checkpoint."""
    argv = CLI + UPCYCLE + ["--from-ckpt", dense_ckpt, "--steps", "10", "--ckpt-every", "2", "--blocking-ckpt",
                            "--supervise", "--rollback-after", "2", "--save-ckpt", str(tmp_path)]
    with faults.inject(FaultSpec("train.step", "loss_spike", at=6, count=2, args={"shift": 1e5})) as inj:
        tr = train_cli(argv)
    assert inj.fired == [("train.step", "loss_spike", 6), ("train.step", "loss_spike", 7)]
    sup = next(cb for cb in tr.callbacks if isinstance(cb, AnomalySupervisor))
    assert sup.skips == 2 and sup.rollbacks == 1
    assert [(i["kind"], i["step"]) for i in sup.interventions] == [("skip", 7), ("skip", 8), ("rollback", 8)]
    assert sup.interventions[-1]["to"] == 6 and tr.state.step == 8

