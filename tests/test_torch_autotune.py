"""The port's tile autotuner (``repro_torch.kernels.autotune``): the JAX
package's unit tests of tests/test_autotune.py restated over compiled tiles
(opt-in gating, the persistent cache across processes, version
invalidation, rejection of poisoned entries, the shared-memory filter, the
validator, the hardware profiles), parity of ``search`` and
``modeled_seconds`` with ``repro.kernels.autotune``, the hooked wrappers'
tiles with tuning off and on (a measured winner reaching the launch, the
row buckets of the keys), the committed defaults, and ``--autotune`` on
both CLIs. CPU only: the plain versions ignore the tile, and the card's
timer is stood in for where a test needs a measurement."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.core.quant import quantize_weight
from repro_torch.kernels import autotune
from repro_torch.kernels import expert_gemm as eg
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import main as serve_cli
from repro_torch.launch.train import main as train_cli
from repro_torch.roofline.analysis import HW_PROFILES, hw_profile


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """A private cache file and a clean memo per test; tuning OFF unless a
    test turns it on (set, not deleted, so that teardown also removes what
    a CLI writes into the environment)."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "cache.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.delenv("REPRO_HW_PROFILE", raising=False)
    autotune.reset()
    yield
    autotune.reset()


# ---------------------------------------------------------------------------
# unit tests (tests/test_autotune.py, over compiled tiles)
# ---------------------------------------------------------------------------

UNIT_TILES = ((1, 128), (1, 256), (2, 128), (2, 256))  # (warpgroups, BN) a "unit" kernel compiles


def _legal(D):
    return lambda t: t[1] == 128 or D % 256 == 0


def _simple_cost(tile):
    wg, bn = tile
    # strictly prefers larger tiles (fewer steps), fits any shared memory
    return {"flops": 1e9, "bytes": 1e6, "steps": (512 // (64 * wg)) * (512 // bn), "smem_bytes": wg * bn}


def _resolve(key="k1", fallback=(1, 128), D=512):
    return autotune.get_blocks("unit", key, fallback, UNIT_TILES, _simple_cost, legal=_legal(D))


def test_disabled_returns_fallback_untouched():
    assert not autotune.enabled()
    assert _resolve(fallback=(1, 256)) == (1, 256)
    assert autotune.stats() == {"hits": 0, "misses": 0}
    assert not os.path.exists(autotune.cache_path())


def test_enabled_tunes_persists_and_hits(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    win = _resolve()
    assert win == (2, 256)  # fewest steps wins under _simple_cost
    assert autotune.stats() == {"hits": 0, "misses": 1}
    assert _resolve() == win
    assert autotune.stats() == {"hits": 1, "misses": 1}
    data = json.load(open(autotune.cache_path()))
    assert data["version"] == autotune.CACHE_VERSION
    entry = data["profiles"]["h100"]["k1"]
    assert entry["blocks"] == [2, 256] and entry["source"] == "modeled" and entry["kernel"] == "unit"


def test_cache_determinism_across_processes(monkeypatch):
    """Same key, same winner, from a cold process reading the cache file."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    win = _resolve()
    prog = (
        "import json\n"
        "from repro_torch.kernels import autotune\n"
        "def cost(t):\n"
        "    wg, bn = t\n"
        "    return {'flops': 1e9, 'bytes': 1e6, 'steps': (512 // (64 * wg)) * (512 // bn), 'smem_bytes': wg * bn}\n"
        "w = autotune.get_blocks('unit', 'k1', (1, 128), ((1, 128), (1, 256), (2, 128), (2, 256)), cost)\n"
        "print(json.dumps({'win': list(w), 'stats': autotune.stats()}))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True, check=True,
                         timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert tuple(got["win"]) == win
    assert got["stats"] == {"hits": 1, "misses": 0}  # served from disk


def test_cache_version_invalidation(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    path = autotune.cache_path()
    with open(path, "w") as f:
        json.dump({"version": autotune.CACHE_VERSION - 1, "profiles": {"h100": {"k1": {"blocks": [1, 128]}}}}, f)
    autotune.reset()
    assert _resolve() == (2, 256)  # the stale version ignored, tuned again
    assert autotune.stats()["misses"] == 1
    assert json.load(open(path))["version"] == autotune.CACHE_VERSION


def test_poisoned_cache_entries_rejected(monkeypatch):
    """A cached winner the kernel does not compile, one illegal at the
    call's dims, one of the wrong arity or type: each dropped and tuned
    again, never handed to a kernel."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    with open(autotune.cache_path(), "w") as f:
        json.dump({"version": autotune.CACHE_VERSION, "profiles": {"h100": {
            "k1": {"v": 1, "blocks": [4, 256]},  # 4 warpgroups: not compiled
            "k2": {"v": 1, "blocks": [2, 256]},  # BN 256 at D 384: illegal
            "k3": {"v": 1, "blocks": [2]},  # wrong arity
            "k4": {"v": 1, "blocks": ["2", 128]},  # not ints
        }}}, f)
    autotune.reset()
    assert _resolve(key="k1") == (2, 256)
    assert _resolve(key="k2", D=384) == (2, 128)
    assert _resolve(key="k3") == (2, 256)
    assert _resolve(key="k4") == (2, 256)
    assert autotune.stats() == {"hits": 0, "misses": 4}


def test_smem_filter_and_fallback(monkeypatch):
    """Candidates over the profile's shared-memory budget are dropped; with
    none left the fallback stands; ``candidates`` keeps only the legal
    compiled tiles."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")

    def cost(tile):
        wg, bn = tile
        return {"flops": 1.0, "bytes": 1.0, "steps": 1024 // (wg * bn), "smem_bytes": 1000 * wg * bn}

    win = autotune.get_blocks("unit", "smem", (1, 128), UNIT_TILES, cost)
    assert 1000 * win[0] * win[1] <= HW_PROFILES["h100"]["smem_bytes"] and win == (1, 128)
    too_big = lambda t: {"flops": 1.0, "bytes": 1.0, "smem_bytes": 1e9}  # noqa: E731
    assert autotune.get_blocks("unit", "none", (1, 256), UNIT_TILES, too_big) == (1, 256)
    assert autotune.candidates(UNIT_TILES, _legal(384)) == [(1, 128), (2, 128)]


def test_validate_blocks_contract():
    ok = autotune.validate_blocks
    assert ok((2, 256), UNIT_TILES)
    assert ok([1, 128], UNIT_TILES, _legal(384))  # a JSON list
    assert not ok((2, 256), UNIT_TILES, _legal(384))  # illegal at these dims
    assert not ok((3, 128), UNIT_TILES)  # not compiled
    assert not ok((2,), UNIT_TILES)  # arity
    assert not ok((2.0, 256), UNIT_TILES)  # not ints
    assert not ok((True, 128), UNIT_TILES)
    assert not ok("2,256", UNIT_TILES)


def test_hw_profile_selection(monkeypatch):
    assert hw_profile() == HW_PROFILES["h100"]
    monkeypatch.setenv("REPRO_HW_PROFILE", "cpu")
    assert hw_profile() == HW_PROFILES["cpu"]
    assert hw_profile("h100") == HW_PROFILES["h100"]
    with pytest.raises(ValueError, match="unknown hardware profile"):
        hw_profile("v9000")
    for prof in HW_PROFILES.values():
        assert {"peak_flops", "hbm_bw", "smem_bytes"} <= set(prof)
    assert HW_PROFILES["h100"]["smem_bytes"] == 232448 == 227 * 1024


def test_modeled_score_monotone_in_hw():
    """The same candidate costs less on the faster device: the score reads
    the selected profile."""
    assert autotune.modeled_seconds(1e12, 1e9, 0, hw_profile("h100")) < autotune.modeled_seconds(
        1e12, 1e9, 0, hw_profile("cpu"))


# ---------------------------------------------------------------------------
# parity with the JAX tuner
# ---------------------------------------------------------------------------

BOTH = {**HW_PROFILES["h100"], "vmem_bytes": 16e6}  # a profile both tuners read


def _both_cost(blocks):
    bf, bd = blocks
    return {"flops": 6.0 * 4096 * bd * bf, "bytes": 4096.0 * (bf + bd) * 2 + 1e6 / bf, "steps": 8192 // bf,
            "vmem_bytes": bf * bd * 4.0, "smem_bytes": bf * bd * 0.5}


@pytest.mark.parametrize("measured", [False, True])
def test_search_matches_jax(measured):
    cands = jat.candidates((512, 1024), (128, 128))
    measure = (lambda b: 1e-3 / b[0] + 1e-6 * b[1]) if measured else None
    assert autotune.search(cands, _both_cost, measure=measure, hw=BOTH) == jat.search(
        cands, _both_cost, measure=measure, hw=BOTH)


@pytest.mark.parametrize("args", [(1e12, 1e9, 0), (1e9, 1e12, 3), (5e14, 2e10, 17.0)])
@pytest.mark.parametrize("prof", ["h100", "cpu"])
def test_modeled_seconds_matches_jax(args, prof):
    from repro.roofline.analysis import HW_PROFILES as JHW

    for hw in (HW_PROFILES[prof], JHW["v5e"]):
        assert autotune.modeled_seconds(*args, hw) == jat.modeled_seconds(*args, hw)


def test_make_key_matches_jax():
    kw = dict(E=8, k=2, D=4096, F=14336, page_size=16, itemsize=1, extra="bc128")
    assert autotune.make_key("grouped_gemm", **kw) == jat.make_key("grouped_gemm", **kw)
    assert autotune.make_key("x") == jat.make_key("x")


# ---------------------------------------------------------------------------
# the hooked wrappers
# ---------------------------------------------------------------------------

E, D, F = 4, 256, 384  # D % 256 == 0: both BNs legal


def _routing(rng, k, T, bc=128):
    """The sorted dispatcher's (token, slot, dest, gate_sorted, group_sizes)
    for random top-k routing (as tests/test_torch_fused.py:_routing)."""
    N = T * k
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(N)
    gates = rng.uniform(0.2, 1.0, size=N).astype(np.float32)
    order = np.argsort(idx, kind="stable")
    gs = np.bincount(idx, minlength=E).astype(np.int32)
    padded = (gs + bc - 1) // bc * bc
    starts_pad, starts = np.cumsum(padded) - padded, np.cumsum(gs) - gs
    dest = starts_pad[idx[order]] + np.arange(N) - starts[idx[order]]
    t = [torch.from_numpy(a.astype(np.int64)) for a in (order // k, order % k, dest)]
    return (*t, torch.from_numpy(gates[order]), torch.from_numpy(gs))


def _sites(C=6, lead=(2,)):
    """(site, the ops call, its plain version's output, the wrapper the
    tile reaches, its fixed-rule tile) of every hooked expert-GEMM call
    site, on small CPU inputs."""
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    wg, wu, wd = r(E, D, F) * D ** -0.5, r(E, D, F) * D ** -0.5, r(E, F, D) * F ** -0.5
    (qg, sg), (qu, su), (qd, sd) = (quantize_weight(w.bfloat16()) for w in (wg, wu, wd))
    qg, sg, qu, su, qd, sd = qg, sg.float(), qu, su.float(), qd, sd.float()
    token, slot, dest, gate, gs = _routing(rng, 2, 10)
    n_pad = int(((gs + 127) // 128 * 128).sum())
    xs, x, xe = r(n_pad, D), r(10, D), r(*lead, E, C, D)
    x3 = xe.reshape(-1, E, C, D).transpose(0, 1).reshape(E, -1, D)
    unfold = lambda y: y.reshape(E, -1, C, D).transpose(0, 1).reshape(*lead, E, C, D)  # noqa: E731
    Cf = int(np.prod(lead)) * C
    q8 = (qg, qu, qd, sg, su, sd)
    fused_args = (gs, token, dest, slot, gate)
    return [
        ("expert_gemm", lambda: ops.expert_gemm(xe, wg, wu, wd), unfold(ref.expert_gemm_ref(x3, wg, wu, wd)),
         "expert_gemm", eg.default_tile("expert_gemm", Cf, D)),
        ("expert_gemm_q8", lambda: ops.expert_gemm_q8(xe, *q8), unfold(ref.expert_gemm_q8_ref(x3, *q8)),
         "expert_gemm_q8", eg.default_tile("expert_gemm_q8", Cf, D)),
        ("grouped_gemm", lambda: ops.grouped_gemm(xs, wg, wu, wd, gs), ref.grouped_gemm_ref(xs, wg, wu, wd, gs, 128),
         "grouped_gemm", (2, 2, 256)),
        ("grouped_gemm_q8", lambda: ops.grouped_gemm_q8(xs, *q8, gs), ref.grouped_gemm_q8_ref(xs, *q8, gs, 128),
         "grouped_gemm_q8", (2, 2, 256)),
        ("grouped_gemm_fused", lambda: ops.grouped_gemm_fused(x, wg, wu, wd, *fused_args),
         ref.grouped_gemm_fused_ref(x, wg, wu, wd, *fused_args), "grouped_gemm_fused", (2, 2, 256)),
        ("grouped_gemm_fused_q8", lambda: ops.grouped_gemm_fused_q8(x, *q8, *fused_args),
         ref.grouped_gemm_fused_q8_ref(x, *q8, *fused_args), "grouped_gemm_fused_q8", (2, 2, 256)),
    ]


def _record_tiles(monkeypatch):
    """Capture the ``tile`` each hooked ops call hands the expert_gemm
    module."""
    seen = {}
    for name in ("expert_gemm", "expert_gemm_q8", "grouped_gemm", "grouped_gemm_q8", "grouped_gemm_fused",
                 "grouped_gemm_fused_q8"):
        fn = getattr(eg, name)

        def rec(*a, _fn=fn, _name=name, tile=None, **kw):
            seen[_name] = tile
            return _fn(*a, tile=tile, **kw)

        monkeypatch.setattr(eg, name, rec)
    return seen


@pytest.mark.parametrize("C", [6, 40])
def test_tuning_off_passes_the_fixed_rule_and_changes_no_output(monkeypatch, C):
    """Off: every hooked expert-GEMM wrapper passes its fixed rule's tile
    (the padded pair at the folded C: 12 and 80 slots, one and two
    warpgroups), and its output is the plain version's bit for bit."""
    seen = _record_tiles(monkeypatch)
    for site, call, plain, name, rule in _sites(C=C):
        out = call()
        assert seen[name] == rule, site
        assert torch.equal(out, plain), site
    assert seen["expert_gemm"] == ((1, 1, 256) if C == 6 else (2, 2, 256))
    assert autotune.stats() == {"hits": 0, "misses": 0}


def _attention_inputs():
    rng = np.random.default_rng(1)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k, v = r(1, 12, 4, 64), r(1, 12, 2, 64), r(1, 12, 2, 64)
    pq, kp, vp = r(2, 4, 64), r(6, 4, 2, 64), r(6, 4, 2, 64)
    bt = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    sl = torch.tensor([10, 5], dtype=torch.int32)
    return q, k, v, pq, kp, vp, bt, sl


@pytest.mark.parametrize("tuning", ["0", "1"])
def test_attention_call_sites_have_no_hook(monkeypatch, tuning):
    """Flash and paged attention compile one tile each, so they have no
    hook: on or off, the tuner makes no key for them and the outputs are
    the plain versions'."""
    monkeypatch.setenv("REPRO_AUTOTUNE", tuning)
    q, k, v, pq, kp, vp, bt, sl = _attention_inputs()
    assert torch.equal(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v, True, None, None))
    assert torch.equal(ops.paged_attention(pq, kp, vp, bt, sl), ref.paged_attention_ref(pq, kp, vp, bt, sl))
    assert autotune.stats() == {"hits": 0, "misses": 0}
    assert not os.path.exists(autotune.cache_path())


def test_tuning_on_resolves_a_compiled_tile_at_every_call_site(monkeypatch):
    """On: each hooked call site resolves, once per key, a compiled tile
    that passes the validator; the outputs stay the plain versions'."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    seen = _record_tiles(monkeypatch)
    for site, call, plain, name, _ in _sites():
        assert torch.equal(call(), plain), site
        assert autotune.validate_blocks(seen[name], eg.TILES[site], lambda t: eg.tile_legal(t, D)), site
    assert autotune.stats() == {"hits": 0, "misses": 6}
    for _, call, _, _, _ in _sites():
        call()
    assert autotune.stats() == {"hits": 6, "misses": 6}


def test_the_timer_measures_only_on_the_card():
    """On the CPU the hooks pass no timer (a tile changes nothing there) and
    the modeled score decides."""
    calls = []
    assert ops._timer(lambda t: calls.append(t), torch.zeros(2)) is None
    assert calls == []


def test_a_measured_winner_reaches_the_launch(monkeypatch):
    """With the card's timer stood in by one that rates BN 128 and one
    warpgroup fastest, every hooked call site launches that measured tile,
    not the fixed rule's, persists it as measured, and times each legal
    compiled tile through its own forward; outputs stay the plain
    versions'."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    timed = []

    def fake_timer(run, x):
        mine = []
        timed.append(mine)

        def measure(tile):
            mine.append(tuple(tile))
            run(tile)
            return 1.0 + (tile[2] == 256) + 0.5 * (tile[0] + tile[1])
        return measure

    monkeypatch.setattr(ops, "_timer", fake_timer)
    seen = _record_tiles(monkeypatch)
    for site, call, plain, name, rule in _sites():
        assert torch.equal(call(), plain), site
        want = (1, 1, 128) if site == "expert_gemm" else (2, 2, 128)
        assert tuple(seen[name]) == want != tuple(rule), site
    cached = json.load(open(autotune.cache_path()))["profiles"]["h100"]
    assert len(cached) == 6 and {e["source"] for e in cached.values()} == {"measured"}
    assert sorted(len(v) for v in timed) == [2, 2, 2, 2, 2, 8]  # every legal compiled tile, once


def test_sorted_keys_carry_the_row_bucket(monkeypatch, tmp_path):
    """Decode-sized and prefill-sized buffers tune apart; two row counts
    of one bucket share a key. Padded keys carry C's bucket, whose edge at
    64 is the fixed rule's. (No committed defaults: they hold these keys.)"""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "_defaults_path", lambda: str(tmp_path / "none.json"))
    for rows in (1024, 1152, 2048, 5120):
        ops.sorted_tile("grouped_gemm", 8, 4096, 14336, 128, rows)
    keys = sorted(json.load(open(autotune.cache_path()))["profiles"]["h100"])
    assert [k.rsplit("|", 1)[1] for k in keys] == ["N1024", "N2048", "N8192"]
    assert autotune.stats() == {"hits": 1, "misses": 3}
    assert all(k.startswith("grouped_gemm|E8|k0|D4096|F14336|ps0|it2|bc128|N") for k in keys)
    assert [ops.row_bucket(n) for n in (1, 4, 33, 64, 65, 300)] == [1, 4, 64, 64, 128, 512]
    assert ops.expert_tile("expert_gemm", 8, 60, 4096, 14336) == (1, 1, 256)  # the rule, modeled
    assert ops.expert_tile("expert_gemm", 8, 65, 4096, 14336) == (2, 2, 256)


def test_tile_shared_memory_matches_the_sources():
    """``tile_smem`` restates ``T::SMEM``: the values the sources quote."""
    assert eg.tile_smem(2, 256) == 197696  # #3, #4, #12, #13 at BN 256
    assert eg.tile_smem(2, 256, q8=True) == 230464  # Q8Tile<256>
    assert all(eg.tile_smem(w, bn, q) <= 232448 for w in (1, 2) for bn in (128, 256) for q in (False, True)
               if not (q and w == 1))


def test_tiles_outside_the_compiled_set_raise():
    """The wrappers take only a compiled tile of their call site, legal at
    the output width; None is the fixed rule."""
    for site, tile, D in (("grouped_gemm", (2, 2, 256), 384), ("grouped_gemm", (1, 1, 256), 512),
                          ("expert_gemm", (2, 2, 64), 512), ("expert_gemm_q8", (1, 1, 128), 512),
                          ("expert_gemm", (3, 2, 128), 512)):
        with pytest.raises(ValueError, match="compiled tiles"):
            eg._tile_args(site, tile, D)
    assert eg._tile_args("grouped_gemm", None, 384) == (-1, -1, -1)
    assert eg._tile_args("grouped_gemm", [2, 2, 128], 384) == (2, 2, 128)
    assert eg._tile_args("expert_gemm", (1, 2, 256), 512) == (1, 2, 256)


def _key_dims(key: str) -> dict:
    """{"E", "k", "D", "F", "ps", "it"} of a ``make_key`` key, as ints, and
    its ``extra``."""
    parts = key.split("|")
    dims = {n: int(f[len(n):]) for n, f in zip(("E", "k", "D", "F", "ps", "it"), parts[1:7])}
    return {**dims, "extra": "|".join(parts[7:])}


def test_committed_defaults_validate_and_serve_their_keys(monkeypatch):
    """Every entry of ``autotune_defaults.json`` is a measured h100 entry
    naming a compiled tile legal at its key's D, under a key the hooks make
    (C or the sorted rows as a power-of-two bucket); with tuning on, the
    hooks at those dims take each entry from the file without a search."""
    data = json.load(open(autotune._defaults_path()))
    assert data["version"] == autotune.CACHE_VERSION and set(data["profiles"]) == {"h100"}
    entries = data["profiles"]["h100"]
    assert {e["kernel"] for e in entries.values()} == set(eg.TILES)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    for key, entry in entries.items():
        kernel, d = entry["kernel"], _key_dims(key)
        assert key.startswith(kernel + "|") and entry["source"] == "measured", key
        if kernel.startswith("expert_gemm"):
            C = int(d["extra"][1:])
            assert ops.row_bucket(C) == C, key
            got = ops.expert_tile(kernel, d["E"], C, d["D"], d["F"])
        else:
            bc, rows = d["extra"].split("|")
            assert bc == "bc128" and ops.row_bucket(int(rows[1:])) == int(rows[1:]), key
            got = ops.sorted_tile(kernel, d["E"], d["D"], d["F"], 128, int(rows[1:]))
        assert autotune.validate_blocks(entry["blocks"], eg.TILES[kernel], lambda t: eg.tile_legal(t, d["D"])), key
        assert list(got) == entry["blocks"], key
    assert autotune.stats() == {"hits": len(entries), "misses": 0}
    assert not os.path.exists(autotune.cache_path())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_serve_cli_autotune_on_the_cpu(capsys):
    """``--autotune`` turns tuning on before any wrapper runs; the tokens
    are those of the run without it (the plain versions ignore tiles)."""
    argv = ["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "4", "--dispatcher", "sorted",
            "--use-kernel", "--cache-mode", "paged", "--device", "cpu"]
    plain = serve_cli(argv)
    tuned = serve_cli(argv + ["--autotune"])
    assert tuned == plain
    assert autotune.enabled() and autotune.stats()["misses"] > 0
    assert "autotune: {'hits'" in capsys.readouterr().out
    assert os.path.exists(autotune.cache_path())


def test_train_cli_autotune_on_the_cpu(capsys):
    tr = train_cli(["--arch", "llama3-8b", "--smoke", "--upcycle", "4", "--top-k", "2", "--cf", "-1",
                    "--dispatcher", "sorted", "--use-kernel", "--steps", "1", "--batch", "2", "--seq", "32",
                    "--autotune", "--device", "cpu"])
    assert tr.state.step == 1 and np.isfinite(tr.history[0]["loss"])
    assert autotune.stats()["misses"] >= 1
    keys = json.load(open(autotune.cache_path()))["profiles"]["h100"]
    assert any(k.startswith("grouped_gemm|") for k in keys)
    assert "autotune:" in capsys.readouterr().out
