"""Port parity of speculative decoding: the port's ``SpeculativeEngine``
emits plain paged greedy decode's tokens (the JAX package's four cases in
tests/test_serving_paged.py, on the port), emits the JAX
``SpeculativeEngine``'s tokens with the same draft and accept counts on the
same weights carried across, keeps its drafter pool in lockstep with the
verifier's through defrag and copy-on-write, and runs behind the serve CLI;
tiny configs in fp32 on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import FP32_ATOL, configs, jax_params, to_torch

from repro.core.upcycle import upcycle_params as jax_upcycle_params
from repro.serving.engine import Request as JRequest
from repro.serving.speculative import SpeculativeEngine as JSpec
from repro_torch.config import MoEConfig
from repro_torch.core.upcycle import upcycle_config, upcycle_params
from repro_torch.launch.serve import main as serve_cli
from repro_torch.models.model import paged_forward
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import init_paged_pool
from repro_torch.serving.speculative import SpeculativeEngine

KW = dict(max_batch=2, max_seq=64, page_size=4, prefill_chunk=8)
MOE = dict(num_experts=4, top_k=2, capacity_factor=None, router_type="mixtral", dispatcher="sorted")


def _requests(cls, vocab, seed, n=4, lmax=20, new=(4, 9)):
    """As tests/test_serving_paged.py:_requests."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, lmax))).astype(np.int32),
                max_new_tokens=int(rng.integers(*new)))
            for i in range(n)]


def _shared_prefix_requests(cls, vocab, seed, n=5, stem_len=12):
    """As tests/test_serving_paged.py:_shared_prefix_requests: rid 4 is the
    bare stem (a full-coverage hit, copied on write)."""
    rng = np.random.default_rng(seed)
    stem = rng.integers(0, vocab, stem_len).astype(np.int32)
    reqs = []
    for i in range(n):
        t = rng.integers(0, vocab, int(rng.integers(1, 10))).astype(np.int32)
        prompt = stem.copy() if i == 4 else np.concatenate([stem, t])
        reqs.append(cls(rid=i, prompt=prompt, max_new_tokens=int(rng.integers(3, 6))))
    return reqs


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = configs(moe=False)
    jp = jax_params(jcfg)
    bad = jax_params(jcfg, seed=99)
    return jcfg, tcfg, jp, to_torch(jp), bad, to_torch(bad)


def _moe_cfg(tcfg):
    return upcycle_config(tcfg, MoEConfig(**MOE))


def _plain(cfg, params, reqs, **kw):
    return ServingEngine(cfg, params, cache_mode="paged", device="cpu", **{**KW, **kw}).run(reqs)


def _spec(cfg, params, dcfg, dparams, reqs, k=3, **kw):
    eng = SpeculativeEngine(cfg, params, dcfg, dparams, draft_k=k, device="cpu", **{**KW, **kw})
    return eng, eng.run(reqs)


def test_speculative_parity_same_drafter(dense):
    """Drafter == verifier: plain paged decode's tokens, every draft
    accepted, fewer verify steps than tokens."""
    _, cfg, _, p, _, _ = dense
    out_plain = _plain(cfg, p, _requests(Request, cfg.vocab_size, 21))
    spec, out_spec = _spec(cfg, p, cfg, p, _requests(Request, cfg.vocab_size, 21))
    assert out_plain == out_spec
    assert spec.drafted_tokens > 0 and spec.acceptance_rate == 1.0
    assert spec.spec_steps < sum(len(o) for o in out_spec.values()), "speculation never batched tokens"
    spec.page_pool.check_invariants()
    assert spec.page_pool.free_pages == spec.page_pool.num_pages
    assert len(spec.timings["draft_s"]) == len(spec.timings["verify_s"]) == spec.spec_steps


def test_speculative_parity_with_bad_drafter(dense):
    """A drafter drawn independently costs acceptance, never tokens."""
    _, cfg, _, p, _, bad = dense
    out_plain = _plain(cfg, p, _requests(Request, cfg.vocab_size, 23))
    spec, out_spec = _spec(cfg, p, cfg, bad, _requests(Request, cfg.vocab_size, 23))
    assert out_plain == out_spec
    assert spec.acceptance_rate < 1.0, "independent random params should disagree somewhere"


def test_speculative_from_upcycle_pair(dense):
    """The paper's pairing: the dense parent drafts for its upcycled MoE;
    the provenance is recorded, the tokens are a plain engine's on
    ``upcycle_params`` of the same tree, and acceptance is ~1."""
    _, dcfg, _, dp, _, _ = dense
    mcfg = _moe_cfg(dcfg)
    spec = SpeculativeEngine.from_upcycle(dcfg, mcfg, dp, seed=0, draft_k=3, device="cpu", **KW)
    assert spec.provenance is not None and spec.provenance["upcycled"]
    assert spec.provenance["num_experts"] == 4
    out_spec = spec.run(_requests(Request, mcfg.vocab_size, 29))
    out_plain = _plain(mcfg, upcycle_params(dcfg, mcfg, dp, 0), _requests(Request, mcfg.vocab_size, 29))
    assert out_spec == out_plain
    assert spec.acceptance_rate > 0.9, spec.kv_stats()["speculation"]


def test_speculative_with_prefix_cache(dense):
    """Prefix hits skip prefill for drafter and verifier at once; the
    stream is still plain greedy decode's."""
    _, cfg, _, p, _, _ = dense
    kw = dict(prefix_cache=True)
    out_plain = _plain(cfg, p, _shared_prefix_requests(Request, cfg.vocab_size, 31), **kw)
    spec, out_spec = _spec(cfg, p, cfg, p, _shared_prefix_requests(Request, cfg.vocab_size, 31), **kw)
    assert out_plain == out_spec
    stats = spec.kv_stats()
    assert stats["prefix"]["hits"] > 0 and stats["prefix"]["cow_clones"] >= 1
    assert stats["speculation"]["acceptance_rate"] == 1.0


@pytest.mark.parametrize("case", ["same", "bad", "upcycled", "upcycled_int8_kv", "prefix"])
def test_speculative_matches_jax(dense, case):
    """The port and the JAX ``SpeculativeEngine`` on the same weights carried
    across: equal tokens and equal spec_steps / drafted / accepted counts
    (the upcycled pair's MoE tree is upcycled by JAX and carried across; int8
    KV pages quantise the verifier's pool only, in both)."""
    import jax

    jd, td, jp, tp, jbad, tbad = dense
    kw = dict(KW)
    reqs = lambda cls, v: _requests(cls, v, 37)  # noqa: E731
    if case in ("same", "prefix"):
        jargs, targs = (jd, jp, jd, jp), (td, tp, td, tp)
        if case == "prefix":
            kw["prefix_cache"] = True
            reqs = lambda cls, v: _shared_prefix_requests(cls, v, 41)  # noqa: E731
    elif case == "bad":
        jargs, targs = (jd, jp, jd, jbad), (td, tp, td, tbad)
    else:
        from repro.config import MoEConfig as JMoEConfig
        from repro.core.upcycle import upcycle_config as jax_upcycle_config

        jm = jax_upcycle_config(jd, JMoEConfig(**MOE))
        jmp = jax_upcycle_params(jd, jm, jp, jax.random.PRNGKey(0))
        jargs, targs = (jm, jmp, jd, jp), (_moe_cfg(td), to_torch(jmp), td, tp)
        if case == "upcycled_int8_kv":
            kw["quant_kv"] = "int8"
    jeng = JSpec(*jargs, draft_k=3, **kw)
    jout = jeng.run(reqs(JRequest, jd.vocab_size))
    teng = SpeculativeEngine(*targs, draft_k=3, device="cpu", **kw)
    tout = teng.run(reqs(Request, td.vocab_size))
    assert tout == jout, {r: (tout[r], jout[r]) for r in jout if tout[r] != jout[r]}
    for k in ("spec_steps", "drafted_tokens", "accepted_tokens"):
        assert getattr(teng, k) == getattr(jeng, k), k
    assert teng.kv_stats()["speculation"] == jeng.kv_stats()["speculation"]
    if case == "upcycled_int8_kv":
        assert teng.cfg.quant_kv == "int8" and teng.draft_cfg.quant_kv == "none"
        assert teng.draft_pool_dev["stack"]["slot0"]["attn"]["k"].dtype == torch.float32


def _live_kv(pool, table_row, L: int, ps: int):
    """Every leaf of the pool at logical positions 0..L-1 of one row: (P, L,
    ...) each."""
    pos = torch.arange(L)
    pages = torch.as_tensor(table_row, dtype=torch.long)[pos // ps]
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            out.append(t[:, pages, pos % ps])

    walk(pool["stack"])
    return out


def _fresh_kv(cfg, params, tokens, ps: int):
    """The drafter's KV of ``tokens`` prefilled in one chunk into a fresh
    pool."""
    L = len(tokens)
    n = -(-L // ps)
    pool = init_paged_pool(cfg, n + 1, ps, device="cpu")
    bt = torch.arange(n, dtype=torch.int32)[None]
    one = lambda x: torch.tensor([x], dtype=torch.int32)  # noqa: E731
    paged_forward(cfg, params, pool, torch.as_tensor(np.asarray(tokens, np.int64))[None], one(0), bt, one(L))
    return _live_kv(pool, bt[0].numpy(), L, ps)


def test_draft_pool_lockstep_under_defrag_and_cow(dense):
    """With the prefix cache (COW clones) and a defrag every other step, the
    drafter's pool at every live position of every decoding row equals a
    freshly prefilled one, and the tokens stay plain greedy decode's."""
    _, cfg, _, p, _, bad = dense
    kw = dict(KW, prefix_cache=True, num_pages=24)
    eng = SpeculativeEngine(cfg, p, cfg, bad, draft_k=3, device="cpu", **kw)
    reqs = _shared_prefix_requests(Request, cfg.vocab_size, 43, n=6)
    for r in reqs:
        eng.submit(r)
    moved = checked = 0
    with torch.inference_mode():
        for i in range(200):
            if not eng.has_work:
                break
            eng.step()
            if i % 2 == 1:
                moved += eng.defrag()
                eng.page_pool.check_invariants()
            for slot, sr in eng.sched.running.items():
                if sr.in_prefill or sr.decode_pos < 1:
                    continue
                req = eng._rid2req[sr.rid]
                full = np.concatenate([req.prompt, np.asarray(req.output, np.int32)])[:sr.decode_pos]
                got = _live_kv(eng.draft_pool_dev, eng.sched.tables[slot], sr.decode_pos, eng.page_size)
                for a, b in zip(got, _fresh_kv(cfg, bad, full, eng.page_size)):
                    torch.testing.assert_close(a, b, atol=FP32_ATOL, rtol=0)
                checked += 1
    assert not eng.has_work and moved > 0 and checked > 0
    assert eng.kv_stats()["prefix"]["cow_clones"] >= 1
    assert {r.rid: r.output for r in reqs} == _plain(
        cfg, p, _shared_prefix_requests(Request, cfg.vocab_size, 43, n=6), prefix_cache=True, num_pages=24)


def test_sorted_moe_verifier_through_the_kernel_wrappers(dense):
    """A sorted MoE verifier with ``use_kernel=True``: on the CPU the
    wrappers run their plain versions, and the tokens equal the plain paged
    engine's through the same wrappers."""
    _, dcfg, _, dp, _, _ = dense
    mcfg = _moe_cfg(dcfg)
    spec = SpeculativeEngine.from_upcycle(dcfg, mcfg, dp, seed=3, draft_k=2, use_kernel=True, device="cpu", **KW)
    out = spec.run(_requests(Request, mcfg.vocab_size, 47))
    plain = _plain(mcfg, upcycle_params(dcfg, mcfg, dp, 3), _requests(Request, mcfg.vocab_size, 47), use_kernel=True)
    assert out == plain and spec.acceptance_rate > 0.9


def test_int8_kv_pages(dense):
    """``quant_kv="int8"`` quantises the verifier's pages only (the drafter's
    pool follows its config); the tokens equal the plain int8 paged
    engine's."""
    _, cfg, _, p, _, _ = dense
    spec, out = _spec(cfg, p, cfg, p, _requests(Request, cfg.vocab_size, 53), quant_kv="int8")
    assert out == _plain(cfg, p, _requests(Request, cfg.vocab_size, 53), quant_kv="int8")
    assert spec.pool_dev["stack"]["slot0"]["attn"]["k"].dtype == torch.int8
    assert spec.draft_pool_dev["stack"]["slot0"]["attn"]["k"].dtype == torch.float32


def test_refusals(dense):
    _, cfg, _, p, _, _ = dense
    with pytest.raises(ValueError, match="draft_k"):
        SpeculativeEngine(cfg, p, cfg, p, draft_k=0, device="cpu", **KW)
    with pytest.raises(ValueError, match="paged"):
        SpeculativeEngine(cfg, p, cfg, p, cache_mode="ring", device="cpu", max_batch=2, max_seq=64)
    with pytest.raises(ValueError, match="mesh"):
        SpeculativeEngine(cfg, p, cfg, p, mesh=object(), device="cpu", **KW)
    other = dataclasses.replace(cfg, vocab_size=cfg.vocab_size // 2)
    with pytest.raises(ValueError, match="tokenizer"):
        SpeculativeEngine(cfg, p, other, p, device="cpu", **KW)


SMOKE = ["--arch", "llama3-e8t2", "--smoke", "--requests", "3", "--max-new", "6", "--dispatcher", "sorted",
         "--use-kernel", "--cache-mode", "paged", "--device", "cpu"]


def test_cli_speculate_upcycled_pair(capsys):
    """``--speculate 3`` on an MoE arch: its dense parent drafts for the
    upcycled model; every request is answered."""
    out = serve_cli(SMOKE + ["--speculate", "3"])
    text = capsys.readouterr().out
    assert sorted(out) == [0, 1, 2] and all(len(v) == 6 for v in out.values())
    line = next(ln for ln in text.splitlines() if "speculation:" in ln)
    assert "k=3" in line and "acceptance" in line


def test_cli_speculate_with_a_draft_arch(capsys):
    """``--draft-arch llama3-8b`` drafts with an independent dense model: the
    served model is the plain run's, and so are its tokens."""
    plain = serve_cli(SMOKE)
    spec = serve_cli(SMOKE + ["--speculate", "3", "--draft-arch", "llama3-8b"])
    assert spec == plain
    assert "speculation: k=3" in capsys.readouterr().out


def test_cli_speculate_needs_the_paged_cache():
    argv = [a for a in SMOKE if a not in ("--cache-mode", "paged")]
    with pytest.raises(SystemExit):
        serve_cli(argv + ["--speculate", "3"])
