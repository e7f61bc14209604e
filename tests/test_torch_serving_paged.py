"""Port parity of paged serving: the port's ``ServingEngine(cache_mode=
"paged")`` emits the JAX paged engine's greedy tokens exactly on the tiny
MoE (sorted dispatcher, fp32) — kernels' plain versions on and off, a pool
small enough to preempt, a mid-stream defrag, the prefix cache and int8 KV
pages — and the port's ring engine's tokens; plus the paged CLI on the
CPU and the options that still raise."""
import numpy as np
import pytest

from torch_parity import configs, jax_params, to_torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.resilience import ShedError
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

PAGED = dict(cache_mode="paged", page_size=8, prefill_chunk=16, dispatcher="sorted")


def _requests(cls, vocab, seed=11, n=6, lmax=40, new=(3, 8)):
    """As tests/test_serving_paged.py:_requests: n requests through fewer
    slots, so slots are refilled mid-stream."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(3, lmax))).astype(np.int32),
                max_new_tokens=int(rng.integers(*new)))
            for i in range(n)]


def _shared_prefix_requests(cls, vocab, seed=5, n=6, stem_len=12):
    """As tests/test_serving_paged.py:_shared_prefix_requests: one shared
    stem; rid 4 is the bare stem (a full-coverage hit, copied on write)."""
    rng = np.random.default_rng(seed)
    stem = rng.integers(0, vocab, stem_len).astype(np.int32)
    reqs = []
    for i in range(n):
        t = rng.integers(0, vocab, int(rng.integers(1, 10))).astype(np.int32)
        prompt = stem.copy() if i == 4 else np.concatenate([stem, t])
        reqs.append(cls(rid=i, prompt=prompt, max_new_tokens=int(rng.integers(3, 6))))
    return reqs


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = configs()
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, to_torch(jp)


def _pair(moe, reqs_fn=_requests, max_batch=3, max_seq=64, **kw):
    jcfg, tcfg, jp, tp = moe
    jeng = JEngine(jcfg, jp, max_batch=max_batch, max_seq=max_seq, **kw)
    teng = TEngine(tcfg, tp, max_batch=max_batch, max_seq=max_seq, device="cpu", **kw)
    jout = jeng.run(reqs_fn(JRequest, jcfg.vocab_size))
    tout = teng.run(reqs_fn(TRequest, tcfg.vocab_size))
    assert tout == jout, {r: (tout[r], jout[r]) for r in jout if tout[r] != jout[r]}
    teng.page_pool.check_invariants()
    return jeng, teng, tout


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_engine_tokens_identical_to_jax(moe, use_kernel, quant_kv):
    jeng, teng, _ = _pair(moe, use_kernel=use_kernel, quant_kv=quant_kv, **PAGED)
    assert teng.page_pool.free_pages == teng.page_pool.num_pages  # drained
    assert teng.health() == jeng.health()
    tk, jk = teng.kv_stats(), jeng.kv_stats()
    for k in ("kv_bytes_peak", "peak_used_pages", "num_pages", "peak_resident_requests"):
        assert tk[k] == jk[k], k
    assert len(teng.timings["plan_s"]) == teng.sched.step_count
    assert teng.timings["prefill_chunk_s"] and teng.timings["decode_s"]


def test_paged_engine_under_preemption(moe):
    """A pool far below ring capacity forces preemption by recompute; the
    recomputed streams give the same tokens in both packages."""
    jeng, teng, _ = _pair(moe, reqs_fn=lambda c, v: _requests(c, v, seed=0, n=7, new=(6, 12)),
                          num_pages=8, **PAGED)
    preempt = sum(r.preemptions for r in teng.sched.requests.values())
    assert preempt > 0, "the pool was large enough that preemption never fired"
    assert preempt == sum(r.preemptions for r in jeng.sched.requests.values())


def test_paged_engine_mid_stream_defrag(moe):
    """Defrag (pool compaction and block-table rewrite) every third step is
    invisible to the tokens, which equal the JAX paged engine's."""
    jcfg, tcfg, jp, tp = moe
    kw = dict(PAGED, page_size=4, prefill_chunk=8)
    jout = JEngine(jcfg, jp, max_batch=3, max_seq=64, **kw).run(_requests(JRequest, jcfg.vocab_size, seed=13))
    eng = TEngine(tcfg, tp, max_batch=3, max_seq=64, device="cpu", **kw)
    reqs = _requests(TRequest, tcfg.vocab_size, seed=13)
    for r in reqs:
        eng.submit(r)
    moved = 0
    for i in range(200):
        if not eng.has_work:
            break
        eng.step()
        if i % 3 == 2:
            moved += eng.defrag()
            eng.page_pool.check_invariants()
    assert not eng.has_work and moved > 0
    assert {r.rid: r.output for r in reqs} == jout


def test_prefix_cache_hits_and_tokens(moe):
    """Shared-prefix traffic: the port's prefix cache hits (credited
    admission, one copy-on-write clone), and its tokens equal the same
    engine without the cache and the JAX prefix-cache engine's."""
    jcfg, tcfg, jp, tp = moe
    kw = dict(PAGED, page_size=4, prefill_chunk=8)
    reqs = _shared_prefix_requests
    plain = TEngine(tcfg, tp, max_batch=3, max_seq=64, device="cpu", **kw).run(reqs(TRequest, tcfg.vocab_size))
    jeng, teng, cached = _pair(moe, reqs_fn=reqs, prefix_cache=True, **kw)
    assert cached == plain
    p = teng.kv_stats()["prefix"]
    assert p["hits"] > 0 and p["hit_tokens"] > 0 and p["cow_clones"] >= 1
    assert p == jeng.kv_stats()["prefix"]


@pytest.mark.parametrize("quant_kv", ["none", "int8"])
def test_paged_engine_tokens_identical_to_port_ring(moe, quant_kv):
    """Paged == ring inside the port (fp32 tiny MoE). With int8 KV pages
    the tokens hold too on this input: the quantisation error of the
    logits stays below every argmax margin of these streams."""
    _, tcfg, _, tp = moe
    ring = TEngine(tcfg, tp, max_batch=3, max_seq=64, dispatcher="sorted", device="cpu")
    paged = TEngine(tcfg, tp, max_batch=3, max_seq=64, device="cpu", quant_kv=quant_kv, **PAGED)
    out_ring = ring.run(_requests(TRequest, tcfg.vocab_size))
    out_paged = paged.run(_requests(TRequest, tcfg.vocab_size))
    assert out_paged == out_ring


def test_paged_admission_options(moe):
    """Deadlines evict, the shed watermark and the queue bound raise
    ShedError, and the paged-only options raise in ring mode, as in the
    JAX engine."""
    _, tcfg, _, tp = moe
    eng = TEngine(tcfg, tp, max_batch=1, max_seq=64, device="cpu", deadline_steps=2, **PAGED)
    reqs = _requests(TRequest, tcfg.vocab_size, n=3, new=(8, 9))
    eng.run(reqs)
    assert eng.health()["deadline_evictions"] > 0 and any(r.status == "deadline" for r in reqs)
    eng = TEngine(tcfg, tp, max_batch=1, max_seq=64, device="cpu", max_queue=1, **PAGED)
    eng.submit(reqs[0])
    with pytest.raises(ShedError):
        eng.submit(reqs[1])
    eng = TEngine(tcfg, tp, max_batch=1, max_seq=64, device="cpu", num_pages=8, shed_watermark=6, **PAGED)
    with pytest.raises(ShedError):
        eng.submit(TRequest(rid=9, prompt=np.zeros(40, np.int32), max_new_tokens=8))
    for kw in (dict(prefix_cache=True), dict(deadline_steps=3), dict(shed_watermark=1),
               dict(quant_kv="int8")):
        with pytest.raises(ValueError):
            TEngine(tcfg, {}, device="cpu", **kw)


def test_paged_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    out = main(["--arch", "llama3-e8t2", "--smoke", "--requests", "6", "--max-new", "3",
                "--prompt-len", "40", "--dispatcher", "sorted", "--use-kernel", "--cache-mode",
                "paged", "--prefix-cache", "--quant-kv", "int8", "--device", "cpu"])
    assert sorted(out) == list(range(6)) and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "served 6 requests (0 shed), 18 tokens" in text and "cache=paged" in text
    assert "kv=int8" in text and "prefix cache: " in text
    hits = int(text.split("prefix cache: ")[1].split("/")[0])
    assert hits > 0
