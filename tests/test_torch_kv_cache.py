"""Port parity of the host-side paged-KV policy: the port's ``PagePool``,
``PrefixCache`` and ``ChunkedScheduler`` driven side by side with the JAX
package's by one random stream (a copy of ``simulate`` from
tests/test_serving_properties.py). At every step the two ``StepPlan``s and
block tables must be equal, and the port's invariants must hold.

One difference is deliberate: the JAX ``PrefixCache.insert`` grafts a
request's pages under a cached page the request does not reference, which
breaks its monotone-refcount invariant (ROADMAP queue 3); the port keeps
that tail private. From the first step at which the port promoted fewer
pages than the JAX package (the fix fired), the plans may differ: the
comparison stops there for that stream and the port runs on alone, still
checked, to the end."""
import numpy as np
import pytest

from test_serving_properties import _check_tables
from test_serving_properties import simulate as j_simulate

from repro.serving import kv_cache as j_kv
from repro.serving import scheduler as j_sched
from repro_torch.serving import kv_cache as t_kv
from repro_torch.serving import scheduler as t_sched

MAX_PAGES = 16


def _make(kv, sched, num_pages, ps, max_batch, chunk, window, watermark, dp_shards, prefix):
    pool = kv.PagePool(num_pages, ps, num_shards=dp_shards)
    if prefix:
        pool.enable_prefix_cache()
    cfg = sched.SchedulerConfig(max_batch, ps, chunk, max_pages_per_seq=MAX_PAGES,
                                watermark=watermark, window=window, dp_shards=dp_shards)
    return pool, sched.ChunkedScheduler(cfg, pool)


def _plan_key(plan):
    return ([(c.rid, c.slot, c.start, c.length, c.final) for c in plan.prefills],
            list(plan.decode_slots), list(plan.preempted), list(plan.expired),
            [tuple(map(int, c)) for c in plan.cow_copies])


def simulate_side_by_side(seed, num_pages=12, ps=4, max_batch=3, chunk=8, window=None,
                          n_req=8, watermark=1, eos_p=0.05, defrag_every=0, max_steps=3000,
                          dp_shards=1, prefix=False):
    """Drive both packages with the random stream of ``simulate``. Returns
    (steps, steps compared, step at which the port's fix fired or None)."""
    rng = np.random.default_rng(seed)
    geom = (num_pages, ps, max_batch, chunk, window, watermark, dp_shards, prefix)
    j_pool, js = _make(j_kv, j_sched, *geom)
    t_pool, ts = _make(t_kv, t_sched, *geom)
    stems = [rng.integers(0, 50, size=int(rng.integers(1, 3 * ps))) for _ in range(3)]
    pending = []
    for rid in range(n_req):
        p, m = int(rng.integers(1, 20)), int(rng.integers(1, 10))
        if t_pool.pages_for(p + m) <= MAX_PAGES and ts._live_bound(p + m) <= t_pool.pages_per_shard:
            toks = None
            if prefix:
                stem = stems[int(rng.integers(0, len(stems)))][:p]
                tail = rng.integers(0, 50, size=p - len(stem))
                toks = np.concatenate([stem, tail]).astype(np.int32)
            pending.append((rid, p, m, toks))
    both, diverged_at = True, None
    submitted, finished = set(), set()
    steps = compared = 0

    def scheds():
        return (ts, js) if both else (ts,)

    while (pending or ts.has_work) and steps < max_steps:
        steps += 1
        while pending and rng.random() < 0.5:
            rid, p, m, toks = pending.pop(0)
            for s in scheds():
                s.submit(rid, p, m, tokens=toks)
            submitted.add(rid)
        plans = [s.plan() for s in scheds()]
        t_pool.check_invariants()
        _check_tables(ts)
        if both:
            assert _plan_key(plans[0]) == _plan_key(plans[1]), f"step {steps}"
            np.testing.assert_array_equal(ts.tables, js.tables, err_msg=f"step {steps}")
            compared += 1
        plan = plans[0]
        for c in plan.prefills:
            if prefix:
                for s in scheds():
                    s.note_prefilled(c.rid, c.start + c.length)
            if c.final:
                req = ts.running[c.slot]
                done = req.generated + 1 >= req.max_new_tokens or rng.random() < eos_p
                for s in scheds():
                    s.on_token(c.slot, done)
                if done:
                    finished.add(c.rid)
        for slot in plan.decode_slots:
            req = ts.running[slot]
            done = req.generated + 1 >= req.max_new_tokens or rng.random() < eos_p
            for s in scheds():
                s.on_token(slot, done)
            if done:
                finished.add(req.rid)
        if defrag_every and steps % defrag_every == 0:
            mappings = [s.pool.defrag() for s in scheds()]
            if both:
                assert mappings[0] == mappings[1], f"defrag at step {steps}"
            for s, mp in zip(scheds(), mappings):
                if mp:
                    s.apply_defrag(mp)
            t_pool.check_invariants()
            _check_tables(ts)
        if both and prefix and t_pool.prefix.inserted_pages != j_pool.prefix.inserted_pages:
            both, diverged_at = False, steps
    assert not ts.has_work and not pending, f"live work after {steps} steps"
    assert finished == submitted
    assert not t_pool._owned and not t_pool._refs
    t_pool.drop_prefix_cache()
    t_pool.check_invariants()
    assert t_pool.free_pages == num_pages
    return steps, compared, diverged_at


STREAMS = {
    "plain": {},
    "window": dict(window=6),
    "prefix": dict(prefix=True),
    "defrag": dict(defrag_every=3),
    "prefix_defrag": dict(prefix=True, defrag_every=3),
    "tight": dict(num_pages=7, n_req=10),
}


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_plans_and_tables_equal_jax(seed, stream):
    steps, compared, diverged_at = simulate_side_by_side(seed, **STREAMS[stream])
    if diverged_at is None:
        assert compared == steps
    else:
        assert compared == diverged_at and STREAMS[stream].get("prefix")


@pytest.mark.parametrize("seed", range(4))
def test_dp_sharded_stream_equal_jax(seed):
    steps, compared, diverged_at = simulate_side_by_side(
        seed, num_pages=12, ps=2, max_batch=4, dp_shards=2, n_req=10)
    assert diverged_at is None and compared == steps


PINNED = dict(num_pages=13, ps=2, max_batch=2, chunk=1, window=None, n_req=6, prefix=True)


def test_prefix_refcount_invariant_case_pinned():
    """The smallest stream on which the JAX prefix cache breaks its own
    invariant (kv_cache.py, ``PrefixCache.check``: refcounts must not grow
    down a trie path). The port keeps every invariant through it, and its
    plans equal the JAX package's up to the step at which its insert
    declines to graft under an unreferenced page."""
    with pytest.raises(AssertionError, match="refcount not monotone"):
        j_simulate(1640, **PINNED)
    steps, compared, diverged_at = simulate_side_by_side(1640, **PINNED)
    assert diverged_at is not None and compared == diverged_at < steps


PINNED_2 = dict(num_pages=8, ps=4, max_batch=2, chunk=8, window=None, n_req=6, prefix=True)


def test_prefix_refcount_invariant_second_case_pinned():
    """A second stream on which the JAX prefix cache breaks the same
    invariant (larger pages and prefill chunks than the first pinned case).
    The port keeps every invariant through it, and its plans equal the JAX
    package's up to the step at which its insert declines to graft under an
    unreferenced page."""
    with pytest.raises(AssertionError, match="refcount not monotone"):
        j_simulate(127, **PINNED_2)
    steps, compared, diverged_at = simulate_side_by_side(127, **PINNED_2)
    assert diverged_at is not None and compared == diverged_at < steps


PINNED_3 = dict(num_pages=14, ps=1, max_batch=2, chunk=1, window=None, n_req=6, prefix=True)


def test_prefix_refcount_invariant_third_case_pinned():
    """A third stream on which the JAX prefix cache breaks the same
    invariant, with one-token pages. The port keeps every invariant through
    it, and its plans equal the JAX package's up to the step at which its
    insert declines to graft under an unreferenced page."""
    with pytest.raises(AssertionError, match="refcount not monotone"):
        j_simulate(2683, **PINNED_3)
    steps, compared, diverged_at = simulate_side_by_side(2683, **PINNED_3)
    assert diverged_at is not None and compared == diverged_at < steps
