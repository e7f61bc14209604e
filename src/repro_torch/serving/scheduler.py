"""Continuous-batching scheduler with chunked prefill over a page pool
(port of ``repro.serving.scheduler``, the whole module: host-side policy in
numpy and Python, no model and no device tensors).

Policy layer only — no model, no device arrays — so the property suite can
drive it with simulated token streams. Each :meth:`ChunkedScheduler.plan`
call produces one engine step:

* **admission**: FIFO from the queue into free batch slots, gated by the
  free-page budget (a request is admitted only if its whole prompt fits,
  plus ``watermark`` reserve pages — chunked prefill then spreads the
  actual allocation over several steps). Under ``dp_shards > 1`` the batch
  slots are partitioned into contiguous blocks (one per DP shard, matching
  the mesh 'data' sharding of the decode batch) and each shard owns one
  sub-pool: the head request is placed into the free slot whose shard has
  the largest free-page budget, so load balances across shard pools while
  admission still reasons over the aggregate (a request blocked on every
  shard blocks the queue, FIFO preserved).
* **chunked prefill**: each prefilling slot contributes at most
  ``prefill_chunk`` prompt tokens per step, so a long prompt interleaves
  with decode instead of stalling the batch. The chunk length is static
  (the last chunk is right-padded), so ONE compiled prefill step serves
  every chunk of every request.
* **decode**: every slot whose prompt is fully prefilled decodes one token.
* **preemption**: when the pool cannot supply a page, the *youngest*
  running request is evicted (pages freed, requeued at the front for
  recompute — its generated tokens become prompt suffix). Victims are
  always strictly younger than the request that needs the page, so the
  oldest request always makes progress and every submitted request
  terminates (provided the pool can hold one maximal request — enforced at
  ``submit``). With ``dp_shards > 1`` victims come from the *same shard*
  as the starved request — only their pages live in that sub-pool — and
  the termination argument applies per shard (each shard's oldest request
  always progresses).
* **sliding window**: with ``window`` set, pages that fall entirely below
  the window of every future query are released immediately — the window
  mask already excludes them, so paged decode holds O(window) KV per
  request where the full-context mapping would hold O(position).
* **prefix-cache admission credit**: when the pool has a
  :class:`~repro_torch.serving.kv_cache.PrefixCache` and the request carries its
  token ids, admission matches the prompt against the per-shard radix trie
  and *credits* the hit pages against the budget — a request whose prompt
  is mostly cached system prompt admits with near-zero new pages. On
  placement the hit pages are refcount-attached into the block table and
  ``prefilled`` skips past them (a fully-covered prompt COW-clones its
  last page so the final-token recompute chunk never writes a shared
  page); the engine promotes freshly-prefilled full prompt pages back into
  the trie via :meth:`ChunkedScheduler.note_prefilled`. Budgets count
  refcount-0 cache pages as available (``PagePool.available_in``) since
  ``alloc`` reclaims them on demand — retained cache never stalls
  admission a cache-less pool would have granted. Incompatible with
  ``window`` (shared pages must be immutable; a window releases them).
* **graceful degradation** (opt-in): ``max_queue``/``shed_watermark``
  bound the backlog at :meth:`submit` — a request that would overflow the
  queue or outrun the pool's spare capacity is rejected with a typed
  :class:`~repro_torch.resilience.ShedError` (the client backs off)
  instead of being silently enqueued into an unservable backlog.
  ``deadline_steps`` (config default, overridable per request) evicts
  requests that have aged past their step budget at the top of each
  :meth:`plan` — queued or running — freeing their pages for work that can
  still meet its deadline. Evictions are loud: the rid lands in
  ``StepPlan.expired`` and the request's ``status`` becomes ``"deadline"``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.resilience import ShedError
from repro_torch.serving.kv_cache import PagePool


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int
    page_size: int
    prefill_chunk: int
    max_pages_per_seq: int
    watermark: int = 0  # free pages kept in reserve at admission (per shard)
    window: Optional[int] = None  # sliding window: release dead pages
    dp_shards: int = 1  # batch-slot/sub-pool partitions (EP x DP serving)
    # graceful degradation (None = disabled, the seed behavior):
    deadline_steps: Optional[int] = None  # evict requests older than this
    max_queue: Optional[int] = None  # shed submits past this queue depth
    shed_watermark: Optional[int] = None  # shed when spare pages dip below


@dataclasses.dataclass
class SchedRequest:
    rid: int
    prompt_len: int  # current prompt (grows by generated tokens on preempt)
    max_new_tokens: int
    orig_prompt_len: int = 0
    admit_seq: int = -1  # admission order; -1 = never admitted
    slot: int = -1
    prefilled: int = 0  # prompt tokens already in the cache
    generated: int = 0  # output tokens emitted (across preemptions)
    gen_base: int = 0  # outputs folded into prompt_len by preemption
    logical_pages: int = 0  # logical pages ever allocated (monotone)
    preemptions: int = 0
    done: bool = False
    submit_step: int = 0  # scheduler step count at submit (deadline clock)
    deadline_steps: Optional[int] = None  # per-request deadline override
    status: str = "ok"  # "ok" | "deadline" (evicted past its deadline)
    tokens: Optional[np.ndarray] = None  # prompt ids (prefix-cache key)
    prefix_hit_tokens: int = 0  # prompt tokens served from cache (last admit)

    @property
    def in_prefill(self) -> bool:
        return self.prefilled < self.prompt_len

    @property
    def decode_pos(self) -> int:
        """Cache position the next decode step writes: the prompt plus the
        outputs emitted since the last (re)prefill, minus the one output
        that has not been fed back yet."""
        return self.prompt_len + (self.generated - self.gen_base) - 1


@dataclasses.dataclass
class PrefillChunk:
    rid: int
    slot: int
    start: int  # offset into the request's current full token list
    length: int  # real tokens this chunk (<= prefill_chunk)
    final: bool  # True => chunk logits emit the first/next output token


@dataclasses.dataclass
class StepPlan:
    prefills: List[PrefillChunk]
    decode_slots: List[int]
    preempted: List[int]  # rids evicted while building this plan
    expired: List[int] = dataclasses.field(default_factory=list)  # deadline
    # COW clones from prefix-cache admission: (src_phys, dst_phys) device
    # page copies the engine must apply BEFORE running this step's chunks
    cow_copies: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


class ChunkedScheduler:
    def __init__(self, cfg: SchedulerConfig, pool: PagePool):
        assert pool.page_size == cfg.page_size
        assert pool.num_shards == cfg.dp_shards, (pool.num_shards, cfg.dp_shards)
        assert cfg.max_batch % cfg.dp_shards == 0, (cfg.max_batch, cfg.dp_shards)
        if pool.prefix is not None and cfg.window is not None:
            raise ValueError(
                "prefix cache and sliding window are mutually exclusive: "
                "shared pages must be immutable, a window releases them"
            )
        self.cfg = cfg
        self.pool = pool
        self.slots_per_shard = cfg.max_batch // cfg.dp_shards
        self.queue: Deque[SchedRequest] = deque()
        self.running: Dict[int, SchedRequest] = {}  # slot -> request
        self.requests: Dict[int, SchedRequest] = {}  # rid -> request
        self.tables = np.full((cfg.max_batch, cfg.max_pages_per_seq), -1, np.int64)
        self._admit_counter = 0
        self.peak_resident_requests = 0  # max concurrent running (bench)
        self.step_count = 0  # plan() calls; the deadline clock
        self.shed_count = 0  # submits rejected by max_queue/shed_watermark
        self.deadline_evictions = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from cache (total)

    # -- submission ---------------------------------------------------------
    def submit(self, rid: int, prompt_len: int, max_new_tokens: int,
               deadline_steps: Optional[int] = None,
               tokens: Optional[np.ndarray] = None) -> None:
        total = prompt_len + max_new_tokens
        need = self.pool.pages_for(total)
        if need > self.cfg.max_pages_per_seq:
            raise ValueError(
                f"request {rid}: {total} tokens need {need} pages "
                f"> max_pages_per_seq={self.cfg.max_pages_per_seq}"
            )
        # with a sliding window dead pages are released as decode advances,
        # so the live set is bounded by the window span, not the total.
        # A request lives entirely in one shard's sub-pool, so the bound is
        # per-shard capacity, not the aggregate.
        live = self._live_bound(total)
        if live > self.pool.pages_per_shard:
            raise ValueError(
                f"request {rid}: needs {live} live pages > per-shard pool "
                f"of {self.pool.pages_per_shard}"
            )
        # load shedding: reject at the door (typed, actionable) rather than
        # queueing work the engine cannot serve in bounded time
        if (self.cfg.max_queue is not None
                and len(self.queue) >= self.cfg.max_queue):
            self.shed_count += 1
            raise ShedError(
                f"request {rid} shed: queue depth {len(self.queue)} at "
                f"max_queue={self.cfg.max_queue}; back off and resubmit"
            )
        if self.cfg.shed_watermark is not None:
            backlog = sum(
                self._live_bound(r.prompt_len + r.max_new_tokens)
                for r in self.queue
            )
            free = sum(
                self.pool.available_in(sh)
                for sh in range(self.cfg.dp_shards)
            )
            if free - self.cfg.shed_watermark < live + backlog:
                self.shed_count += 1
                raise ShedError(
                    f"request {rid} shed: needs {live} pages + {backlog} "
                    f"queued, but only {free} free "
                    f"(shed_watermark={self.cfg.shed_watermark}); back off "
                    "and resubmit"
                )
        if tokens is not None:
            assert len(tokens) == prompt_len, (len(tokens), prompt_len)
        req = SchedRequest(
            rid=rid, prompt_len=prompt_len, max_new_tokens=max_new_tokens,
            orig_prompt_len=prompt_len, submit_step=self.step_count,
            deadline_steps=deadline_steps, tokens=tokens,
        )
        self.requests[rid] = req
        self.queue.append(req)

    # -- queries ------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    def block_table(self, slot: int) -> np.ndarray:
        return self.tables[slot]

    def shard_of_slot(self, slot: int) -> int:
        """DP shard owning ``slot``: contiguous slot blocks, matching the
        mesh 'data' sharding of the decode batch rows."""
        return slot // self.slots_per_shard

    # -- planning -----------------------------------------------------------
    def plan(self) -> StepPlan:
        self.step_count += 1
        preempted: List[int] = []
        cow_copies: List[Tuple[int, int]] = []
        expired = self._expire()
        self._admit(cow_copies)
        self.peak_resident_requests = max(
            self.peak_resident_requests, len(self.running)
        )
        prefills: List[PrefillChunk] = []
        # oldest first, so page pressure evicts the newest work
        for slot, req in sorted(self.running.items(), key=lambda kv: kv[1].admit_seq):
            if self.running.get(slot) is not req:
                continue  # evicted by an older request earlier in this loop
            if not req.in_prefill:
                continue
            length = min(self.cfg.prefill_chunk, req.prompt_len - req.prefilled)
            end = req.prefilled + length
            # release dead window pages BEFORE allocating for this chunk —
            # and only up to the pre-chunk boundary: the chunk's earliest
            # query (position `start`) still sees kpos > start - window
            self._release_dead(req, stored=req.prefilled)
            if not self._ensure_pages(req, end, preempted):
                continue  # stalled this step; oldest-first makes it retry
            prefills.append(PrefillChunk(
                rid=req.rid, slot=slot, start=req.prefilled, length=length,
                final=(end == req.prompt_len),
            ))
            req.prefilled = end
        decode_slots: List[int] = []
        for slot, req in sorted(self.running.items(), key=lambda kv: kv[1].admit_seq):
            if self.running.get(slot) is not req:
                continue  # evicted by an older request earlier in this loop
            if req.in_prefill or req.rid in {c.rid for c in prefills}:
                continue
            if self._ensure_pages(req, req.decode_pos + 1, preempted):
                decode_slots.append(slot)
        # a request whose chunk was planned above may have been evicted by an
        # older request's allocation — its pages are gone, drop its actions
        if preempted:
            gone = set(preempted)
            prefills = [c for c in prefills if c.rid not in gone]
            # a preempted hit-request's COW target page was freed with it
            live_cows = []
            for src, dst in cow_copies:
                holder = next((r for r in self.running.values()
                               if dst in self.pool.owned(r.rid)), None)
                if holder is not None:
                    live_cows.append((src, dst))
            cow_copies = live_cows
        return StepPlan(prefills, decode_slots, preempted, expired, cow_copies)

    def on_token(self, slot: int, done: bool) -> None:
        """Record one output token for ``slot`` (from a decode step or a
        final prefill chunk); frees everything when the request is done."""
        req = self.running[slot]
        req.generated += 1
        if done:
            req.done = True
            self.pool.free_request(req.rid)
            self.tables[slot] = -1
            del self.running[slot]
        else:
            # generated was just bumped, so decode_pos == tokens now stored
            self._release_dead(req, stored=req.decode_pos)

    def oldest_request_age(self) -> int:
        """Steps since the oldest live (queued or running) request was
        submitted — the engine health snapshot's staleness headline."""
        live = list(self.queue) + list(self.running.values())
        if not live:
            return 0
        return self.step_count - min(r.submit_step for r in live)

    # -- internals ----------------------------------------------------------
    def _expire(self) -> List[int]:
        """On-time eviction: terminate every queued/running request whose
        age exceeds its deadline (per-request override, else the config
        default). Pages are freed immediately so the reclaimed capacity
        serves requests that can still meet their deadlines."""
        out: List[int] = []
        for req in list(self.queue) + list(self.running.values()):
            dl = (req.deadline_steps if req.deadline_steps is not None
                  else self.cfg.deadline_steps)
            if dl is None or self.step_count - req.submit_step <= dl:
                continue
            if req.slot >= 0:
                self.pool.free_request(req.rid)
                self.tables[req.slot] = -1
                del self.running[req.slot]
            else:
                self.queue.remove(req)
            req.done = True
            req.status = "deadline"
            self.deadline_evictions += 1
            out.append(req.rid)
        return out

    def _admit(self, cow_copies: Optional[List[Tuple[int, int]]] = None) -> None:
        while self.queue:
            free_slots = [
                s for s in range(self.cfg.max_batch) if s not in self.running
            ]
            if not free_slots:
                return
            req = self.queue[0]
            need = self._live_bound(req.prompt_len)
            # Pages already promised to admitted-but-still-prefilling
            # requests count against the budget, so two large prompts
            # cannot both be admitted into the same free sub-pool. An idle
            # shard waives the watermark — a request that fits its raw
            # sub-pool must always be admittable (deadlock avoidance).
            # Budgets are per shard; the head request takes the free slot
            # whose shard has the most headroom (ties -> lowest slot, which
            # at dp_shards=1 is exactly the original FIFO slot choice).
            # Prefix-cache hit pages count as credit: a cached prompt needs
            # only its uncached tail from the budget, so hit requests admit
            # with near-zero new pages.
            best_slot, best_headroom, best_credit = None, None, 0
            for slot in free_slots:
                shard = self.shard_of_slot(slot)
                credit = len(self._prefix_match(req, shard))
                headroom = self._shard_budget(shard) + credit
                if best_headroom is None or headroom > best_headroom:
                    best_slot, best_headroom, best_credit = slot, headroom, credit
            if best_headroom < need:
                return  # head-of-line blocking preserves FIFO order
            self.queue.popleft()
            req.slot = best_slot
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.running[req.slot] = req
            if best_credit:
                self._attach_prefix(req, cow_copies if cow_copies is not None
                                    else [])

    def _prefix_match(self, req: SchedRequest, shard: int) -> List[int]:
        """Cached pages covering ``req``'s prompt head on ``shard`` (empty
        without a prefix cache or prompt tokens)."""
        if self.pool.prefix is None or req.tokens is None:
            return []
        return self.pool.prefix.match(req.tokens, shard)

    def _attach_prefix(self, req: SchedRequest,
                       cow_copies: List[Tuple[int, int]]) -> None:
        """Refcount-attach the cached prefix pages into ``req``'s block
        table and skip ``prefilled`` past them. A fully-covered prompt
        COW-clones its last page: the final-token recompute chunk (which
        must run — its logits emit the first output token) scatters into
        the private clone, never into a shared page."""
        shard = self.shard_of_slot(req.slot)
        pages = self.pool.prefix.acquire(req.rid, req.tokens, shard)
        if not pages:
            return
        ps = self.cfg.page_size
        if len(pages) * ps >= req.prompt_len:
            new = self.pool.cow(req.rid, pages[-1])
            if new is None:  # shard dry: shrink the hit by one page instead
                self.pool.detach(req.rid, [pages[-1]])
                pages = pages[:-1]
            else:
                cow_copies.append((pages[-1], new))
                pages = pages[:-1] + [new]
        if not pages:
            return
        for j, p in enumerate(pages):
            self.tables[req.slot, j] = p
        req.logical_pages = len(pages)
        req.prefilled = min(len(pages) * ps, req.prompt_len - 1)
        req.prefix_hit_tokens = req.prefilled
        self.prefix_hit_tokens += req.prefilled

    def note_prefilled(self, rid: int, covered: int) -> int:
        """Engine callback after a prefill chunk actually ran: promote the
        request's freshly-written private pages covering full *original
        prompt* token runs ``[0, covered)`` into the prefix cache. Returns
        pages newly promoted. No-op without a cache / prompt tokens, or if
        the request was preempted before the chunk's effects were
        recorded."""
        req = self.requests[rid]
        if (self.pool.prefix is None or req.tokens is None or req.slot < 0
                or self.running.get(req.slot) is not req):
            return 0
        full = min(covered, len(req.tokens)) // self.cfg.page_size
        if full <= 0:
            return 0
        return self.pool.prefix.insert(
            rid, req.tokens, full, self.tables[req.slot]
        )

    def ensure_lookahead(self, slot: int, extra: int) -> int:
        """Map pages for up to ``extra`` tokens beyond the next decode
        write WITHOUT preemption — speculative lookahead must not evict
        admitted work. Returns the lookahead actually backed by pages
        (falls back toward 0 when the shard is tight)."""
        req = self.running[slot]
        shard = self.shard_of_slot(slot)
        while extra > 0:
            need = self.pool.pages_for(req.decode_pos + 1 + extra)
            n_new = need - req.logical_pages
            if n_new <= 0:
                break
            if n_new <= self.pool.available_in(shard):
                pages = self.pool.alloc(req.rid, n_new, shard=shard)
                if pages is not None:
                    for i, p in enumerate(pages):
                        self.tables[slot, req.logical_pages + i] = p
                    req.logical_pages = need
                    break
            extra -= 1
        return max(extra, 0)

    def _shard_budget(self, shard: int) -> int:
        """Allocatable pages of ``shard``'s sub-pool (free + reclaimable
        refcount-0 cache pages) minus its admission reserve (watermark +
        pages committed to still-prefilling residents). A resident's
        commitment counts every page backing it — private and
        shared-referenced (``PagePool.held``) — so a prefix-hit request
        reserves only its uncached tail."""
        residents = [
            r for r in self.running.values()
            if self.shard_of_slot(r.slot) == shard
        ]
        committed = sum(
            max(0, self._live_bound(r.prompt_len) - self.pool.held(r.rid))
            for r in residents if r.in_prefill
        )
        reserve = self.cfg.watermark + committed if residents else 0
        return self.pool.available_in(shard) - reserve

    def _live_bound(self, tokens: int) -> int:
        """Peak live pages a span of ``tokens`` can pin. With a sliding
        window, at most ``window + prefill_chunk - 1`` KV positions are
        live at once (the window span plus the chunk being written), and a
        span of L positions straddles at most pages_for(L) + 1 pages."""
        need = self.pool.pages_for(tokens)
        if self.cfg.window is not None:
            span = self.cfg.window + max(self.cfg.prefill_chunk - 1, 0)
            need = min(need, self.pool.pages_for(span) + 1)
        return need

    def _ensure_pages(self, req: SchedRequest, upto_tokens: int,
                      preempted: List[int]) -> bool:
        """Allocate pages (from ``req``'s shard sub-pool) so logical slots
        [0, upto_tokens) are mapped, evicting strictly-younger same-shard
        requests if that sub-pool runs dry. False if the request must stall
        this step."""
        need = self.pool.pages_for(upto_tokens)
        shard = self.shard_of_slot(req.slot)
        while need > req.logical_pages:
            n_new = need - req.logical_pages
            pages = self.pool.alloc(req.rid, n_new, shard=shard)
            if pages is None:
                if self.pool.available_in(shard) >= n_new:
                    # the sub-pool could have satisfied this: a transient
                    # alloc failure (fault injection / flaky allocator),
                    # not genuine pressure — stall this step and retry
                    # instead of evicting innocents
                    return False
                victim = self._youngest_running(older_than=req, shard=shard)
                if victim is None:
                    sh_seqs = [
                        r.admit_seq for r in self.running.values()
                        if self.shard_of_slot(r.slot) == shard
                    ]
                    # "too small" only when everything non-reclaimable in
                    # the shard already backs this request (held counts
                    # private + shared-referenced pages; refcount-0 cache
                    # pages would have been reclaimed by alloc)
                    if req.admit_seq == min(sh_seqs) and (
                        self.pool.used_pages_in(shard)
                        - self.pool.evictable_in(shard)
                        == self.pool.held(req.rid)
                    ):
                        raise RuntimeError(
                            f"page pool shard ({self.pool.pages_per_shard} "
                            f"pages) too small for request {req.rid} alone"
                        )
                    return False
                self._preempt(victim)
                preempted.append(victim.rid)
                continue
            for i, p in enumerate(pages):
                self.tables[req.slot, req.logical_pages + i] = p
            req.logical_pages = need
        return True

    def _youngest_running(self, older_than: SchedRequest,
                          shard: int) -> Optional[SchedRequest]:
        """Youngest running request in ``shard`` strictly younger than
        ``older_than`` — only its pages can relieve that shard's pool."""
        cands = [
            r for r in self.running.values()
            if r.admit_seq > older_than.admit_seq
            and self.shard_of_slot(r.slot) == shard
        ]
        return max(cands, key=lambda r: r.admit_seq) if cands else None

    def _preempt(self, victim: SchedRequest) -> None:
        """Evict by recompute: free the pages, fold generated tokens into
        the prompt, requeue at the front."""
        self.pool.free_request(victim.rid)
        self.tables[victim.slot] = -1
        del self.running[victim.slot]
        victim.prompt_len = victim.orig_prompt_len + victim.generated
        victim.gen_base = victim.generated
        victim.prefilled = 0
        victim.logical_pages = 0
        victim.slot = -1
        victim.admit_seq = -1
        victim.preemptions += 1
        victim.prefix_hit_tokens = 0  # re-admission re-attaches from the trie
        self.queue.appendleft(victim)

    def _release_dead(self, req: SchedRequest, stored: int) -> None:
        """With a sliding window, free pages no future query can see. A
        future query at position >= ``stored`` masks kpos <= pos - window,
        so page j is dead once (j+1)*ps - 1 <= stored - window."""
        w = self.cfg.window
        if w is None:
            return
        ps = self.cfg.page_size
        dead = []
        for j in range(req.logical_pages):
            phys = self.tables[req.slot, j]
            if phys >= 0 and (j + 1) * ps - 1 <= stored - w:
                dead.append((j, int(phys)))
        if dead:
            self.pool.release(req.rid, [p for _, p in dead])
            for j, _ in dead:
                self.tables[req.slot, j] = -1

    def apply_defrag(self, mapping: Dict[int, int]) -> None:
        """Rewrite block tables after ``PagePool.defrag`` (the engine
        permutes the device pool with the same mapping)."""
        for old, new in mapping.items():
            self.tables[self.tables == old] = -2 - new  # two-phase to avoid clashes
        neg = self.tables <= -2
        self.tables[neg] = -2 - self.tables[neg]
