"""Batched serving engine with two KV cache backends (port of
``repro.serving.engine``):

* ``cache_mode="ring"`` — the dense ring-buffer cache: continuous batching
  over ``max_batch`` slots, one single-request prefill per admitted request
  (padded to a power-of-two length bucket) spliced into the batch cache,
  one batched ``decode_step`` per engine step.
* ``cache_mode="paged"`` — the block-table page pool
  (``serving/kv_cache.py``), the chunked-prefill scheduler with free-page
  admission, preemption by recompute, deadlines and load shedding
  (``serving/scheduler.py``), the radix prefix cache (``prefix_cache``),
  int8 KV pages (``quant_kv="int8"``), and decode through the page table
  (``models.model.decode_step_paged``; the paged-attention kernel with
  ``use_kernel``).

Both backends take int8 expert weights (``quant_weights="int8"``: the
tree is quantised once here, a no-op on an already-quantised tree, and the
MoE layers pick the int8 kernels or the dequantising paths by key), and
fused dispatch (``fused_dispatch=True`` with ``use_kernel``: the sorted
dispatcher's gather and combine inside the grouped-GEMM kernels, bf16 or
int8). Greedy decode over both backends gives the same tokens. Like the
JAX engine, it stores ``greedy`` and never reads it: every token is an
argmax, also with ``greedy=False``. ``step`` carries the ``serving.step``
fault site (a hang) and the step watchdog: with ``step_timeout_s`` a step
over its wall budget raises :class:`HangError`. Not ported yet, and
raising ``NotImplementedError``: the EP x DP mesh mode.

Families: the ring backend serves every decoder family (GQA or MLA
attention, SSM, hybrid, MoE or not) through the length-bucketed prefill;
an SSM's bucket pad tokens stay out of its state (``models/ssm.py``). The
paged backend holds GQA attention stacks only and raises ``ValueError``
for MLA, SSM, hybrid and cross-attention configs, as the JAX engine's
pool declaration refuses them. An ``encdec`` config raises ``ValueError``:
the JAX engine cannot serve it either (its prefill reads
``batch["frames"]``, which the engine never passes); seamless generates
through ``prefill_forward`` and ``decode_step``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, with_dispatcher
from repro_torch.core.quant import quantize_params
from repro_torch.models.model import cache_decl, decode_step, decode_step_paged, paged_forward, prefill_forward
from repro_torch.params import init_from_decls, resolve_device, tree_map
from repro_torch.resilience import HangError, ShedError, faults
from repro_torch.serving.kv_cache import (
    PagePool,
    copy_pages,
    init_paged_pool,
    kv_bytes_live,
    kv_bytes_resident,
    kv_bytes_resident_per_shard,
    kv_page_bytes,
    permute_pool,
    ring_kv_bytes,
)
from repro_torch.serving.scheduler import ChunkedScheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline_steps: Optional[int] = None  # per-request deadline override
    status: str = "ok"  # "ok" | "deadline" (evicted past its deadline)


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_batch: int = 4,
        max_seq: int = 256,
        greedy: bool = True,
        dispatcher: Optional[str] = None,
        use_kernel: bool = False,
        cache_mode: str = "ring",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefill_chunk: int = 32,
        mesh=None,
        deadline_steps: Optional[int] = None,
        max_queue: Optional[int] = None,
        shed_watermark: Optional[int] = None,
        step_timeout_s: Optional[float] = None,
        prefix_cache: bool = False,
        quant_weights: str = "none",
        quant_kv: str = "none",
        fused_dispatch: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError("mesh (ROADMAP queue 1, 'Multi-GPU') not ported yet")
        if cache_mode not in ("ring", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the serving engine does not serve the encdec family (the JAX engine's prefill "
                "reads batch['frames'], which it never passes); generate through prefill_forward and "
                "decode_step with the frames instead")
        if prefix_cache and cache_mode != "paged":
            raise ValueError("prefix_cache requires cache_mode='paged'")
        if prefix_cache and cfg.sliding_window is not None:
            raise ValueError(
                "prefix_cache is incompatible with sliding_window: shared "
                "prefix pages must be immutable, a window releases them"
            )
        if cache_mode == "ring" and (deadline_steps is not None or shed_watermark is not None):
            raise ValueError(
                "deadline_steps/shed_watermark need the paged scheduler "
                "(the ring cache has no step clock or page accounting); "
                "max_queue load-shedding works in both modes"
            )
        for qv in (quant_weights, quant_kv):
            if qv not in ("none", "int8"):
                raise ValueError(f"quant mode must be 'none' or 'int8', got {qv!r}")
        # engine kwargs extend (never clear) quant modes already set on the config
        if quant_weights != "none":
            cfg = cfg.replace(quant_weights=quant_weights)
        if quant_kv != "none":
            cfg = cfg.replace(quant_kv=quant_kv)
        if cfg.quant_kv == "int8" and cache_mode != "paged":
            raise ValueError("quant_kv requires cache_mode='paged' (the scale sidecar lives in the page pool)")
        self.device = resolve_device(device)
        cfg = with_dispatcher(cfg, dispatcher)
        if fused_dispatch and cfg.moe is not None:
            # dispatch-in-kernel: sorted only (MoEConfig refuses the others)
            # and only with use_kernel (the fusion lives in the kernels)
            if not use_kernel:
                raise ValueError("fused_dispatch requires use_kernel=True")
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, fused_dispatch=True))
        self.cfg = cfg
        if cfg.quant_weights == "int8":
            params = quantize_params(params)  # idempotent
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.greedy = greedy  # stored, never read: decode is argmax (as in the JAX engine)
        self.prefix_caching = prefix_cache
        self.deadline_steps = deadline_steps
        self.max_queue = max_queue
        self.shed_watermark = shed_watermark
        self.step_timeout_s = step_timeout_s  # step watchdog (None = off)
        self.shed_count = 0  # ring-mode max_queue sheds (paged: the scheduler's)
        self.use_kernel = use_kernel
        self.cache_mode = cache_mode
        self.cache_len = max_seq if cfg.sliding_window is None else min(max_seq, cfg.sliding_window)
        if cache_mode == "paged":
            self._init_paged(page_size, num_pages, prefill_chunk)
            return
        self.cache = init_from_decls(cache_decl(cfg, max_batch, max_seq), 0, self.device)
        self.cache["slot_pos"].fill_(-1)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._next_tok = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        # host wall seconds of each prefill and each batched decode; both end
        # in a device->host read of the sampled token, so they are complete
        self.timings: Dict[str, List[float]] = {"prefill_s": [], "decode_s": []}

    # -- paged backend setup ------------------------------------------------
    def _init_paged(self, page_size, num_pages, prefill_chunk):
        maxP = math.ceil(self.max_seq / page_size)
        if num_pages is None:
            # capacity parity with the ring cache; only allocated pages count
            # as resident
            num_pages = self.max_batch * maxP
        self.page_size, self.num_pages = page_size, num_pages
        self.prefill_chunk = prefill_chunk
        self.pool_dev = init_paged_pool(self.cfg, num_pages, page_size, device=self.device)
        self.page_pool = PagePool(num_pages, page_size)
        if self.prefix_caching:
            self.page_pool.enable_prefix_cache()
        self.sched = ChunkedScheduler(
            SchedulerConfig(
                max_batch=self.max_batch, page_size=page_size,
                prefill_chunk=prefill_chunk, max_pages_per_seq=maxP,
                window=self.cfg.sliding_window,
                deadline_steps=self.deadline_steps, max_queue=self.max_queue,
                shed_watermark=self.shed_watermark,
            ),
            self.page_pool,
        )
        self._rid2req: Dict[int, Request] = {}
        self._next_np = np.zeros((self.max_batch,), np.int64)
        self.peak_used_pages = 0
        self.peak_live_pages = 0  # used minus reclaimable (refcount-0) cache
        self._trash = torch.full((self.max_batch,), self.page_pool.trash_page(0),
                                 dtype=torch.int32, device=self.device)
        # host wall seconds of each scheduler plan (host only), each prefill
        # chunk and each batched decode; a chunk and a decode end in a
        # device->host read of their argmax, so their times are complete
        self.timings = {"plan_s": [], "prefill_chunk_s": [], "decode_s": []}

    # -- request management -------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue ``req``; raises :class:`ShedError` (request NOT enqueued)
        when admission control rejects it: queue depth past ``max_queue``
        or (paged) page headroom below ``shed_watermark``."""
        if self.cache_mode == "paged":
            self.sched.submit(
                req.rid, len(req.prompt), req.max_new_tokens,
                deadline_steps=req.deadline_steps,
                tokens=np.asarray(req.prompt, np.int32) if self.prefix_caching else None,
            )  # may shed; then the rid is never registered
            self._rid2req[req.rid] = req
            return
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed_count += 1
            raise ShedError(
                f"request {req.rid} shed: queue depth {len(self.queue)} "
                f"at max_queue={self.max_queue}; back off and resubmit"
            )
        self.queue.append(req)

    def _bucket(self, L: int) -> int:
        """Padded prefill length for a prompt of L tokens: the next power of
        two (>= 16), capped at the ring size; sliding-window rings prefill
        exactly (padding could wrap over valid entries)."""
        if self.cfg.sliding_window is not None or L >= self.cache_len:
            return L
        return min(1 << max(L - 1, 15).bit_length(), self.cache_len)

    @torch.inference_mode()
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Single-request prefill at the prompt's bucket length, spliced
        into the batch cache at ``slot``."""
        t0 = time.perf_counter()
        L = len(req.prompt)
        b = self._bucket(L)
        toks = torch.zeros((1, b), dtype=torch.long)
        toks[0, :L] = torch.as_tensor(np.asarray(req.prompt, np.int64))
        logits, rc = prefill_forward(
            self.cfg, self.params, {"tokens": toks.to(self.device)},
            cache_len=self.cache_len, use_kernel=self.use_kernel,
            valid_len=torch.tensor([L], dtype=torch.int32, device=self.device),
        )

        def splice(dst, src):  # stacked (P, B, W, ...) leaves
            dst[:, slot] = src[:, 0]

        tree_map(splice, self.cache["stack"], rc["stack"])
        self.cache["pos"][slot] = rc["pos"][0]
        self.cache["slot_pos"][slot] = rc["slot_pos"][0]
        tok = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
        self.timings["prefill_s"].append(time.perf_counter() - t0)
        req.output.append(tok)
        self._next_tok[slot] = tok
        self.slots[slot] = req

    def _fill_free_slots(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                self._prefill_into_slot(i, self.queue.pop(0))

    # -- main loop ----------------------------------------------------------
    def step(self) -> int:
        """One engine step. Returns the number of active requests. The
        ``serving.step`` fault site can inject a hang here; with
        ``step_timeout_s`` a step over its wall budget raises
        :class:`HangError`."""
        t0 = time.perf_counter()
        for spec in faults.fire("serving.step"):
            if spec.kind == "hang":
                time.sleep(spec.args.get("seconds", 2.0 * (self.step_timeout_s or 0.05)))
        n = self._step_paged() if self.cache_mode == "paged" else self._step_ring()
        dt = time.perf_counter() - t0
        if self.step_timeout_s is not None and dt > self.step_timeout_s:
            raise HangError(f"serving step exceeded its {self.step_timeout_s:.3f}s wall budget ({dt:.3f}s) — hung "
                            "device or wedged host")
        return n

    @torch.inference_mode()
    def _step_ring(self) -> int:
        self._fill_free_slots()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        t0 = time.perf_counter()
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache, self._next_tok, use_kernel=self.use_kernel
        )
        toks = torch.argmax(logits[:, : self.cfg.vocab_size], -1).to(torch.int32)
        self._next_tok = toks
        toks_host = toks.tolist()
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for i in active:
            if self._emit(self.slots[i], toks_host[i]):
                self.slots[i] = None
        return len(active)

    def _emit(self, req: Request, tok: int) -> bool:
        """Append a generated token; True if the request just finished."""
        req.output.append(tok)
        done = len(req.output) >= req.max_new_tokens or (
            req.eos_id is not None and tok == req.eos_id
        )
        req.done = req.done or done
        return done

    # -- paged backend ------------------------------------------------------
    @torch.inference_mode()
    def _step_paged(self) -> int:
        t0 = time.perf_counter()
        plan = self.sched.plan()
        self.timings["plan_s"].append(time.perf_counter() - t0)
        for rid in plan.expired:
            req = self._rid2req[rid]
            req.done = True
            req.status = "deadline"
        if plan.cow_copies:
            self._apply_cow(plan.cow_copies)
        # sample the peak right after planning (allocation): on_token below
        # may free a finished request's pages within the same step
        self._sample_peaks()
        n_active = len(self.sched.running)
        if plan.prefills or plan.decode_slots:
            # every block table this step needs, uploaded once; a table
            # changed by a finishing prefill below belongs to a row that does
            # not decode this step
            bt = torch.from_numpy(self.sched.tables.astype(np.int32)).to(self.device)
            self._run_prefills(plan, bt)
            if plan.decode_slots:
                self._run_decode(plan, bt)
                self._sample_peaks()
        return n_active

    def _sample_peaks(self) -> None:
        self.peak_used_pages = max(self.peak_used_pages, self.page_pool.used_pages)
        self.peak_live_pages = max(
            self.peak_live_pages, self.page_pool.used_pages - self.page_pool.evictable_pages
        )

    def _apply_cow(self, copies) -> None:
        """Copy the prefix cache's COW clones on the device pool(s) before
        any chunk of this step writes into a clone; SpeculativeEngine
        overrides to copy its drafter pool too."""
        copy_pages(self.pool_dev, copies)

    def _run_prefills(self, plan, bt: torch.Tensor) -> None:
        for c in plan.prefills:
            t0 = time.perf_counter()
            req = self._rid2req[c.rid]
            # after preemption the generated tokens are prompt suffix
            full = np.concatenate([np.asarray(req.prompt, np.int64), np.asarray(req.output, np.int64)])
            toks = np.zeros((1, self.prefill_chunk), np.int64)
            toks[0, : c.length] = full[c.start : c.start + c.length]
            dev = self.device
            logits = self._prefill_chunk_device(
                torch.from_numpy(toks).to(dev),
                torch.tensor([c.start], dtype=torch.int32, device=dev),
                bt[c.slot : c.slot + 1],
                torch.tensor([c.length], dtype=torch.int32, device=dev),
                self._trash[c.slot : c.slot + 1],
            )
            tok = int(torch.argmax(logits[0, : self.cfg.vocab_size]))
            self.timings["prefill_chunk_s"].append(time.perf_counter() - t0)
            if self.prefix_caching:
                # the chunk's pages now hold real KV: promote the full
                # original-prompt pages covered so far into the trie
                self.sched.note_prefilled(c.rid, c.start + c.length)
            if c.final:
                self._next_np[c.slot] = tok
                self.sched.on_token(c.slot, self._emit(req, tok))

    def _prefill_chunk_device(self, toks, start, bt, vlen, trash) -> torch.Tensor:
        """One prefill chunk into the device pool; returns its logits.
        SpeculativeEngine overrides to prefill its drafter pool in
        lockstep."""
        logits, _ = paged_forward(self.cfg, self.params, self.pool_dev, toks, start, bt, vlen,
                                  use_kernel=self.use_kernel, trash_page=trash)
        return logits

    def _run_decode(self, plan, bt: torch.Tensor) -> None:
        """One decode token for every ready slot. SpeculativeEngine
        overrides with draft-k, verify-in-one-chunk."""
        t0 = time.perf_counter()
        active = np.zeros((self.max_batch,), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        for slot in plan.decode_slots:
            active[slot] = 1
            pos[slot] = self.sched.running[slot].decode_pos  # cache position written
        dev = self.device
        logits, _ = decode_step_paged(
            self.cfg, self.params, self.pool_dev, torch.from_numpy(self._next_np).to(dev),
            torch.from_numpy(pos).to(dev), bt, torch.from_numpy(active).to(dev),
            use_kernel=self.use_kernel, trash_page=self._trash,
        )
        toks = torch.argmax(logits[:, : self.cfg.vocab_size], -1).tolist()
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for slot in plan.decode_slots:
            req = self._rid2req[self.sched.running[slot].rid]
            self._next_np[slot] = toks[slot]
            self.sched.on_token(slot, self._emit(req, toks[slot]))

    def defrag(self) -> bool:
        """Compact the page pool (paged mode): permutes the device pool and
        rewrites every block table. Returns True if anything moved."""
        if self.cache_mode != "paged":
            raise ValueError("defrag needs cache_mode='paged'")
        mapping = self.page_pool.defrag()
        if not mapping:
            return False
        self.sched.apply_defrag(mapping)
        self._permute_pools(mapping)
        return True

    def _permute_pools(self, mapping) -> None:
        """Apply a defrag mapping to the device pool(s); SpeculativeEngine
        overrides to move its drafter pool with the same mapping."""
        permute_pool(self.pool_dev, mapping)

    @property
    def has_work(self) -> bool:
        if self.cache_mode == "paged":
            return self.sched.has_work
        return any(s is not None for s in self.slots) or bool(self.queue)

    def run(self, requests: List[Request], max_steps: int = 10_000) -> Dict[int, List[int]]:
        for r in requests:
            self.submit(r)
        steps = 0
        while steps < max_steps and self.has_work:
            self.step()
            steps += 1
        return {r.rid: r.output for r in requests}

    def health(self) -> Dict[str, object]:
        """Residency, backlog, shed/evict counters and the age of the oldest
        live request."""
        if self.cache_mode == "paged":
            return {
                "mode": "paged",
                "resident_requests": len(self.sched.running),
                "queued_requests": len(self.sched.queue),
                "resident_pages": self.page_pool.used_pages,
                "free_pages": self.page_pool.free_pages_in(0),
                "num_pages": self.num_pages,
                "shed_count": self.sched.shed_count,
                "deadline_evictions": self.sched.deadline_evictions,
                "oldest_request_age_steps": self.sched.oldest_request_age(),
                "engine_steps": self.sched.step_count,
            }
        return {
            "mode": "ring",
            "resident_requests": sum(1 for s in self.slots if s is not None),
            "queued_requests": len(self.queue),
            "shed_count": self.shed_count,
            "deadline_evictions": 0,
        }

    def kv_stats(self) -> Dict[str, object]:
        """Resident-KV accounting. Paged: only allocated pages count; the
        ring cache holds ``max_batch x cache_len`` entries whatever the
        occupancy."""
        if self.cache_mode == "paged":
            page_bytes = kv_page_bytes(self.cfg, self.page_size)
            stats: Dict[str, object] = {
                "kv_bytes_resident": kv_bytes_resident(self.cfg, self.page_pool),
                "kv_bytes_live": kv_bytes_live(self.cfg, self.page_pool),
                "kv_bytes_resident_per_shard": kv_bytes_resident_per_shard(self.cfg, self.page_pool),
                "kv_bytes_peak": self.peak_used_pages * page_bytes,
                "kv_bytes_live_peak": self.peak_live_pages * page_bytes,
                "page_utilization": self.page_pool.utilization(),
                "peak_used_pages": self.peak_used_pages,
                "peak_live_pages": self.peak_live_pages,
                "num_pages": self.num_pages,
                "peak_resident_requests": self.sched.peak_resident_requests,
                "dp_shards": 1,
                "ep_size": 1,
            }
            if self.page_pool.prefix is not None:
                stats["prefix"] = dict(
                    self.page_pool.prefix.stats(),
                    hit_tokens=self.sched.prefix_hit_tokens,
                    cow_clones=self.page_pool.cow_clones,
                )
            return stats
        ring = ring_kv_bytes(self.cfg, self.max_batch, self.cache_len)
        return {
            "kv_bytes_resident": ring,
            "kv_bytes_peak": ring,
            "page_utilization": 1.0,
            "peak_used_pages": 0,
            "num_pages": 0,
        }
