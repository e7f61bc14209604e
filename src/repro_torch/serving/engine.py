"""Batched serving engine with the dense ring-buffer KV cache (port of
``repro.serving.engine`` in ``cache_mode="ring"``): continuous batching
over ``max_batch`` slots, one single-request prefill per admitted request
(padded to a power-of-two length bucket) spliced into the batch cache, and
one batched ``decode_step`` per engine step. Greedy decode.

Not in this slice: ``cache_mode="paged"``, the EP x DP mesh mode, int8
serving, fused dispatch and the prefix cache; asking for them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, with_dispatcher
from repro_torch.models.model import cache_decl, decode_step, prefill_forward
from repro_torch.models.transformer import build_slots, periods_for
from repro_torch.params import init_from_decls, resolve_device, torch_dtype, tree_map
from repro_torch.resilience import ShedError


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "ok"


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
        mesh=None,
        max_queue: Optional[int] = None,
        prefix_cache: bool = False,
        quant_weights: str = "none",
        quant_kv: str = "none",
        fused_dispatch: bool = False,
        device: Union[str, torch.device] = "cuda",
    ):
        unported = {
            "cache_mode='paged'": cache_mode == "paged",
            "mesh": mesh is not None,
            "prefix_cache": prefix_cache,
            "quant_weights": quant_weights != "none",
            "quant_kv": quant_kv != "none",
            "fused_dispatch": fused_dispatch,
            "greedy=False": not greedy,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)} not ported yet (see ROADMAP queue 1); "
                "this slice serves cache_mode='ring' only"
            )
        if cache_mode != "ring":
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        self.device = resolve_device(device)
        cfg = with_dispatcher(cfg, dispatcher)
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.max_queue = max_queue
        self.shed_count = 0
        self.use_kernel = use_kernel
        self.cache_mode = cache_mode
        self.cache_len = max_seq if cfg.sliding_window is None else min(max_seq, cfg.sliding_window)
        self.cache = init_from_decls(cache_decl(cfg, max_batch, max_seq), 0, self.device)
        self.cache["slot_pos"].fill_(-1)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._next_tok = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        # host wall seconds of each prefill and each batched decode; both end
        # in a device->host read of the sampled token, so they are complete
        self.timings: Dict[str, List[float]] = {"prefill_s": [], "decode_s": []}

    # -- request management -------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue ``req``; raises :class:`ShedError` (request NOT enqueued)
        when the queue is at ``max_queue``."""
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
        """One engine step: admit queued requests into free slots, then one
        batched decode. Returns the number of active requests."""
        return self._step_ring()

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

    @property
    def has_work(self) -> bool:
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
        return {
            "mode": "ring",
            "resident_requests": sum(1 for s in self.slots if s is not None),
            "queued_requests": len(self.queue),
            "shed_count": self.shed_count,
            "deadline_evictions": 0,
        }

    def kv_stats(self) -> Dict[str, float]:
        """Resident KV bytes of the ring cache: it holds ``max_batch x
        cache_len`` entries whatever the occupancy."""
        slots = build_slots(self.cfg)
        per_entry = self.cfg.num_kv_heads * self.cfg.head_dim_ * torch_dtype(self.cfg.dtype).itemsize
        ring = 2 * periods_for(self.cfg, slots) * len(slots) * self.max_batch * self.cache_len * per_entry
        return {
            "kv_bytes_resident": ring,
            "kv_bytes_peak": ring,
            "page_utilization": 1.0,
            "peak_used_pages": 0,
            "num_pages": 0,
        }
