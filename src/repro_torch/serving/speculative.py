"""Speculative decoding with the dense upcycling parent as drafter (port of
``repro.serving.speculative``).

Upcycling makes the MoE a function-preserving derivative of its dense
source (paper §3.1): same tokenizer and widths and, at Mixtral router init,
the same outputs. So the dense parent drafts ``k`` tokens with cheap
single-token paged decodes, and the MoE verifies all of them in ONE chunk
(``paged_forward(..., return_all_logits=True)`` at static length ``k +
1``). Greedy acceptance keeps the longest prefix where the draft equals the
verifier's argmax and then emits the verifier's own next token, so every
verify step emits between 1 and ``k + 1`` tokens and the output is token
for token that of plain greedy decode.

Both pools are page pools, so the verifier and the drafter are GQA
attention stacks: an MLA, SSM, hybrid or encdec config raises
``ValueError`` from the page pool's declaration or the engine, as the JAX
pool refuses it.

On the paged KV subsystem:

* ONE host page pool, scheduler and set of block tables drive TWO device
  pools of the same page geometry: the verifier's KV and the drafter's.
  Prefill chunks, COW clones and defrag permutations go to both in
  lockstep (the engine's ``_prefill_chunk_device``, ``_apply_cow`` and
  ``_permute_pools``), so a block-table entry means the same page in
  either pool, and a prefix-cache hit skips prefill for both models.
* Per row the draft depth is ``min(k, remaining - 1, lookahead)``, where
  ``lookahead`` is how many pages past the next write the scheduler can
  map without preemption: speculation never evicts admitted work.
* The drafter runs ``d + 1`` decodes (inputs ``t0, d1..dd``), so its KV
  covers the positions the verifier writes; rejected positions in both
  pools lie past ``seq_lens`` until later steps overwrite them.

``accepted_tokens / drafted_tokens`` counts draft positions only (the
correction token is always emitted). The pools are updated in place, where
the JAX engine donates them to ``jit``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.upcycle import upcycle_params, upcycle_provenance
from repro_torch.models.model import decode_step_paged, paged_forward
from repro_torch.params import tree_map
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import copy_pages, init_paged_pool, permute_pool


class SpeculativeEngine(ServingEngine):
    """Paged :class:`ServingEngine` whose decode phase drafts ``draft_k``
    tokens on a dense model and verifies them in one MoE chunk."""

    def __init__(self, cfg: ModelConfig, params, draft_cfg: ModelConfig, draft_params, draft_k: int = 4, **kw):
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if kw.setdefault("cache_mode", "paged") != "paged":
            raise ValueError("SpeculativeEngine requires cache_mode='paged'")
        if kw.get("mesh") is not None:
            raise ValueError("SpeculativeEngine does not support mesh mode yet")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"drafter and verifier must share the tokenizer: {draft_cfg.vocab_size} != "
                             f"{cfg.vocab_size}")
        super().__init__(cfg, params, **kw)
        # the drafter's config as given: an engine-level quant_kv changed
        # the verifier's only
        self.draft_cfg = draft_cfg
        self.draft_params = tree_map(lambda t: t.to(self.device), draft_params)
        self.draft_k = draft_k
        # the drafter's pool has the verifier's page geometry, so the one
        # set of block tables addresses both
        self.draft_pool_dev = init_paged_pool(draft_cfg, self.num_pages, self.page_size, device=self.device)
        self.spec_steps = 0  # verify chunks (= decode-phase engine steps)
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.provenance = None  # set by from_upcycle
        # host wall seconds of each step's draft phase and verify chunk,
        # each ending in the device->host read of its argmax
        self.timings.update(draft_s=[], verify_s=[])

    @classmethod
    def from_upcycle(cls, dense_cfg: ModelConfig, moe_cfg: ModelConfig, dense_params, seed: int = 0,
                     draft_k: int = 4, **kw) -> "SpeculativeEngine":
        """The pair as the paper builds it: the dense parent's params
        upcycled into the MoE (routers drawn from ``seed + i``,
        function-preserving at Mixtral router init) verify, the dense params
        draft, and the :func:`upcycle_provenance` link is recorded."""
        params = upcycle_params(dense_cfg, moe_cfg, dense_params, seed)
        eng = cls(moe_cfg, params, dense_cfg, dense_params, draft_k=draft_k, **kw)
        eng.provenance = upcycle_provenance(dense_cfg, moe_cfg)
        return eng

    @property
    def acceptance_rate(self) -> float:
        if self.drafted_tokens == 0:
            return 0.0
        return self.accepted_tokens / self.drafted_tokens

    # -- lockstep hooks ------------------------------------------------------
    def _apply_cow(self, copies) -> None:
        super()._apply_cow(copies)
        copy_pages(self.draft_pool_dev, copies)

    def _permute_pools(self, mapping) -> None:
        super()._permute_pools(mapping)
        permute_pool(self.draft_pool_dev, mapping)

    def _prefill_chunk_device(self, toks, start, bt, vlen, trash) -> torch.Tensor:
        paged_forward(self.draft_cfg, self.draft_params, self.draft_pool_dev, toks, start, bt, vlen,
                      use_kernel=self.use_kernel, trash_page=trash)
        return super()._prefill_chunk_device(toks, start, bt, vlen, trash)

    # -- draft / verify decode -----------------------------------------------
    def _run_decode(self, plan, bt: torch.Tensor) -> None:
        slots = plan.decode_slots
        B, k, V = self.max_batch, self.draft_k, self.cfg.vocab_size
        dev = self.device
        t0 = time.perf_counter()
        # per-row draft depth: never past the request's budget (the
        # correction token always emits), never forcing an eviction
        d = np.zeros((B,), np.int64)
        base_pos = np.zeros((B,), np.int32)
        for slot in slots:
            req = self._rid2req[self.sched.running[slot].rid]
            want = max(min(k, req.max_new_tokens - len(req.output) - 1), 0)
            d[slot] = self.sched.ensure_lookahead(slot, want)
            base_pos[slot] = self.sched.running[slot].decode_pos
        if d.any():
            # lookahead may have mapped new pages: upload the tables again
            bt = torch.from_numpy(self.sched.tables.astype(np.int32)).to(dev)

        # draft phase: d + 1 drafter decodes per row (inputs t0, d1..dd); the
        # last writes the drafter's KV at base + d, so a fully accepted step
        # leaves no hole
        drafts = np.zeros((B, k), np.int64)
        cur = self._next_np.copy()
        pos = base_pos.copy()
        for i in range(k + 1):
            act = np.zeros((B,), np.int32)
            act[slots] = (d[slots] >= i).astype(np.int32)
            if not act.any():
                break
            logits, _ = decode_step_paged(
                self.draft_cfg, self.draft_params, self.draft_pool_dev, torch.from_numpy(cur).to(dev),
                torch.from_numpy(pos).to(dev), bt, torch.from_numpy(act).to(dev),
                use_kernel=self.use_kernel, trash_page=self._trash,
            )
            toks = torch.argmax(logits[:, :V], -1).cpu().numpy()
            for slot in slots:
                if i <= d[slot]:
                    pos[slot] += 1
                    if i < d[slot]:
                        drafts[slot, i] = cur[slot] = toks[slot]
        t1 = time.perf_counter()
        self.timings["draft_s"].append(t1 - t0)

        # verify phase: one chunk scores t0 and every draft
        vt = np.zeros((B, k + 1), np.int64)
        vl = np.zeros((B,), np.int32)
        for slot in slots:
            vt[slot, 0] = self._next_np[slot]
            vt[slot, 1:1 + d[slot]] = drafts[slot, :d[slot]]
            vl[slot] = d[slot] + 1
        logits_all, _ = paged_forward(
            self.cfg, self.params, self.pool_dev, torch.from_numpy(vt).to(dev), torch.from_numpy(base_pos).to(dev),
            bt, torch.from_numpy(vl).to(dev), use_kernel=self.use_kernel, trash_page=self._trash,
            return_all_logits=True,
        )
        targets = torch.argmax(logits_all[:, :, :V], -1).cpu().numpy()  # (B, k+1): the token after each input
        self.timings["verify_s"].append(time.perf_counter() - t1)

        # accept the longest agreeing prefix and the verifier's correction
        self.spec_steps += 1
        for slot in slots:
            req = self._rid2req[self.sched.running[slot].rid]
            m = 0
            while m < d[slot] and drafts[slot, m] == targets[slot, m]:
                m += 1
            self.drafted_tokens += int(d[slot])
            self.accepted_tokens += m
            for tok in list(drafts[slot, :m]) + [targets[slot, m]]:
                tok = int(tok)
                self._next_np[slot] = tok
                done = self._emit(req, tok)
                self.sched.on_token(slot, done)
                if done:
                    break  # later verified tokens are dropped (eos or budget)

    def kv_stats(self):
        stats = super().kv_stats()
        stats["speculation"] = {
            "draft_k": self.draft_k,
            "spec_steps": self.spec_steps,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "acceptance_rate": round(self.acceptance_rate, 4),
        }
        return stats
