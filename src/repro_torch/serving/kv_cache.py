"""Block-table KV cache: a fixed-size page pool shared by every sequence,
optionally split into per-DP-shard sub-pools (port of
``repro.serving.kv_cache``).

The device side is a per-layer ``(num_shards * (pages_per_shard + 1),
page_size, KV, hd)`` k/v pool (``models.model.paged_stack_decl``): each
shard owns a contiguous stride of usable pages plus its own trash page (the
page padded positions write into). With ``num_shards=1``: ``num_pages + 1``
device pages, trash last. One card serves ``num_shards=1``; the host logic
keeps ``num_shards`` so that the same random streams drive this package and
the JAX one (``tests/test_torch_kv_cache.py``).

The host side is :class:`PagePool` (per-shard free lists, which pages each
request owns, refcounted shared pages) and :class:`PrefixCache` (a radix
trie of full-page token runs over shared pages): plain Python, copied
from the JAX package with one difference: :meth:`PrefixCache.insert`
does not graft a request's pages under a cached page the request does not
reference (the JAX package does, which breaks its own refcount invariant;
see ROADMAP queue 3). ``PagePool.alloc`` carries the ``serving.alloc``
fault site (a transient ``alloc_fail``). The device helpers work in place
on torch tensors.

Logical KV slot ``j`` of a request maps to ``pool[table[j // page_size], j %
page_size]``; pages never wrap. A sliding-window config releases pages that
fall wholly below the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import torch

from repro_torch.models.model import paged_stack_decl
from repro_torch.models.transformer import build_slots, periods_for
from repro_torch.params import init_from_decls, torch_dtype, tree_leaves, tree_map
from repro_torch.resilience import faults


class PagePool:
    """Host-side allocator over ``num_pages`` usable pages, split into
    ``num_shards`` equal sub-pools (``num_shards=1`` = single host).

    Physical page ids are device indices: shard ``s`` owns the stride
    ``[s * (pps + 1), s * (pps + 1) + pps)`` where ``pps = num_pages //
    num_shards``; device index ``s * (pps + 1) + pps`` is shard ``s``'s
    trash page and is never allocated. A request is pinned to the shard of
    its first allocation; later allocations come from the same sub-pool.

    **Pinned-shard lifetime rule**: the pin is set by the first successful
    page acquisition (:meth:`alloc` or :meth:`attach`) and survives until
    :meth:`free_request` — including through states where the request
    transiently owns zero pages (a sliding-window request whose pages all
    fell below the window must realloc from the *same* shard, because its
    batch row and device KV stride live there). A zero-page ``alloc`` is a
    pure no-op: it neither pins a shard nor creates bookkeeping entries.

    **Refcounted shared pages** (prefix cache): with
    :meth:`enable_prefix_cache`, immutable full prefix pages can be
    *shared* across requests. Every page is then in exactly one of three
    states — free, *private* (owned by exactly one request), or *shared*
    (in the prefix cache, referenced by ``refcount >= 0`` live requests).
    :meth:`promote` moves a private page into the shared state;
    :meth:`attach` adds a reference; :meth:`free_request` / :meth:`detach`
    *decrement* instead of freeing. A shared page is never freed while its
    refcount is positive; at refcount 0 it stays cache-resident (a future
    request can still hit it) but becomes *evictable* — :meth:`alloc`
    transparently reclaims evictable pages, leaf-first along the radix
    tree, when a sub-pool's free list runs dry, so caching never causes
    preemption that a cache-less pool would not have had. :meth:`cow`
    clones a shared page into a fresh private one (copy-on-write at the
    divergence point; the caller copies the device contents).

    Invariants (asserted by :meth:`check_invariants` and exercised by the
    property suite): free / private / shared states partition the pages;
    ``free_pages + used_pages == num_pages`` at all times; refcounts equal
    the number of live references and are monotone non-increasing down any
    radix-tree path; every page held by a request lives in that request's
    pinned shard and the pin never changes while the request is live;
    per-shard used/free counts sum to the aggregate; a drained pool holds
    only zero-refcount cache pages (none, if the cache is disabled)."""

    def __init__(self, num_pages: int, page_size: int, num_shards: int = 1):
        assert num_pages > 0 and page_size > 0 and num_shards > 0
        assert num_pages % num_shards == 0, (num_pages, num_shards)
        self.num_pages, self.page_size = num_pages, page_size
        self.num_shards = num_shards
        self.pages_per_shard = num_pages // num_shards
        self._stride = self.pages_per_shard + 1  # usable pages + trash
        # per-shard stacks with low ids on top: allocation order is
        # deterministic and, at num_shards=1, identical to the original
        # single-list pool (0, 1, 2, ...)
        self._free: List[List[int]] = [
            list(range(s * self._stride + self.pages_per_shard - 1,
                       s * self._stride - 1, -1))
            for s in range(num_shards)
        ]
        self._owned: Dict[int, List[int]] = {}
        self._shard_of: Dict[int, int] = {}  # rid -> pinned shard
        # prefix-cache state: shared-page refcounts, per-request references,
        # and the insertion-ordered evictable (refcount-0) set
        self._shared: Dict[int, int] = {}  # phys -> live refcount
        self._refs: Dict[int, List[int]] = {}  # rid -> shared pages referenced
        self._evictable: Dict[int, None] = {}  # refcount-0 shared, FIFO order
        self.prefix: Optional["PrefixCache"] = None
        self.cow_clones = 0

    def enable_prefix_cache(self) -> "PrefixCache":
        """Attach a radix prefix index (see :class:`PrefixCache`)."""
        if self.prefix is None:
            self.prefix = PrefixCache(self)
        return self.prefix

    # -- queries ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    @property
    def device_pages(self) -> int:
        """Device pool size along the page axis (usable + trash pages)."""
        return self.num_shards * self._stride

    def free_pages_in(self, shard: int) -> int:
        return len(self._free[shard])

    def used_pages_in(self, shard: int) -> int:
        return self.pages_per_shard - len(self._free[shard])

    def trash_page(self, shard: int) -> int:
        """Device index of ``shard``'s trash page (writes for padded /
        idle positions of that shard's rows land here)."""
        return shard * self._stride + self.pages_per_shard

    def shard_of_page(self, page: int) -> int:
        return page // self._stride

    def shard_of(self, rid: int) -> Optional[int]:
        """Shard ``rid`` is pinned to (None before its first alloc)."""
        return self._shard_of.get(rid)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV entries."""
        return math.ceil(tokens / self.page_size)

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, ()))

    def refs(self, rid: int) -> List[int]:
        """Shared pages ``rid`` holds references to (block-table order)."""
        return list(self._refs.get(rid, ()))

    def held(self, rid: int) -> int:
        """Total pages backing ``rid``: private + shared-referenced. This is
        the number admission/preemption accounting must use — a prefix-hit
        request occupies block-table slots it never alloc'd."""
        return len(self._owned.get(rid, ())) + len(self._refs.get(rid, ()))

    def refcount(self, phys: int) -> int:
        """Live references to shared page ``phys`` (0 = cache-resident but
        evictable; raises KeyError if the page is not shared)."""
        return self._shared[phys]

    @property
    def shared_pages(self) -> int:
        return len(self._shared)

    def evictable_in(self, shard: int) -> int:
        """Refcount-0 cache pages reclaimable from ``shard`` on demand."""
        return sum(1 for p in self._evictable if self.shard_of_page(p) == shard)

    @property
    def evictable_pages(self) -> int:
        return len(self._evictable)

    def available_in(self, shard: int) -> int:
        """Pages ``alloc`` could produce for ``shard`` right now: the free
        list plus evictable cache pages. Admission budgets must use this,
        not ``free_pages_in`` — otherwise retained cache pages would stall
        admission that a cache-less pool would have granted."""
        return len(self._free[shard]) + self.evictable_in(shard)

    def utilization(self) -> float:
        return self.used_pages / self.num_pages

    # -- mutation -----------------------------------------------------------
    def alloc(self, rid: int, n: int = 1, shard: int = 0) -> Optional[List[int]]:
        """Allocate ``n`` private pages for ``rid`` from ``shard``'s
        sub-pool; None (no partial effect) if that sub-pool cannot satisfy
        the request even after reclaiming refcount-0 cache pages. A rid
        already holding pages must allocate from its pinned shard. ``n=0``
        returns ``[]`` with NO side effects (no pin, no bookkeeping)."""
        assert n >= 0, f"negative page count {n} for rid {rid}"
        pinned = self._shard_of.get(rid)
        if pinned is not None:
            assert shard == pinned, (rid, shard, pinned)
        if n == 0:
            return []
        free = self._free[shard]
        if n > len(free) + self.evictable_in(shard):
            return None
        if any(s.kind == "alloc_fail" for s in faults.fire("serving.alloc")):
            # transient exhaustion: the contract of a dry pool (None, no
            # partial effect), so the scheduler's preemption and stall
            # paths handle it
            return None
        if n > len(free):
            self._reclaim(shard, n - len(free))
        pages = [free.pop() for _ in range(n)]
        self._owned.setdefault(rid, []).extend(pages)
        self._shard_of[rid] = shard
        return pages

    def _reclaim(self, shard: int, n: int) -> None:
        """Evict ``n`` refcount-0 cache pages from ``shard`` back to its
        free list, leaf-first along the radix tree (refcount monotonicity
        guarantees an evictable node's children are evictable too, so a
        leaf always exists among the evictable set)."""
        for _ in range(n):
            page = next(
                (p for p in self._evictable
                 if self.shard_of_page(p) == shard
                 and (self.prefix is None or self.prefix.is_leaf(p))),
                None,
            )
            assert page is not None, "reclaim short: evictable set has no leaf"
            del self._evictable[page]
            del self._shared[page]
            if self.prefix is not None:
                self.prefix.drop_page(page)
            self._free[shard].append(page)

    def attach(self, rid: int, pages: List[int], shard: int) -> None:
        """Add ``rid`` references to shared ``pages`` (a prefix-cache hit),
        pinning ``rid`` to ``shard``."""
        pinned = self._shard_of.get(rid)
        if pinned is not None:
            assert shard == pinned, (rid, shard, pinned)
        refs = self._refs.setdefault(rid, [])
        for p in pages:
            assert p in self._shared and self.shard_of_page(p) == shard, (
                rid, p, shard)
            if self._shared[p] == 0:
                del self._evictable[p]
            self._shared[p] += 1
            refs.append(p)
        if pages:
            self._shard_of[rid] = shard

    def promote(self, rid: int, phys: int) -> None:
        """Move ``rid``'s private page ``phys`` into the shared state with
        ``rid`` holding the first reference (its block table keeps using
        the same physical page)."""
        self._owned[rid].remove(phys)  # raises if not private to rid
        if not self._owned[rid]:
            del self._owned[rid]  # pin stays: rid still holds a reference
        self._shared[phys] = 1
        self._refs.setdefault(rid, []).append(phys)

    def detach(self, rid: int, pages: List[int]) -> None:
        """Drop ``rid``'s references to shared ``pages`` (refcount--; at 0
        the page becomes evictable but stays cache-resident)."""
        refs = self._refs.get(rid, [])
        for p in pages:
            refs.remove(p)  # raises if not referenced — double-detach is a bug
            self._shared[p] -= 1
            assert self._shared[p] >= 0, f"negative refcount on page {p}"
            if self._shared[p] == 0:
                self._evictable[p] = None
        if not refs:
            self._refs.pop(rid, None)

    def cow(self, rid: int, phys: int) -> Optional[int]:
        """Copy-on-write: swap ``rid``'s reference to shared page ``phys``
        for a fresh private page in the same shard (None if the shard is
        dry). The caller must copy the device contents old -> new
        (:func:`copy_pages`) and rewrite its block-table entry; the shared
        page itself is never written again."""
        shard = self.shard_of_page(phys)
        # alloc first: rid's live reference keeps `phys` un-evictable while
        # the reclaim inside alloc hunts for pages
        new = self.alloc(rid, 1, shard=shard)
        if new is None:
            return None
        self.detach(rid, [phys])
        self.cow_clones += 1
        return new[0]

    def release(self, rid: int, pages: List[int]) -> None:
        """Return specific private pages owned by ``rid`` (dead
        sliding-window pages) to their shard's free list. The rid's
        bookkeeping entry and shard pin survive even at zero owned pages —
        a live request's next alloc must come from the same shard (its
        batch row and device KV stride live there); only
        :meth:`free_request` unpins."""
        owned = self._owned.get(rid, [])
        for p in pages:
            owned.remove(p)  # raises if not owned — double-free is a bug
            self._free[self.shard_of_page(p)].append(p)

    def free_request(self, rid: int) -> int:
        """End of ``rid``'s lifetime: free its private pages, detach its
        shared references (refcount--, pages stay cache-resident), drop
        the shard pin. Returns how many private pages were freed."""
        pages = self._owned.pop(rid, [])
        for p in pages:
            self._free[self.shard_of_page(p)].append(p)
        self.detach(rid, self.refs(rid))
        self._shard_of.pop(rid, None)
        return len(pages)

    def defrag(self) -> Optional[Dict[int, int]]:
        """Compact allocated pages — private AND shared/cache-resident —
        into the low-index prefix of each shard's stride (pages never
        migrate across shards — their KV lives on that shard's device).
        Returns the {old_physical: new_physical} mapping (None if already
        compact); the caller must apply it to the device pool
        (:func:`permute_pool`) and every block table in the same step."""
        remap: Dict[int, int] = {}
        alloc_per_shard: List[int] = []
        for s in range(self.num_shards):
            base = s * self._stride
            allocated = sorted(
                {p for pages in self._owned.values() for p in pages
                 if self.shard_of_page(p) == s}
                | {p for p in self._shared if self.shard_of_page(p) == s}
            )
            alloc_per_shard.append(len(allocated))
            for new, old in enumerate(allocated):
                remap[old] = base + new
        mapping = {old: new for old, new in remap.items() if old != new}
        if not mapping:
            return None
        for pages in self._owned.values():
            pages[:] = [remap.get(p, p) for p in pages]
        for refs in self._refs.values():
            refs[:] = [remap.get(p, p) for p in refs]
        self._shared = {remap.get(p, p): r for p, r in self._shared.items()}
        self._evictable = {remap.get(p, p): None for p in self._evictable}
        if self.prefix is not None:
            self.prefix.remap(remap)
        for s, n in enumerate(alloc_per_shard):
            base = s * self._stride
            self._free[s] = list(range(
                base + self.pages_per_shard - 1, base + n - 1, -1
            ))
        return mapping

    def drop_prefix_cache(self) -> int:
        """Evict every refcount-0 cache page (e.g. before a drain check or
        a workload switch); returns how many pages went back to the free
        lists. Pages still referenced by live requests stay shared."""
        dropped = 0
        while self._evictable:
            for s in range(self.num_shards):
                n = self.evictable_in(s)
                if n:
                    self._reclaim(s, n)
                    dropped += n
        return dropped

    # -- invariants ---------------------------------------------------------
    def check_invariants(self) -> None:
        owned = [p for pages in self._owned.values() for p in pages]
        shared = list(self._shared)
        flat_free = [p for f in self._free for p in f]
        circulating = owned + shared + flat_free
        assert len(owned) == len(set(owned)), "page double-assigned"
        assert not set(owned) & set(flat_free), "page both owned and free"
        assert not set(shared) & set(flat_free), "shared page on free list"
        assert not set(shared) & set(owned), "page both shared and private"
        assert len(circulating) == self.num_pages, "page leaked"
        trash = {self.trash_page(s) for s in range(self.num_shards)}
        assert not trash & set(circulating), "trash page in circulation"
        assert all(0 <= p < self.device_pages for p in circulating)
        for rid, pages in self._owned.items():
            s = self._shard_of[rid]
            assert all(self.shard_of_page(p) == s for p in pages), (
                f"request {rid} holds pages outside its shard {s}"
            )
        for s, f in enumerate(self._free):
            assert all(self.shard_of_page(p) == s for p in f)
        assert sum(self.used_pages_in(s) for s in range(self.num_shards)) \
            == self.used_pages, "per-shard used counts do not sum to aggregate"
        # refcount consistency: _shared counts == live references, the
        # evictable set is exactly the refcount-0 pages, every reference
        # lives in the referencing rid's pinned shard
        counts: Dict[int, int] = {}
        for rid, refs in self._refs.items():
            assert refs, f"empty refs entry for rid {rid}"
            s = self._shard_of[rid]
            for p in refs:
                assert p in self._shared, f"reference to non-shared page {p}"
                assert self.shard_of_page(p) == s, (
                    f"request {rid} references page {p} outside its shard {s}"
                )
                counts[p] = counts.get(p, 0) + 1
        for p, r in self._shared.items():
            assert r == counts.get(p, 0), (
                f"page {p}: refcount {r} != {counts.get(p, 0)} live refs"
            )
        assert set(self._evictable) == {p for p, r in self._shared.items()
                                        if r == 0}, "evictable set drifted"
        # pin lifetime: exactly the rids holding pages or references are
        # pinned (a live zero-page rid keeps its _owned entry, so stays
        # pinned); nobody else
        assert set(self._owned) | set(self._refs) <= set(self._shard_of), (
            "request holding pages without a shard pin"
        )
        if self.prefix is not None:
            self.prefix.check(self)
        else:
            assert not self._shared and not self._refs and not self._evictable


class _TrieNode:
    """One cached page: reached from its parent by a full ``page_size``
    token run."""
    __slots__ = ("page", "key", "parent", "children")

    def __init__(self, page, key, parent):
        self.page = page  # physical page id holding this run's KV
        self.key = key  # tuple of page_size token ids
        self.parent = parent  # _TrieNode or None (root child)
        self.children: Dict[tuple, "_TrieNode"] = {}


class PrefixCache:
    """Radix index over a :class:`PagePool`: per-shard tries whose edges
    are full ``page_size`` token runs, mapping prompt prefixes to shared
    physical pages. Sharing is full-page granular and position-aligned —
    prefixes start at position 0 and RoPE is baked into cached KV, so a
    token-run match implies bit-identical KV.

    ``match`` walks the trie; ``acquire`` additionally refcounts the hit
    pages onto a request (``PagePool.attach``); ``insert`` promotes a
    request's freshly-prefilled private full-prompt pages into the trie
    (first writer wins — a duplicate page stays private to its request).
    Eviction (``PagePool._reclaim``) is leaf-first; ``drop_page`` unlinks
    an evicted leaf, ``remap`` follows a defrag compaction."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._roots: List[Dict[tuple, _TrieNode]] = [
            {} for _ in range(pool.num_shards)
        ]
        self._node_of: Dict[int, _TrieNode] = {}  # phys -> node
        self.lookups = 0
        self.hits = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def _runs(self, tokens) -> List[tuple]:
        ps = self.page_size
        n = len(tokens) // ps
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(n)]

    def match(self, tokens, shard: int) -> List[int]:
        """Longest-prefix hit: physical pages covering the leading full
        pages of ``tokens`` already cached on ``shard``."""
        pages: List[int] = []
        children = self._roots[shard]
        for run in self._runs(tokens):
            node = children.get(run)
            if node is None:
                break
            pages.append(node.page)
            children = node.children
        return pages

    def acquire(self, rid: int, tokens, shard: int) -> List[int]:
        """``match`` + refcount the hit pages onto ``rid``."""
        self.lookups += 1
        pages = self.match(tokens, shard)
        if pages:
            self.pool.attach(rid, pages, shard)
            self.hits += 1
            self.hit_pages += len(pages)
        return pages

    def insert(self, rid: int, tokens, upto_page: int, table_row) -> int:
        """Promote ``rid``'s private pages covering full token runs
        ``[0, upto_page)`` (physical ids from ``table_row``) into the trie;
        returns how many pages were newly promoted. Descent continues
        only through cached nodes whose page is ``rid``'s own table entry
        (pages it acquired from the trie or promoted itself), so a request
        extending a prefix it attached to grafts its tail under those
        nodes. At the first cached node that holds another request's copy
        of the run, promotion stops and ``rid``'s remaining pages stay
        private, to be freed normally."""
        runs = self._runs(tokens)
        shard = self.pool.shard_of(rid)
        assert shard is not None
        children = self._roots[shard]
        promoted = 0
        parent = None
        for j in range(min(upto_page, len(runs))):
            run = runs[j]
            node = children.get(run)
            if node is not None and node.page != int(table_row[j]):
                # the run is cached, but under another request's page that
                # rid holds no reference to (rid prefilled its own duplicate
                # before that page was cached). Grafting rid's tail under it
                # would hang a referenced child under a parent that may be
                # at refcount 0, breaking the monotone refcounts that
                # leaf-first eviction relies on; the tail stays private.
                break
            if node is None:
                phys = int(table_row[j])
                if phys in self.pool._shared:
                    # rid's page j is someone else's cached page it attached
                    # to under a different path? impossible — its table
                    # entries are either its own private pages or pages it
                    # acquired along exactly this path (node would exist)
                    raise AssertionError(
                        f"table page {phys} shared but absent from trie path")
                node = _TrieNode(phys, run, parent)
                children[run] = node
                self._node_of[phys] = node
                self.pool.promote(rid, phys)
                promoted += 1
            children = node.children
            parent = node
        self.inserted_pages += promoted
        return promoted

    def is_leaf(self, page: int) -> bool:
        return not self._node_of[page].children

    def drop_page(self, page: int) -> None:
        """Unlink an evicted page's node (must be a leaf)."""
        node = self._node_of.pop(page)
        assert not node.children, "evicting a non-leaf cache page"
        siblings = (node.parent.children if node.parent is not None
                    else self._roots[self.pool.shard_of_page(page)])
        del siblings[node.key]
        self.evicted_pages += 1

    def remap(self, mapping: Dict[int, int]) -> None:
        """Follow a defrag compaction: rewrite node physical ids."""
        for node in self._node_of.values():
            node.page = mapping.get(node.page, node.page)
        self._node_of = {node.page: node for node in self._node_of.values()}

    def pages(self) -> set:
        return set(self._node_of)

    def stats(self) -> Dict[str, int]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_pages": self.hit_pages,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "resident_pages": len(self._node_of),
        }

    def check(self, pool: PagePool) -> None:
        """Trie-side invariants: trie pages == shared pages, and refcounts
        are monotone non-increasing down every path (acquire takes whole
        prefixes, so a parent is referenced at least as often as any
        child) — this is what makes leaf-first eviction complete."""
        assert self.pages() == set(pool._shared), (
            "trie pages drifted from the pool's shared set"
        )
        for node in self._node_of.values():
            if node.parent is not None:
                assert pool._shared[node.parent.page] >= pool._shared[node.page], (
                    f"refcount not monotone: parent page {node.parent.page} "
                    f"< child page {node.page}"
                )
                assert node.parent.children.get(node.key) is node
            for key, child in node.children.items():
                assert child.parent is node and child.key == key


def init_paged_pool(cfg, num_pages: int, page_size: int, num_shards: int = 1,
                    device: Union[str, torch.device] = "cuda"):
    """Zero-initialised device page pool: ``num_pages`` usable pages split
    into ``num_shards`` strides, each with its own trailing trash page."""
    assert num_pages % num_shards == 0, (num_pages, num_shards)
    stride = num_pages // num_shards + 1
    return init_from_decls(paged_stack_decl(cfg, num_shards * stride, page_size), 0, device)


def permute_pool(pool, mapping: Dict[int, int]):
    """Apply a defrag mapping to the device pool in place: page ``old``
    moves to index ``new``. Leaves are (P, num_pages, ps, ...); the trash
    page is never remapped."""
    n = tree_leaves(pool)[0].shape[1]
    src = list(range(n))
    for old, new in mapping.items():
        src[new] = old
    leaf0 = tree_leaves(pool)[0]
    idx = torch.tensor(src, dtype=torch.long, device=leaf0.device)
    tree_map(lambda a: a.copy_(a.index_select(1, idx)), pool)
    return pool


def copy_pages(pool, copies: List[tuple]):
    """Apply copy-on-write clones to the device pool in place: for each
    ``(src, dst)`` pair, page ``dst`` becomes a copy of page ``src`` in
    every leaf (k/v and, for int8 pages, their scales). The shared source
    page is never written again."""
    if not copies:
        return pool
    dev = tree_leaves(pool)[0].device
    src = torch.tensor([s for s, _ in copies], dtype=torch.long, device=dev)
    dst = torch.tensor([d for _, d in copies], dtype=torch.long, device=dev)

    def cp(a):
        a[:, dst] = a[:, src]

    tree_map(cp, pool)
    return pool


def kv_entry_bytes(cfg) -> int:
    """Device bytes per (token, KV head) entry: an int8 head vector plus
    its fp32 scale for ``quant_kv="int8"``, else ``hd`` values of
    ``cfg.dtype``."""
    if cfg.quant_kv == "int8":
        return cfg.head_dim_ + 4
    return cfg.head_dim_ * torch_dtype(cfg.dtype).itemsize


def kv_page_bytes(cfg, page_size: int) -> int:
    """Bytes one allocated page pins across the whole stack (k + v, every
    layer)."""
    slots = build_slots(cfg)
    per_entry = cfg.num_kv_heads * kv_entry_bytes(cfg)
    return int(2 * periods_for(cfg, slots) * len(slots) * page_size * per_entry)


def kv_bytes_resident(cfg, pool: PagePool) -> int:
    """KV bytes pinned by allocated pages (live requests and retained
    prefix-cache pages), over every shard."""
    return pool.used_pages * kv_page_bytes(cfg, pool.page_size)


def kv_bytes_live(cfg, pool: PagePool) -> int:
    """KV bytes referenced by live requests: private pages plus shared
    pages counted once, without the refcount-0 cache pages (reclaimable on
    demand)."""
    return (pool.used_pages - pool.evictable_pages) * kv_page_bytes(cfg, pool.page_size)


def kv_bytes_resident_per_shard(cfg, pool: PagePool) -> List[int]:
    """Per-shard resident KV bytes; sums to :func:`kv_bytes_resident`."""
    pb = kv_page_bytes(cfg, pool.page_size)
    return [pool.used_pages_in(s) * pb for s in range(pool.num_shards)]


def ring_kv_bytes(cfg, max_batch: int, cache_len: int) -> int:
    """Resident KV bytes of the dense ring cache at the same batch: it
    holds ``max_batch * cache_len`` entries whatever the occupancy."""
    slots = build_slots(cfg)
    per_entry = cfg.num_kv_heads * cfg.head_dim_ * torch_dtype(cfg.dtype).itemsize
    return 2 * periods_for(cfg, slots) * len(slots) * max_batch * cache_len * per_entry
