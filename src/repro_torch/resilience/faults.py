"""Deterministic fault-injection harness (a copy of
``repro.resilience.faults``; its payloads are plain numpy, so one seed
corrupts the same byte in both packages).

Injection is site + event-counter based: an installed :class:`FaultInjector`
counts the events at each named site, and a :class:`FaultSpec` fires on a
window of that counter (``at``/``count``) or periodically (``every``). The
injector's ``seed`` only drives payloads that need randomness (which bit a
bit flip corrupts), never whether a fault fires.

================== ==================================== ==========================
site               kinds                                threaded through
================== ==================================== ==========================
``ckpt.shard_write`` ``write_fail`` | ``torn`` |        ``checkpoint/sharded.py:
                   ``bitflip``                          _save_shard``
``ckpt.shard_read``  ``read_fail``                      ``checkpoint/sharded.py:
                                                        _load_shard``
``train.step``     ``nan_grads`` | ``loss_spike`` |     ``train/trainer.py:
                   ``hang``                             Trainer.run``
``data.batch``     ``corrupt_batch``                    ``data/pipeline.py:
                                                        TrainIterator``
``serving.alloc``  ``alloc_fail``                       ``serving/kv_cache.py:
                                                        PagePool.alloc``
``serving.step``   ``hang``                             ``serving/engine.py:
                                                        ServingEngine.step``
================== ==================================== ==========================

Installation is a context manager (``with faults.inject(spec, ...)``); the
injector is a module global, so the async checkpoint writer thread sees it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class FaultSpec:
    """One fault: fires at ``site`` when that site's event counter is in
    ``[at, at + count)``, or (with ``every``) whenever
    ``counter % every == at % every``."""

    site: str
    kind: str
    at: int = 0
    count: int = 1
    every: Optional[int] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def matches(self, event: int) -> bool:
        if self.every is not None:
            return event % self.every == self.at % self.every
        return self.at <= event < self.at + self.count


class FaultInjector:
    """Counts events per site and reports which specs fire on each.
    ``fired`` is the audit log of ``(site, kind, event_index)`` in firing
    order."""

    def __init__(self, specs, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.fired: List[tuple] = []

    def hits(self, site: str) -> List[FaultSpec]:
        with self._lock:
            event = self._counts[site]
            self._counts[site] += 1
            out = [s for s in self.specs if s.site == site and s.matches(event)]
            for s in out:
                self.fired.append((site, s.kind, event))
        return out

    def events(self, site: str) -> int:
        with self._lock:
            return self._counts[site]


_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def inject(*specs: FaultSpec, seed: int = 0):
    """Install a :class:`FaultInjector` for the ``with`` block; the
    previous injector is restored on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = FaultInjector(specs, seed=seed)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def fire(site: str) -> List[FaultSpec]:
    """The hook an injection site calls: the specs that fire on this event,
    or ``[]`` with no injector installed."""
    inj = _ACTIVE
    return inj.hits(site) if inj is not None else []


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """Torn write: keep only the leading ``keep_fraction`` of the file."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_fraction)))


def flip_bit(path: str, rng: Optional[np.random.Generator] = None,
             skip_header: int = 128) -> int:
    """Silent corruption: flip one bit past the ``.npy`` header at a seeded
    offset. Returns the byte offset flipped."""
    rng = rng if rng is not None else np.random.default_rng(0)
    size = os.path.getsize(path)
    lo = min(skip_header, max(0, size - 1))
    off = int(rng.integers(lo, size))
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ (1 << int(rng.integers(0, 8)))]))
    return off
