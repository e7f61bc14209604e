"""Tile autotuner over the CUDA kernels' compiled tiles, with a persistent
cache (port of ``repro.kernels.autotune``).

Each expert-GEMM entry point of ``csrc/grouped_gemm.cu`` compiles a few
tiles (consumer warpgroups, output columns BN) and picks one by a fixed
rule. The tuner searches those compiled tiles per problem key and scores
each candidate:

* **measured**: where the caller gives ``measure(blocks)``, that time in
  seconds; the hooks of ``kernels/ops.py`` give one on the card, which
  times the call itself at each candidate;
* **modeled** (on the CPU, where a tile changes nothing): the candidate's
  bytes and operations from an analytic traffic model of its grid
  (``kernels/ops.py``), turned into seconds by the active
  :func:`repro_torch.roofline.analysis.hw_profile` (``max(flops/peak,
  bytes/bw)`` plus a per-step overhead).

Either way, candidates whose shared memory exceeds the profile's
``smem_bytes`` are dropped.

Winners persist in a versioned JSON cache, paid once per machine:
``$XDG_CACHE_HOME/repro_torch_autotune.json`` (``~/.cache`` without it;
``REPRO_AUTOTUNE_CACHE`` overrides), seeded from the committed
``autotune_defaults.json`` beside this file. Entries of another
:data:`CACHE_VERSION` are discarded, and every winner, fresh or cached, is
validated: a tile the kernel does not compile, or one illegal at the call's
dims (BN 256 with D not a multiple of 256), is dropped and searched again.

Tuning is opt-in, in the order ``--autotune`` (both CLIs set the env
variable), ``REPRO_AUTOTUNE=1``, off. Off, :func:`get_blocks` returns the
caller's fallback, the entry points' fixed rule, untouched, so the default
path launches exactly the tiles it launched before the tuner.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

CACHE_VERSION = 1

# Per-step overhead (seconds) of the modeled score; a step is one wave of
# blocks over the card's SMs (kernels/ops.py), so the model does not rate
# grids of many small blocks as free.
STEP_OVERHEAD_S = 5e-7

_stats = {"hits": 0, "misses": 0}
_memo: Dict[Tuple[str, str], Tuple[int, ...]] = {}
_cache_loaded: Optional[dict] = None


def reset() -> None:
    """Test hook: drop the in-memory memo and cache and zero the counters
    (the cache file stays)."""
    global _cache_loaded
    _memo.clear()
    _cache_loaded = None
    _stats["hits"] = 0
    _stats["misses"] = 0


def stats() -> Dict[str, int]:
    return dict(_stats)


def enabled() -> bool:
    """Opt-in: on when ``REPRO_AUTOTUNE`` is 1, true or on (the
    ``--autotune`` flags set it). Read per call."""
    return os.environ.get("REPRO_AUTOTUNE", "").lower() in ("1", "true", "on")


def cache_path() -> str:
    p = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if p:
        return p
    return os.path.join(os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
                        "repro_torch_autotune.json")


def _defaults_path() -> str:
    return os.path.join(os.path.dirname(__file__), "autotune_defaults.json")


def make_key(kernel: str, *, E: int = 0, k: int = 0, D: int = 0, F: int = 0, page_size: int = 0,
             itemsize: int = 2, extra: str = "") -> str:
    """Canonical cache key: one winner per (kernel, problem dims, element
    width); ``extra`` carries kernel-specific dims."""
    key = f"{kernel}|E{E}|k{k}|D{D}|F{F}|ps{page_size}|it{itemsize}"
    return f"{key}|{extra}" if extra else key


# ---------------------------------------------------------------------------
# Cache I/O
# ---------------------------------------------------------------------------


def _load_file(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}  # another version: discarded whole
    profiles = data.get("profiles")
    return profiles if isinstance(profiles, dict) else {}


def _load_cache() -> dict:
    """{profile: {key: entry}} of the committed defaults, then the user
    cache over them."""
    global _cache_loaded
    if _cache_loaded is None:
        merged: dict = {}
        for path in (_defaults_path(), cache_path()):
            for prof, entries in _load_file(path).items():
                merged.setdefault(prof, {}).update(entries)
        _cache_loaded = merged
    return _cache_loaded


def _persist(profile: str, key: str, entry: dict) -> None:
    """Atomic read-modify-write of the user cache (temp file, then rename).
    An unwritable cache directory leaves the tuning in memory."""
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        on_disk = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict) and data.get("version") == CACHE_VERSION:
                on_disk = data.get("profiles", {})
        except (OSError, ValueError):
            pass
        on_disk.setdefault(profile, {})[key] = entry
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump({"version": CACHE_VERSION, "profiles": on_disk}, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# Candidates and validation
# ---------------------------------------------------------------------------


def validate_blocks(blocks: Sequence[int], compiled: Iterable[Sequence[int]],
                    legal: Optional[Callable[[Tuple[int, ...]], bool]] = None) -> bool:
    """True if ``blocks`` names one of the kernel's ``compiled`` tiles and
    ``legal(blocks)`` holds at the call's dims. Applied to every winner:
    cached entries that fail (another build, a hand-edited cache) are
    dropped."""
    if not isinstance(blocks, (list, tuple)) or not all(type(b) is int for b in blocks):
        return False
    blocks = tuple(blocks)
    if blocks not in {tuple(c) for c in compiled}:
        return False
    return legal is None or bool(legal(blocks))


def candidates(compiled: Iterable[Sequence[int]],
               legal: Optional[Callable[[Tuple[int, ...]], bool]] = None) -> list:
    """The compiled tiles legal at the call's dims, sorted."""
    return sorted({tuple(c) for c in compiled if legal is None or legal(tuple(c))})


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def modeled_seconds(flops: float, bytes_hbm: float, steps: float, hw: Optional[dict] = None) -> float:
    """Roofline score of one candidate: the compute or memory bound plus a
    per-step overhead."""
    if hw is None:
        from repro_torch.roofline.analysis import hw_profile

        hw = hw_profile()
    return max(flops / hw["peak_flops"], bytes_hbm / hw["hbm_bw"]) + steps * STEP_OVERHEAD_S


def _smem_ok(smem_bytes: float, hw: dict) -> bool:
    return smem_bytes <= hw["smem_bytes"]


def search(cands: Iterable[Tuple[int, ...]], cost: Callable[[Tuple[int, ...]], Dict[str, float]],
           measure: Optional[Callable[[Tuple[int, ...]], float]] = None,
           hw: Optional[dict] = None) -> Tuple[Tuple[int, ...], float, str]:
    """The best candidate. ``cost(blocks)`` gives the analytic ``{"flops",
    "bytes", "steps", "smem_bytes"}`` of the kernel at that tile;
    ``measure(blocks)``, where given, measured seconds, which take
    precedence. Ties go to the smallest tuple. Returns (blocks, score_s,
    source)."""
    if hw is None:
        from repro_torch.roofline.analysis import hw_profile

        hw = hw_profile()
    best: Optional[Tuple[float, Tuple[int, ...]]] = None
    source = "measured" if measure is not None else "modeled"
    for blocks in sorted(cands):
        c = cost(blocks)
        if not _smem_ok(c.get("smem_bytes", 0.0), hw):
            continue
        if measure is not None:
            s = measure(blocks)
        else:
            s = modeled_seconds(c["flops"], c["bytes"], c.get("steps", 0.0), hw)
        if best is None or s < best[0]:
            best = (s, blocks)
    if best is None:
        raise ValueError("no candidate fits the shared-memory budget")
    return best[1], best[0], source


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def get_blocks(kernel: str, key: str, fallback: Tuple[int, ...], compiled: Iterable[Sequence[int]],
               cost: Callable[[Tuple[int, ...]], Dict[str, float]],
               legal: Optional[Callable[[Tuple[int, ...]], bool]] = None,
               measure: Optional[Callable[[Tuple[int, ...]], float]] = None) -> Tuple[int, ...]:
    """The tile of one kernel call site.

    Tuning off (the default): ``fallback``, the fixed rule's tile,
    unchanged. On: the in-memory memo, then the persistent cache (entries
    that fail :func:`validate_blocks` dropped), then a search over the
    legal compiled tiles whose winner is persisted. Device work only where
    a search runs ``measure``: once a key and machine."""
    if not enabled():
        return tuple(fallback)
    from repro_torch.roofline.analysis import DEFAULT_HW_PROFILE, hw_profile

    compiled = tuple(tuple(c) for c in compiled)
    profile = os.environ.get("REPRO_HW_PROFILE") or DEFAULT_HW_PROFILE
    memo_key = (profile, key)
    if memo_key in _memo:
        _stats["hits"] += 1
        return _memo[memo_key]

    cached = _load_cache().get(profile, {}).get(key)
    if isinstance(cached, dict):
        blocks = cached.get("blocks", ())
        if validate_blocks(blocks, compiled, legal):
            blocks = tuple(blocks)
            _stats["hits"] += 1
            _memo[memo_key] = blocks
            return blocks
        # poisoned or stale: searched again below

    _stats["misses"] += 1
    hw = hw_profile(profile)
    try:
        blocks, score, source = search(candidates(compiled, legal), cost, measure=measure, hw=hw)
    except ValueError:
        return tuple(fallback)
    assert validate_blocks(blocks, compiled, legal), (kernel, key, blocks)
    _memo[memo_key] = blocks
    _persist(profile, key, {"v": CACHE_VERSION, "blocks": list(blocks), "score_s": score, "source": source,
                            "kernel": kernel})
    return blocks
