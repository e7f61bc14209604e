"""Deterministic synthetic data pipeline (a copy of
``repro.data.pipeline``, numpy only, so the port gives byte-identical
batches for the same seeds).

Two sources (a large "web" corpus standing in for the RedPajama-V2
low-perplexity bucket, and a small "academic" one) with different Zipf
exponents and n-gram structure, blended 7:3 (paper §4.1), sequence-packed
to fixed length with next-token labels. The iterator yields global-batch
numpy arrays; the trainer moves them to the device.

Every batch is validated (token ids in range, float fields finite); a
corrupt batch is skipped with a warning and its index recorded in
``state()["skipped"]``, up to ``skip_budget``; past it the iterator raises
:class:`repro_torch.resilience.DataCorruptionError`. Skipped batches still
consume the bit-generator stream. The ``data.batch`` fault site corrupts
a drawn batch (an out-of-range token), so the skip path runs on demand.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.resilience import DataCorruptionError, faults


@dataclasses.dataclass
class SyntheticSource:
    """Markov-ish Zipf token stream: token t+1 depends on t via a seeded
    per-token permutation, mixed with fresh Zipf draws. Gives learnable
    structure (so training loss drops) with source-distinct statistics."""

    vocab_size: int
    seed: int
    zipf_a: float = 1.2
    markov_p: float = 0.7  # prob. next token is the deterministic successor

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.permutation(self.vocab_size)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self._probs = probs / probs.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        fresh = rng.choice(self.vocab_size, size=n + 1, p=self._probs)
        out = np.empty(n + 1, dtype=np.int64)
        out[0] = fresh[0]
        use_markov = rng.random(n) < self.markov_p
        for i in range(1, n + 1):
            out[i] = self._succ[out[i - 1]] if use_markov[i - 1] else fresh[i]
        return out


@dataclasses.dataclass
class BlendedDataset:
    """Two-source blend at a token-budget ratio (paper: 7:3)."""

    vocab_size: int
    seq_len: int
    blend_ratio: float = 0.7
    seed: int = 0

    def __post_init__(self):
        self.web = SyntheticSource(self.vocab_size, self.seed * 2 + 1, zipf_a=1.2)
        self.academic = SyntheticSource(
            self.vocab_size, self.seed * 2 + 2, zipf_a=1.05, markov_p=0.85
        )

    def batch(self, rng: np.random.Generator, batch_size: int) -> Dict[str, np.ndarray]:
        toks = np.empty((batch_size, self.seq_len + 1), dtype=np.int32)
        src = rng.random(batch_size) < self.blend_ratio
        for i in range(batch_size):
            source = self.web if src[i] else self.academic
            toks[i] = source.sample(rng, self.seq_len)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class TrainIterator:
    """Stateful blended-batch iterator with an exact-resume snapshot.

    ``state()`` captures the numpy bit-generator state (plus a consumed-batch
    counter for bookkeeping) as a JSON-serializable dict; ``restore()`` puts
    an iterator built with the SAME constructor arguments back to that point,
    so the post-restore batch sequence is bitwise the uninterrupted one. The
    snapshot rides in the checkpoint manifest's ``meta`` (it is host state,
    not a device array — see ``train/state.py``).
    """

    def __init__(
        self,
        dataset: BlendedDataset,
        batch_size: int,
        extra: Optional[Dict[str, Tuple[int, ...]]] = None,
        sample_seed: int = 0,
        skip_budget: int = 16,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.extra = extra
        self.skip_budget = skip_budget
        self._rng = np.random.default_rng(sample_seed + 17)
        self._batches = 0
        self._skipped: List[int] = []

    def __iter__(self) -> "TrainIterator":
        return self

    def _draw(self) -> Dict[str, np.ndarray]:
        b = self.ds.batch(self._rng, self.batch_size)
        if self.extra:
            for k, shape in self.extra.items():
                b[k] = self._rng.standard_normal(shape).astype(np.float32) * 0.02
        return b

    def _validate(self, b: Dict[str, np.ndarray]) -> Optional[str]:
        """None if the batch is servable, else a description of the rot."""
        V = self.ds.vocab_size
        for k, v in b.items():
            if np.issubdtype(v.dtype, np.integer):
                lo, hi = int(v.min()), int(v.max())
                if lo < 0 or hi >= V:
                    return f"'{k}' token ids outside [0, {V}): min {lo} max {hi}"
            elif not np.isfinite(v).all():
                return f"'{k}' has non-finite values"
        return None

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            b = self._draw()
            idx = self._batches
            self._batches += 1
            for spec in faults.fire("data.batch"):
                if spec.kind == "corrupt_batch":
                    b = dict(b)
                    toks = b["tokens"].copy()
                    toks.flat[0] = spec.args.get("value", self.ds.vocab_size + 7)
                    b["tokens"] = toks
            err = self._validate(b)
            if err is None:
                return b
            self._skipped.append(idx)
            warnings.warn(
                f"data batch {idx} corrupt ({err}) — skipped "
                f"[{len(self._skipped)}/{self.skip_budget} budget]",
                stacklevel=2,
            )
            if len(self._skipped) > self.skip_budget:
                raise DataCorruptionError(
                    f"{len(self._skipped)} corrupt batches exceeds the "
                    f"skip budget of {self.skip_budget} (indices "
                    f"{self._skipped}); the pipeline is rotten, stopping"
                )

    def state(self) -> Dict:
        return {
            "rng": self._rng.bit_generator.state,
            "batches": self._batches,
            "batch_size": self.batch_size,
            "skipped": list(self._skipped),
        }

    def restore(self, state: Dict) -> "TrainIterator":
        assert state.get("batch_size", self.batch_size) == self.batch_size, (
            "resuming with a different global batch size changes the sample "
            "stream; restart the data state explicitly if that is intended"
        )
        self._rng.bit_generator.state = state["rng"]
        self._batches = int(state["batches"])
        self._skipped = list(state.get("skipped", []))
        return self


def make_train_iter(
    vocab_size: int,
    seq_len: int,
    batch_size: int,
    blend_ratio: float = 0.7,
    seed: int = 0,
    extra: Optional[Dict[str, Tuple[int, ...]]] = None,
    sample_seed: Optional[int] = None,
    skip_budget: int = 16,
) -> TrainIterator:
    """Yields global batches forever, deterministically. ``seed`` defines
    the LANGUAGE (the two sources' statistics); ``sample_seed`` the sampling
    stream — held-out evaluation uses the same seed with a fresh
    sample_seed. ``extra`` adds float stub inputs (vlm 'embeds' / audio
    'frames') of the given shapes. The returned iterator exposes
    ``state()/restore()`` for exact checkpoint-resume of the data stream."""
    ds = BlendedDataset(vocab_size, seq_len, blend_ratio, seed)
    return TrainIterator(
        ds, batch_size, extra,
        sample_seed=(sample_seed if sample_seed is not None else seed),
        skip_budget=skip_budget,
    )


def stub_inputs(cfg, batch_size: int, seq_len: int = 0) -> Optional[Dict[str, Tuple[int, ...]]]:
    """The ``extra`` stub inputs a config's batches carry, as the JAX train
    launcher sets them: a vlm's precomputed patch embeddings ``embeds`` (B,
    P, d_model); an encdec's frame embeddings ``frames`` (B, seq_len,
    d_model); None for the text-only families."""
    if cfg.family == "vlm":
        return {"embeds": (batch_size, cfg.num_prefix_embeds, cfg.d_model)}
    if cfg.family == "encdec":
        return {"frames": (batch_size, seq_len, cfg.d_model)}
    return None
