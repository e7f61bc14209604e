"""Typed errors and the bounded-retry helper for supervised recovery (a
copy of ``repro.resilience.recovery``).

Every fault class the harness can inject maps to exactly one outcome:
automatic recovery (retry, fallback to a verified checkpoint, skip and
log, preemption) or one of these exception types.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Tuple, Type


class InjectedFault(OSError):
    """Raised by an injection site simulating an I/O failure; an
    ``OSError``, so the retry paths treat it as the transient failures it
    stands in for."""


class ShardCorruptionError(RuntimeError):
    """A checkpoint shard file failed validation (missing, torn, or
    checksum mismatch)."""


class CheckpointCorruptionError(RuntimeError):
    """No restorable checkpoint: the requested (or every) step failed
    verification; the message lists every step tried and why."""


class DataCorruptionError(RuntimeError):
    """The data pipeline exhausted its corrupt-batch skip budget."""


class ShedError(RuntimeError):
    """Admission rejected under load (queue bound or page-pool watermark).
    The request was NOT enqueued; the client should back off and retry or
    route elsewhere."""


class HangError(RuntimeError):
    """A watchdog tripped: one step exceeded its wall-clock budget."""


class TrainingDivergedError(RuntimeError):
    """The anomaly supervisor hit its strike limit and has no good
    checkpoint to roll back to."""


def retry_io(
    fn: Callable,
    *args,
    attempts: int = 3,
    base_delay_s: float = 0.01,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    what: str = "io",
    **kwargs,
):
    """Call ``fn`` with bounded retries and exponential backoff
    (``base_delay_s * 2**attempt`` between tries). Other exceptions
    propagate at once; the last failure propagates after the retries were
    warned about."""
    assert attempts >= 1
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = base_delay_s * (2 ** attempt)
            warnings.warn(
                f"{what}: attempt {attempt + 1}/{attempts} failed ({e}); "
                f"retrying in {delay:.3f}s",
                stacklevel=2,
            )
            sleep(delay)
