"""Typed errors of ``repro.resilience.recovery`` that the ported paths
raise. Fault-injection sites come with a later slice."""


class ShedError(RuntimeError):
    """Admission rejected under load (queue bound). The request was NOT
    enqueued; the client should back off and retry or route elsewhere."""


class DataCorruptionError(RuntimeError):
    """The data pipeline exhausted its corrupt-batch skip budget."""


class HangError(RuntimeError):
    """A training step exceeded its wall-clock budget (``step_timeout_s``)."""
