"""Typed serving errors (the one piece of ``repro.resilience`` the ring
engine needs). Fault-injection sites come with a later slice."""


class ShedError(RuntimeError):
    """Admission rejected under load (queue bound). The request was NOT
    enqueued; the client should back off and retry or route elsewhere."""
