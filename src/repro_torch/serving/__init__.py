"""Serving: the ring-cache continuous-batching engine."""
