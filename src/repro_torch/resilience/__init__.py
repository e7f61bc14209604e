"""Fault-injection harness and supervised recovery (port of
``repro.resilience``).

* :mod:`repro_torch.resilience.faults` — the deterministic, seeded
  injection harness: production code calls :func:`faults.fire` at named
  sites (checkpoint shard writes and reads, the train step, the data
  pipeline, the serving page pool and step loop); with no injector
  installed the call is a no-op.
* :mod:`repro_torch.resilience.recovery` — the typed errors and the
  bounded-retry helper the checkpoint I/O uses.

Like the JAX package's, this package imports nothing from checkpoint,
train or serving, so every layer can depend on it.
"""
from repro_torch.resilience import faults  # noqa: F401
from repro_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    active,
    fire,
    flip_bit,
    inject,
    truncate_file,
)
from repro_torch.resilience.recovery import (  # noqa: F401
    CheckpointCorruptionError,
    DataCorruptionError,
    HangError,
    InjectedFault,
    ShardCorruptionError,
    ShedError,
    TrainingDivergedError,
    retry_io,
)
