"""Checkpointing (port of ``repro.checkpoint``): flat params checkpoints
with upcycling on load, the async step-directory manager, and format-2
verification."""
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint, upcycle_on_load  # noqa: F401
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    latest_verified_step,
    list_steps,
    restore_tree,
    step_verifies,
    verified_steps,
)
from repro_torch.checkpoint.sharded import verify_checkpoint  # noqa: F401
