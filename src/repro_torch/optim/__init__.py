"""Optimizer and LR schedule (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, grad_sumsq  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
