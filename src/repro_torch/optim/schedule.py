"""LR schedule (port of ``repro.optim.schedule``). Paper §4.2: cosine
annealing 3e-5 -> 3e-7 with 100 warmup steps."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, lr: float, lr_min: float, warmup_steps: int, total_steps: int) -> torch.Tensor:
    """``step`` is the 0-based optimizer step; warmup is 1-indexed so the
    first update already has lr = lr / warmup. Computed in fp32 on the host,
    as the JAX version computes it in fp32; returns a 0-dim fp32 tensor."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    step = f32(int(step))
    warm = f32(lr) * torch.minimum(step + 1, f32(warmup_steps)) / f32(max(warmup_steps, 1))
    frac = torch.clamp((step - warmup_steps) / f32(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = f32(lr_min) + f32(0.5 * (lr - lr_min)) * (1 + torch.cos(f32(math.pi) * frac))
    return torch.where(step < warmup_steps, warm, cos)
