"""Hardware profiles of the roofline model (port of the ``hw_profile`` part
of ``repro.roofline.analysis``; the compiled-artifact analysis is not
ported yet).

A profile holds a device's peak rates, ``peak_flops`` (bf16 tensor-core
FLOP/s) and ``hbm_bw`` (device-memory bytes/s), and ``smem_bytes``, the
shared memory one block may use, which the kernel autotuner filters tile
candidates against in place of the TPU profiles' VMEM budget. The
interconnect rate of the JAX profiles waits for the roofline report that
reads it. The default is ``"h100"``; ``REPRO_HW_PROFILE``
selects another per call.

:func:`training_mfu` is the model FLOPs utilisation of a training run for
every family (dense, MoE, MLA, SSM, hybrid, encdec), from
``ModelConfig.flops_per_token`` alone: the trainer's logging counts the
same FLOPs (``train/callbacks.py``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

HW_PROFILES: Dict[str, Dict[str, float]] = {
    # H100 SXM data sheet, dense rates at the 700 W limit; shared memory: the
    # opt-in maximum of cudaFuncAttributeMaxDynamicSharedMemorySize on sm_90
    # (227 KB)
    "h100": {
        "peak_flops": 989e12,
        "hbm_bw": 3.35e12,
        "smem_bytes": 232448,
    },
    # the JAX package's cpu profile, its VMEM proxy as the shared-memory budget
    "cpu": {
        "peak_flops": 1e12,
        "hbm_bw": 50e9,
        "smem_bytes": 8e6,
    },
}

DEFAULT_HW_PROFILE = "h100"


def hw_profile(name: Optional[str] = None) -> Dict[str, float]:
    """The profile ``name``, else ``REPRO_HW_PROFILE`` (read per call), else
    the h100 default; an unknown name raises ``ValueError``."""
    name = name or os.environ.get("REPRO_HW_PROFILE") or DEFAULT_HW_PROFILE
    try:
        return HW_PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown hardware profile {name!r}; expected one of {sorted(HW_PROFILES)}") from None


def training_mfu(cfg, seq_len: int, tokens_per_s: float, name: Optional[str] = None) -> float:
    """Model FLOPs utilisation of training at ``tokens_per_s``: 3x the
    forward's FLOPs per token (forward + backward, the paper's convention;
    remat's recompute is not counted) over the profile's ``peak_flops``."""
    return 3 * cfg.flops_per_token(seq_len) * tokens_per_s / hw_profile(name)["peak_flops"]
