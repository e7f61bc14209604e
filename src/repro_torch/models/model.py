"""Language model entry points (port of ``repro.models.model`` for the
dense/moe GQA families):

* ``forward``         — logits over full sequences.
* ``prefill_forward`` — one full-sequence forward that also emits a
  decode-ready ring cache (length-bucketed via ``valid_len``).
* ``decode_step``     — one new token against the ring KV cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import embed_apply, embed_decl, norm_apply, norm_decl, unembed_apply
from repro_torch.models.transformer import build_slots, periods_for, stack_apply, stack_cache_decl, stack_decl
from repro_torch.params import ParamDecl, torch_dtype, tree_map


def model_decl(cfg) -> Dict[str, Any]:
    slots = build_slots(cfg)
    return {
        "embed": embed_decl(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "stack": stack_decl(cfg, slots, periods_for(cfg, slots)),
        "final_norm": norm_decl(cfg.d_model, cfg.norm_type),
    }


def forward(cfg, params, batch: Dict[str, torch.Tensor], use_kernel: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (fp32 logits (B, S, padded_vocab), summed aux losses)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_apply(params["embed"], tokens, torch_dtype(cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x, _, aux = stack_apply(cfg, build_slots(cfg), params["stack"], x, positions, use_kernel=use_kernel)
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return unembed_apply(params["embed"], x), aux


def cache_decl(cfg, batch: int, cache_len: int) -> Dict[str, Any]:
    """Ring-cache structure for decode; cache_len = min(seq_len, window)."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    slots = build_slots(cfg)
    return {
        "pos": ParamDecl((batch,), ("batch",), "zeros", torch.int32),
        "slot_pos": ParamDecl((batch, cache_len), ("batch", "cache_seq"), "zeros", torch.int32),
        "stack": stack_cache_decl(cfg, slots, periods_for(cfg, slots), batch, cache_len),
    }


def decode_step(cfg, params, cache: Dict[str, Any], tokens: torch.Tensor, use_kernel: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: writes each row's token at its ring slot and
    returns fp32 logits (B, padded_vocab) for the next token and the cache.
    The k/v leaves of ``cache["stack"]`` are updated in place; ``pos`` and
    ``slot_pos`` are new tensors."""
    B = tokens.shape[0]
    pos = cache["pos"]
    W = cache["slot_pos"].shape[1]
    slot = (pos % W).long()
    rows = torch.arange(B, device=tokens.device)
    slot_pos = cache["slot_pos"].clone()
    slot_pos[rows, slot] = pos.to(slot_pos.dtype)
    # a fresh row (pos == 0) keeps every other slot invalid
    cols = torch.arange(W, device=tokens.device)
    slot_pos = torch.where((pos[:, None] == 0) & (cols[None, :] != slot[:, None]), -1, slot_pos)
    cache_view = {"slot": slot, "slot_pos": slot_pos}

    x = embed_apply(params["embed"], tokens[:, None], torch_dtype(cfg.dtype))
    x, new_stack, _ = stack_apply(
        cfg, build_slots(cfg), params["stack"], x, pos[:, None],
        cache=cache["stack"], cache_view=cache_view, use_kernel=use_kernel,
    )
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = unembed_apply(params["embed"], x)[:, 0]
    return logits, {"pos": pos + 1, "slot_pos": slot_pos, "stack": new_stack}


def prefill_forward(
    cfg,
    params,
    batch: Dict[str, torch.Tensor],
    cache_len: Optional[int] = None,
    use_kernel: bool = False,
    valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward that also returns a decode-ready ring cache.
    With ``valid_len`` (B,), tokens are right-padded to a shared bucket;
    logits are taken at each row's last valid position and pad slots stay
    invalid in ``slot_pos``. Keep the padded length <= the ring size."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = embed_apply(params["embed"], tokens, torch_dtype(cfg.dtype))
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    x, seq_cache, _ = stack_apply(
        cfg, build_slots(cfg), params["stack"], x, positions,
        use_kernel=use_kernel, return_cache=True,
    )
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    if valid_len is None:
        total = torch.full((B,), S, dtype=torch.int32, device=dev)
        xl = x[:, -1:]
    else:
        total = valid_len.to(torch.int32)
        xl = x[torch.arange(B, device=dev), total.long() - 1][:, None]
    logits = unembed_apply(params["embed"], xl)[:, 0]

    # ---- pack the per-layer seq caches into the ring-buffer layout ------
    W = cache_len or S
    if cfg.sliding_window is not None:
        W = min(W, cfg.sliding_window)
    Wc = min(W, S)
    ring_slots = (S - Wc + torch.arange(Wc, device=dev)) % W

    def pack(full):  # (P, B, S, ...) -> (P, B, W, ...)
        buf = full.new_zeros(full.shape[:2] + (W,) + full.shape[3:])
        buf[:, :, ring_slots] = full[:, :, S - Wc:]
        return buf

    stack_cache = tree_map(pack, seq_cache)
    slot_pos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    slot_pos[:, ring_slots] = torch.arange(S - Wc, S, dtype=torch.int32, device=dev)
    if valid_len is not None:
        slot_pos = torch.where(slot_pos >= total[:, None], -1, slot_pos)
    return logits, {"pos": total, "slot_pos": slot_pos, "stack": stack_cache}
