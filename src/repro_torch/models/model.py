"""Language model entry points (port of ``repro.models.model``, every
family):

* ``forward``         — logits over full sequences (``train=True`` for a
  training step: the stack checkpoints each period when ``cfg.remat``).
* ``loss_fn``         — CE over the padded logits + the MoE aux losses.
* ``prefill_forward`` — one full-sequence forward that also emits a
  decode-ready ring cache (length-bucketed via ``valid_len``).
* ``decode_step``     — one new token against the ring cache (k/v, MLA's
  latent, the SSM's conv tail and state, the encoder's cross k/v).
* ``prefill_reference`` — the oracle of ``prefill_forward``: the ring
  cache filled by ``decode_step`` over the prompt, one token at a time.
* ``paged_forward``   — a prefill chunk or a decode step against the shared
  KV page pool (``paged_stack_decl``); ``decode_step_paged`` is its S == 1
  case.

A ``vlm`` config's ``forward``, ``loss_fn`` and ``prefill_forward`` take
``batch["embeds"]`` (B, P, D), precomputed patch embeddings (the stub
frontend), as a prefix before the text tokens, and return logits over the
text positions only; the prefill's cache holds the prefix too. An
``encdec`` config's take ``batch["frames"]`` (B, Se, D), precomputed frame
embeddings (the stub audio frontend), which the non-causal encoder stack
encodes for the decoder's cross-attention; its ring cache holds each
decoder layer's cross k/v over the Se encoder positions. The paged pool
holds GQA attention stacks only: MLA, SSM and cross-attention configs keep
the ring cache, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import cross_entropy, embed_apply, embed_decl, norm_apply, norm_decl, unembed_apply
from repro_torch.models.transformer import (
    BlockSpec,
    build_slots,
    periods_for,
    stack_apply,
    stack_cache_decl,
    stack_decl,
)
from repro_torch.params import ParamDecl, init_from_decls, torch_dtype, tree_leaves, tree_map

ENCODER_SLOTS = [BlockSpec("attn", "dense", causal=False)]


def model_decl(cfg) -> Dict[str, Any]:
    slots = build_slots(cfg)
    decls = {
        "embed": embed_decl(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "stack": stack_decl(cfg, slots, periods_for(cfg, slots)),
        "final_norm": norm_decl(cfg.d_model, cfg.norm_type),
    }
    if cfg.family == "encdec":
        assert cfg.num_encoder_layers > 0
        decls["encoder"] = stack_decl(cfg, ENCODER_SLOTS, cfg.num_encoder_layers)
        decls["encoder_norm"] = norm_decl(cfg.d_model, cfg.norm_type)
    return decls


def _encode(cfg, params, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The non-causal encoder over stub frame embeddings (B, Se, D): (encoder
    output, its positions). Never through the flash kernel and never
    checkpointed, as the JAX ``_encode`` (no ``use_kernel``, no ``train``)."""
    B, Se = frames.shape[:2]
    dev = params["final_norm"]["scale"].device
    pos = torch.arange(Se, dtype=torch.int32, device=dev).expand(B, Se)
    x = frames.to(device=dev, dtype=torch_dtype(cfg.dtype))
    x, _, _ = stack_apply(cfg, ENCODER_SLOTS, params["encoder"], x, pos)
    return norm_apply(params["encoder_norm"], x, cfg.norm_type, cfg.norm_eps), pos


def _cross_cache(cfg, params, enc_out: torch.Tensor) -> Dict[str, Any]:
    """Each decoder slot's cross k/v over the encoder output, stacked
    (periods, B, Se, KV, hd)."""
    return {
        sk: {"cross": {
            "k": torch.einsum("bsd,pdhk->pbshk", enc_out, params["stack"][sk]["cross"]["wk"]),
            "v": torch.einsum("bsd,pdhk->pbshk", enc_out, params["stack"][sk]["cross"]["wv"]),
        }}
        for sk in params["stack"]
    }


def _embed_inputs(cfg, params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """(B, P + S, D) model inputs and the prefix length P: the text tokens'
    embeddings, after a vlm's ``batch["embeds"]`` cast to the model dtype."""
    x = embed_apply(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    if cfg.family != "vlm":
        return x, 0
    emb = batch["embeds"].to(device=x.device, dtype=x.dtype)
    return torch.cat([emb, x], dim=1), emb.shape[1]


def forward(cfg, params, batch: Dict[str, torch.Tensor], use_kernel: bool = False,
            gen: Optional[torch.Generator] = None, train: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (fp32 logits (B, S, padded_vocab) over the text positions,
    summed aux losses). batch: tokens (B, S); vlm: + embeds (B, P, D);
    encdec: + frames (B, Se, D)."""
    x, prefix = _embed_inputs(cfg, params, batch)
    cross_ctx = _encode(cfg, params, batch["frames"]) if cfg.family == "encdec" else None
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x, _, aux = stack_apply(cfg, build_slots(cfg), params["stack"], x, positions,
                            use_kernel=use_kernel, gen=gen, train=train, cross_ctx=cross_ctx)
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, prefix:]), aux


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor], gen: Optional[torch.Generator] = None,
            use_kernel: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss: ce + the summed aux losses. Returns (loss, metrics
    with loss, ce, load_balance_loss, z_loss)."""
    logits, aux = forward(cfg, params, batch, use_kernel, gen, train=True)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    loss = ce + sum(aux.values())
    return loss, {"loss": loss, "ce": ce, **aux}


def cache_decl(cfg, batch: int, cache_len: int, enc_len: int = 0) -> Dict[str, Any]:
    """Ring-cache structure for decode; cache_len = min(seq_len, window);
    ``enc_len`` encoder positions for an encdec config's cross k/v."""
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    slots = build_slots(cfg)
    return {
        "pos": ParamDecl((batch,), ("batch",), "zeros", torch.int32),
        "slot_pos": ParamDecl((batch, cache_len), ("batch", "cache_seq"), "zeros", torch.int32),
        "stack": stack_cache_decl(cfg, slots, periods_for(cfg, slots), batch, cache_len, enc_len),
    }


def decode_step(cfg, params, cache: Dict[str, Any], tokens: torch.Tensor, use_kernel: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: writes each row's token at its ring slot and
    returns fp32 logits (B, padded_vocab) for the next token and the cache.
    The leaves of ``cache["stack"]`` (k/v, ckv/krope, the SSM's conv and
    state) are updated in place; ``pos`` and ``slot_pos`` are new tensors.
    An encdec decoder attends to the cached cross k/v over all of its
    encoder positions."""
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
    if cfg.family == "encdec":
        enc_len = tree_leaves(cache["stack"]["slot0"]["cross"])[0].shape[2]
        cache_view["enc_pos"] = torch.arange(enc_len, dtype=torch.int32, device=tokens.device).expand(B, enc_len)

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
    invalid in ``slot_pos``. Keep the padded length <= the ring size. A
    vlm's prefix counts in the cache and its positions: ``valid_len`` counts
    text tokens, and the next position is P + valid_len.

    The SSM caches (conv tail and state, no sequence dim) are kept as they
    are, and with ``valid_len`` hold only each row's real positions: its
    pad positions enter neither (``models/ssm.py``), so a bucketed prefill
    equals the unpadded one, which the JAX version does not give. An
    encdec cache gets each decoder layer's cross k/v over the encoder
    output of ``batch["frames"]``."""
    x, prefix = _embed_inputs(cfg, params, batch)
    cross_ctx = _encode(cfg, params, batch["frames"]) if cfg.family == "encdec" else None
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if valid_len is None:
        total = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        total = prefix + valid_len.to(device=dev, dtype=torch.int32)
    x, seq_cache, _ = stack_apply(
        cfg, build_slots(cfg), params["stack"], x, positions,
        use_kernel=use_kernel, return_cache=True, cross_ctx=cross_ctx,
        valid=None if valid_len is None else total,
    )
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    xl = x[:, -1:] if valid_len is None else x[torch.arange(B, device=dev), total.long() - 1][:, None]
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

    stack_cache = {sk: {k: (tree_map(pack, v) if k == "attn" else v) for k, v in c.items()}
                   for sk, c in (seq_cache or {}).items()}
    if cross_ctx is not None:
        for sk, c in _cross_cache(cfg, params, cross_ctx[0]).items():
            stack_cache[sk].update(c)
    slot_pos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    slot_pos[:, ring_slots] = torch.arange(S - Wc, S, dtype=torch.int32, device=dev)
    if valid_len is not None:
        slot_pos = torch.where(slot_pos >= total[:, None], -1, slot_pos)
    return logits, {"pos": total, "slot_pos": slot_pos, "stack": stack_cache}


def prefill_reference(cfg, params, batch: Dict[str, torch.Tensor], cache_len: Optional[int] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The oracle of :func:`prefill_forward`: a zero ring cache (an encdec
    one holding the encoder's cross k/v) filled by ``decode_step`` over the
    prompt's tokens one at a time, through the plain paths. Returns the
    last step's logits and the cache."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["final_norm"]["scale"].device
    enc_len = batch["frames"].shape[1] if cfg.family == "encdec" else 0
    cache = init_from_decls(cache_decl(cfg, B, cache_len or S, enc_len), 0, dev)
    cache["slot_pos"].fill_(-1)
    if cfg.family == "encdec":
        enc_out, _ = _encode(cfg, params, batch["frames"])
        for sk, c in _cross_cache(cfg, params, enc_out).items():
            cache["stack"][sk].update(c)
    logits = None
    for t in range(S):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t].to(dev))
    return logits, cache


# ---------------------------------------------------------------------------
# Paged-KV decode / chunked prefill (serving/kv_cache.py drives these)
# ---------------------------------------------------------------------------


def paged_stack_decl(cfg, num_pages: int, page_size: int) -> Dict[str, Any]:
    """KV page-pool declarations: per layer slot, ``(P, num_pages,
    page_size, KV, hd)`` k/v pools shared by every sequence. The LAST page
    (``num_pages - 1``) is the trash page: padded positions write there and
    it never appears in a block table, so a pool of N usable pages declares
    N + 1 (``serving.kv_cache.PagePool`` owns the layout).

    ``cfg.quant_kv == "int8"`` makes the k/v payload int8 and adds fp32
    per-token, per-KV-head scale sidecars ``k_scale``/``v_scale`` shaped
    ``(P, num_pages, page_size, KV, 1)`` to the same subtree, so every pool
    operation (copy-on-write, defrag) moves the scales with their pages.

    GQA attention stacks only, as in the JAX package: an MLA, SSM, hybrid
    or cross-attention config raises ``ValueError`` (they keep the ring
    cache)."""
    slots = build_slots(cfg)
    periods = periods_for(cfg, slots)
    if cfg.use_mla or any(s.mixer != "attn" or s.cross_attn for s in slots):
        raise ValueError(
            f"the paged KV cache holds GQA attention stacks only; {cfg.name} (family {cfg.family!r}, "
            f"use_mla={cfg.use_mla}) keeps the ring cache (cache_mode='ring')")
    kv, hd = cfg.num_kv_heads, cfg.head_dim_
    quant = cfg.quant_kv == "int8"
    dt = torch.int8 if quant else torch_dtype(cfg.dtype)
    axes = ("layers", None, None, None, None)

    def pool():
        attn = {n: ParamDecl((periods, num_pages, page_size, kv, hd), axes, "zeros", dt)
                for n in ("k", "v")}
        if quant:
            for n in ("k_scale", "v_scale"):
                attn[n] = ParamDecl((periods, num_pages, page_size, kv, 1), axes, "zeros", torch.float32)
        return {"attn": attn}

    return {"stack": {f"slot{i}": pool() for i in range(len(slots))}}


def paged_forward(
    cfg,
    params,
    pool: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S) chunk of token ids (right-padded)
    pos_start: torch.Tensor,  # (B,) absolute position of tokens[:, 0]
    page_table: torch.Tensor,  # (B, max_pages) int32 page ids, -1 = unassigned
    valid_len: torch.Tensor,  # (B,) real tokens in this chunk (0 = idle slot)
    use_kernel: bool = False,
    trash_page: Optional[torch.Tensor] = None,  # (B,) per-row trash page id
    return_all_logits: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One forward over the page-table cache view: S > 1 is a prefill chunk
    (attends to the pages written before and to the chunk itself,
    causally), S == 1 a decode step. Logical KV slot ``j`` of sequence
    ``b`` lives at ``pool[page_table[b, j // ps], j % ps]``; pages never
    wrap. Writes of padded and idle positions go to the trash page (the
    last page, or ``trash_page`` per row). The pool leaves are updated in
    place. Returns (fp32 logits (B, padded_vocab) at each row's last valid
    position — (B, S, padded_vocab) at every position with
    ``return_all_logits``, as the speculative verify step needs — and the
    pool)."""
    B, S = tokens.shape
    dev = tokens.device
    leaf = tree_leaves(pool["stack"])[0]  # (P, num_pages, ps, KV, hd)
    num_pages, ps = leaf.shape[1], leaf.shape[2]
    maxP = page_table.shape[1]
    page_table = page_table.to(torch.int32)
    if trash_page is None:
        trash = torch.full((B, 1), num_pages - 1, dtype=torch.int32, device=dev)
    else:
        trash = trash_page.to(torch.int32)[:, None]

    ar = torch.arange(S, dtype=torch.int32, device=dev)
    positions = pos_start.to(torch.int32)[:, None] + ar[None, :]
    pvalid = ar[None, :] < valid_len.to(torch.int32)[:, None]
    # padded positions may run past the table; their write goes to the trash
    wp = torch.gather(page_table, 1, (positions // ps).long().clamp(0, maxP - 1))
    wp = torch.where(pvalid & (wp >= 0), wp, trash)
    wo = positions % ps
    seq_lens = pos_start.to(torch.int32) + valid_len.to(torch.int32)
    kpos = torch.arange(maxP * ps, dtype=torch.int32, device=dev)
    k_pos = torch.where(
        (kpos[None, :] < seq_lens[:, None]) & (page_table[:, kpos.long() // ps] >= 0),
        kpos[None, :], -1,
    )
    cache_view = {
        "page_table": page_table, "k_pos": k_pos,
        "write_page": wp, "write_offset": wo, "seq_lens": seq_lens,
    }
    x = embed_apply(params["embed"], tokens, torch_dtype(cfg.dtype))
    x, new_stack, _ = stack_apply(
        cfg, build_slots(cfg), params["stack"], x, positions,
        cache=pool["stack"], cache_view=cache_view, use_kernel=use_kernel,
    )
    x = norm_apply(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    if return_all_logits:
        return unembed_apply(params["embed"], x), {"stack": new_stack}
    last = torch.clamp_min(valid_len.long() - 1, 0)
    xl = x[torch.arange(B, device=dev), last][:, None]
    return unembed_apply(params["embed"], xl)[:, 0], {"stack": new_stack}


def decode_step_paged(
    cfg,
    params,
    pool: Dict[str, Any],
    tokens: torch.Tensor,  # (B,) next input token ids
    pos: torch.Tensor,  # (B,) absolute position to write
    page_table: torch.Tensor,  # (B, max_pages)
    active: torch.Tensor,  # (B,) 1 for live slots, 0 for idle
    use_kernel: bool = False,
    trash_page: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token paged decode: :func:`paged_forward` with a length-1
    chunk. Idle slots write to the trash page and give logits the engine
    ignores."""
    return paged_forward(
        cfg, params, pool, tokens[:, None], pos, page_table, active.to(torch.int32),
        use_kernel=use_kernel, trash_page=trash_page,
    )
