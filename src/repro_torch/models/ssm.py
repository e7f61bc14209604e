"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (port of
``repro.models.ssm``).

Training and prefill run the chunked SSD algorithm: within a chunk the
quadratic, attention-like term; across chunks the linear recurrence of the
state. Decode is the single-token recurrent step on an O(1) state (the conv
tail and the (H, P, N) SSM state).

Precision follows the JAX package: the SSD einsums take operands in the
activation dtype and accumulate in fp32 (here: operands rounded to the
activation dtype, then upcast exactly, so the products and sums are fp32);
the decay math is fp32. The JAX scan over chunks becomes one (nc+1, nc+1)
decay matrix over the chunk decays (every chunk at once, a fixed number of
launches whatever the length), and the JAX 4-operand intra-chunk einsum
runs over blocks of chunks, so no more than one (B, H, chunks, cs, cs)
fp32 decay-times-scores matrix of at most ``_BLOCK_BYTES`` lives at a time
(jamba's 256-head, chunk-256 prefill of 1024 tokens holds 268 MB for each
such tensor over all chunks).

Two departures from the JAX package, both on inputs it refuses or
mishandles:

* ``valid`` (B,) masks each row's positions at or after its valid length
  out of the state: their dt is 0 (decay 1, input 0), and the conv tail is
  gathered from the row's last real positions. A length-bucketed prefill
  then gives the unpadded prefill's state and tail. The JAX
  ``prefill_forward(valid_len=...)`` lets the bucket's pad tokens into both
  (``ROADMAP.md``, notes on the reference).
* A sequence length that the chunk does not divide is padded inside
  ``ssd_chunked`` with dt 0 positions (which leave the state as it is) and
  cut back; the JAX version asserts ``L % chunk == 0``.

There is no ``pallas_call`` here, so the SSM is plain PyTorch on the card
too (ROADMAP lists the scan for later speed work).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import norm_apply, norm_decl
from repro_torch.params import ParamDecl, torch_dtype


def ssm_decl(cfg) -> Dict[str, Any]:
    s = cfg.ssm
    D = cfg.d_model
    di, nh, ng, dn = s.d_inner(D), s.nheads(D), s.ngroups, s.d_state
    conv_dim = di + 2 * ng * dn
    dt = torch.bfloat16
    # softplus^-1(x) ~= log(x) for small x: dt in [dt_min, dt_max]
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    return {
        "in_proj_z": ParamDecl((D, di), ("embed", "ssm_inner"), "fan_in", dt),
        "in_proj_x": ParamDecl((D, conv_dim), ("embed", "ssm_inner"), "fan_in", dt),
        "in_proj_dt": ParamDecl((D, nh), ("embed", "ssm_heads"), "fan_in", dt),
        "conv_w": ParamDecl((conv_dim, s.d_conv), ("ssm_inner", None), "fan_in", torch.float32),
        "conv_b": ParamDecl((conv_dim,), ("ssm_inner",), "zeros", torch.float32),
        "dt_bias": ParamDecl((nh,), ("ssm_heads",), f"uniform:{lo}:{hi}", torch.float32),
        "A_log": ParamDecl((nh,), ("ssm_heads",), "uniform:0.0:2.77", torch.float32),
        "D_skip": ParamDecl((nh,), ("ssm_heads",), "ones", torch.float32),
        "gate_norm": norm_decl(di),
        "out_proj": ParamDecl((di, D), ("ssm_inner", "embed"), "fan_in", dt),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., s) -> (..., s, s) lower-triangular decay logits:
    out[..., i, j] = sum_{k=j+1..i} x[..., k] for j <= i, -inf above."""
    s = x.shape[-1]
    cs = torch.cumsum(x, -1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    return d.masked_fill(~mask, float("-inf"))


# the intra-chunk decay matrices of one block of chunks: 256 MB of fp32
_BLOCK_BYTES = 256 << 20


def _rounded(t: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the activation dtype, as an fp32 tensor."""
    return t.to(cd).float()


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P), activation dtype
    dt: torch.Tensor,  # (B, L, H) fp32, after softplus
    A: torch.Tensor,  # (H,) fp32, negative
    Bm: torch.Tensor,  # (B, L, G, N)
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y fp32 (B,L,H,P), final state fp32 (B,H,P,N)).
    Heads are grouped ``H // G`` to a B/C group. A length the chunk does not
    divide is padded with dt 0 positions, which leave the state alone.

    Every chunk at once: the chunks' own states, the states entering each
    chunk from one (nc+1, nc+1) decay matrix over the chunk decays (the
    JAX scan's recurrence, unrolled), the inter-chunk term; the intra-chunk
    term over blocks of chunks whose (B, H, chunks, cs, cs) decay matrix
    stays under ``_BLOCK_BYTES``."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    cd = x.dtype
    pad = (-l) % chunk
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    dA = dt * A  # (B, L, H) fp32
    xdt = _rounded(x.float() * dt[..., None], cd).reshape(b, nc, chunk, g, rep, p)
    Bc = _rounded(Bm, cd).reshape(b, nc, chunk, g, n)
    Cc = _rounded(Cm, cd).reshape(b, nc, chunk, g, n)
    dA_c = dA.reshape(b, nc, chunk, g, rep).permute(0, 3, 4, 1, 2)  # (B, G, R, nc, cs)
    a_cum = torch.cumsum(dA_c, -1)

    # each chunk's contribution to the state at its end
    to_end = _rounded(torch.exp(a_cum[..., -1:] - a_cum), cd).permute(0, 3, 4, 1, 2)[..., None]
    st = torch.einsum("bcjgn,bcjgrp->bcgrpn", Bc, xdt * to_end)  # (B, nc, G, R, P, N)
    # the state entering chunk z: sum over c <= z of the decays between them
    s0 = (init_state.float() if init_state is not None
          else x.new_zeros((b, h, p, n), dtype=torch.float32)).reshape(b, 1, g, rep, p, n)
    decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B, G, R, nc+1, nc+1)
    states = torch.einsum("bgrzc,bcgrpn->bzgrpn", decay, torch.cat([s0, st], 1))
    prev, final = states[:, :nc], states[:, nc]

    # inter-chunk: the entering state, decayed to each position
    state_decay = _rounded(torch.exp(a_cum), cd).permute(0, 3, 4, 1, 2)[..., None]  # (B, nc, cs, G, R, 1)
    y_off = torch.einsum("bcign,bcgrpn->bcigrp", Cc, _rounded(prev, cd)) * state_decay
    # intra-chunk: (C_i . B_j) L_ij x_j, over blocks of chunks
    nb = max(1, _BLOCK_BYTES // (b * h * chunk * chunk * 4))
    diag = []
    for c0 in range(0, nc, nb):
        c1 = min(nc, c0 + nb)
        Lmat = _rounded(torch.exp(_segsum(dA_c[:, :, :, c0:c1])), cd)  # (B, G, R, nb, cs, cs)
        scores = torch.einsum("bcign,bcjgn->bgcij", Cc[:, c0:c1], Bc[:, c0:c1])[:, :, None] * Lmat
        diag.append(torch.einsum("bgrcij,bcjgrp->bcigrp", scores, xdt[:, c0:c1]))
    y = y_off + torch.cat(diag, 1)
    return y.reshape(b, nc * chunk, h, p)[:, :l], final.reshape(b, h, p, n)


def ssm_apply(
    cfg,
    params,
    x: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    return_state: bool = False,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D). Without ``cache``: the chunked prefill/training pass
    (``return_state`` hands back {``conv``: the last d_conv-1 pre-activation
    conv inputs, ``state``} for the decode cache; ``valid`` (B,) keeps each
    row's positions at or after its length out of both). With ``cache``
    (S == 1): the recurrent step, which updates ``cache["conv"]`` and
    ``cache["state"]`` in place."""
    s = cfg.ssm
    B_, S, D = x.shape
    di, nh, ng, dn = s.d_inner(D), s.nheads(D), s.ngroups, s.d_state
    hp = s.headdim

    z = torch.einsum("bsd,de->bse", x, params["in_proj_z"])
    xBC = torch.einsum("bsd,de->bse", x, params["in_proj_x"])
    dt_raw = torch.einsum("bsd,dh->bsh", x, params["in_proj_dt"]).float()
    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt_raw + params["dt_bias"])

    new_cache = None
    if cache is None:
        pad = s.d_conv - 1
        w = params["conv_w"].to(x.dtype)  # (conv_dim, k)
        xp = F.pad(xBC, (0, 0, pad, 0))
        # the causal depthwise conv and its silu in the activation dtype
        conv = sum(xp[:, i:i + S, :] * w[:, i] for i in range(s.d_conv)) + params["conv_b"].to(x.dtype)
        xBC = F.silu(conv)
        xs = xBC[..., :di].reshape(B_, S, nh, hp)
        Bm = xBC[..., di:di + ng * dn].reshape(B_, S, ng, dn)
        Cm = xBC[..., di + ng * dn:].reshape(B_, S, ng, dn)
        if valid is not None:
            live = torch.arange(S, device=x.device)[None, :] < valid.to(x.device).long()[:, None]
            dt = dt * live[..., None]
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, min(s.chunk_size, S))
        if return_state:
            # conv tail: the last d_conv-1 pre-activation conv inputs of each
            # row (xp position j is sequence position j - pad)
            end = (torch.full((B_,), S, device=x.device) if valid is None else valid.to(x.device).long())
            idx = end[:, None] + torch.arange(pad, device=x.device)[None, :]
            tail = torch.gather(xp, 1, idx[..., None].expand(B_, pad, xp.shape[-1]))
            new_cache = {"conv": tail, "state": final_state}
        y = y + params["D_skip"][None, None, :, None] * xs.float()
    else:
        if S != 1:
            raise ValueError("an SSM decode step takes one token")
        conv_buf = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], 1)  # (B, k, conv_dim)
        conv = torch.einsum("bkc,ck->bc", conv_buf.float(), params["conv_w"].float()) + params["conv_b"]
        xBC_t = F.silu(conv).to(x.dtype)
        xs = xBC_t[:, :di].reshape(B_, nh, hp).float()
        Bm = xBC_t[:, di:di + ng * dn].reshape(B_, ng, dn).float()
        Cm = xBC_t[:, di + ng * dn:].reshape(B_, ng, dn).float()
        rep = nh // ng
        Bh = Bm.repeat_interleave(rep, 1)  # (B, H, N)
        Ch = Cm.repeat_interleave(rep, 1)
        dt1 = dt[:, 0]  # (B, H)
        state = cache["state"].float() * torch.exp(dt1 * A)[..., None, None] \
            + torch.einsum("bhp,bhn->bhpn", xs * dt1[..., None], Bh)
        y = torch.einsum("bhpn,bhn->bhp", state, Ch)[:, None]  # (B, 1, H, P)
        cache["conv"].copy_(conv_buf[:, 1:])
        cache["state"].copy_(state)
        new_cache = cache
        y = y + params["D_skip"][None, None, :, None] * xs[:, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z)), the gate in the activation dtype
    y = norm_apply(params["gate_norm"], y * F.silu(z), "rmsnorm", cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, params["out_proj"]), new_cache


def ssm_cache_decl(cfg, batch: int) -> Dict[str, ParamDecl]:
    s = cfg.ssm
    D = cfg.d_model
    di, nh, ng, dn = s.d_inner(D), s.nheads(D), s.ngroups, s.d_state
    conv_dim = di + 2 * ng * dn
    return {
        "conv": ParamDecl((batch, s.d_conv - 1, conv_dim), ("batch", None, "ssm_inner"), "zeros",
                          torch_dtype(cfg.dtype)),
        "state": ParamDecl((batch, nh, s.headdim, dn), ("batch", "ssm_heads", None, None), "zeros",
                           torch.float32),
    }
