#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py            # all phases, one card

Phases (each failure exits non-zero; nothing is swallowed):

1. card and build — prints the card's name and power limit, builds every
   CUDA kernel of the serving and training paths from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel) and prints the
   build seconds and each kernel's registers / shared memory / spills;
2. kernels vs plain versions — calls each kernel's wrapper on the card at
   the llama3-e8t2 shapes the serving path gives it and holds the result
   against its plain PyTorch version (``kernels/ref.py``):
   bf16 outputs within 2e-2 x max|plain|, the flash lse within 1e-3, the
   paged-attention kernels' idle row exactly 0, the grouped kernels'
   padding rows exactly 0 (bf16 #3/#4 and int8-weight #10/#11 at the decode
   and prefill groups, an empty expert in each), the padded #1/#2 at C
   4, 300, 512 and 100 and the padded int8-weight #8/#9 at C 4, 300 and
   512 (#2, #8 and #9 also launched over all but the last expert into a
   NaN-filled output: the last expert's rows must stay NaN, so no block
   writes past C; #2 launched twice, bit-equal); prints kernel, plain
   and library times (CUDA events; for #8/#9 also the bf16 twin #1/#2)
   beside the bound, and for #2 its time over the library's and the
   bound over its time;
3. serve — llama3-e8t2 at full width, 4 layers (the only cut), sorted
   dispatcher, kernels on, random weights from ``--seed`` drawn on the card:
   ``ServingEngine`` (ring cache, max_batch 4) answers 8 requests of 16-300
   prompt tokens, 32 new tokens each. The launch counts are reset just
   before and read just after; every kernel must have launched. Every
   kernel call of a short serve is then held against its plain version on
   the same inputs (2e-2 x max|plain|). The first-token logits through the
   kernels, through their plain versions and through ``use_kernel=False``
   are compared and reported (with random weights this model amplifies
   bf16 rounding, so two kernel-free paths differ by tens of percent), a
   torch.profiler window shows where the device time goes, and on a small
   input (the smoke config cut to one layer) the kernels' first-token
   logits must agree with their plain versions' within 2e-2 x max|logits|;
4. the serving CLI, in process (smoke config, kernels on): ring cache, then
   paged with the prefix cache and int8 KV pages, then int8 expert weights,
   then with no ``--dispatcher`` (the smoke config's allgather), bf16 and
   with int8 expert weights (#8/#9), then
   ``--fused-dispatch`` in the ring cache and in the page pool with int8
   expert weights;
5. paged serve — the same model and cut through ``cache_mode="paged"``
   (page size 16, prefill chunk 32, max_batch 4, prefix cache on) on 8
   requests of 16-300 prompt tokens sharing a 64-token stem, 32 new tokens
   each, once with bf16 KV pages and once with int8. Launch counts are
   reset just before and read just after each run; the grouped GEMM and
   that run's paged-attention kernel must have launched, and the prefix
   cache must have hit. Every kernel call of a short paged serve is held
   against its plain version; greedy tokens are compared with the ring
   engine on the same requests (reported); a profiler window gives the
   device's busy share; and on the one-layer smoke config the paged path's
   first-token and decode-step logits through the kernels must agree with
   their plain versions' within 2e-2 x max|logits|, for bf16 and int8 KV;
6. train — (a) the five backward kernels (grouped #5-#7 at 2048 tokens x
   top-2 with skewed groups and an empty expert; flash #17-#18 at B 1, H 32,
   KV 8, d 128, S 2048 causal and S 1024 window 256, the ragged S 1000,
   d 64 at S 512 and G 8 (KV 4) at S 1024) against their plain versions
   (2e-2 x max|plain|; padding rows and empty experts exactly 0; #5-#7 and
   the flash kernels write over NaN-filled outputs, which must come back
   finite, and a second launch must be bit-equal; #5-#7 again, untimed,
   with NaN in place of 7.5 in the padding rows of xs and dy, which must
   reach no output), with kernel, plain and library times beside the
   bound and, for #5-#7, kernel over library and bound over kernel; (b) a dense
   llama3-8b cut to 2 layers, drawn from ``--seed`` on the card, is
   upcycled to llama3-e8t2 (8 experts, top-2, dropless sorted dispatch):
   with both parameter trees cast to fp32, the MoE's logits on the first
   batch must equal the dense parent's within 1e-4 x max|logits| (plain
   path), and its first CE through the kernels in bf16 must equal the
   parent's within 1e-3 nats; (c) the port's ``Trainer`` takes 8 steps of
   1 x 2048 tokens with kernels on and remat: losses, steady ms/step,
   tok/s, model TFLOP/s, MFU, peak memory and launches per step are
   printed; the loss must fall, each kernel must launch the expected
   number of times per step (a count is of wrapper calls), and a
   profiled step gives the device's busy share; (d) every kernel call of one
   more step, forward and backward, is held against its plain version,
   every parameter must get a finite nonzero gradient, and on the one-layer
   smoke config the gradients through the kernels must agree with autograd
   through the plain forward within 2e-2 x max|grad|;
7. padded dispatch (``allgather``) — (a) the phase-3 serve (4 layers, the
   same 8 requests) through allgather at the config's CF 4, kernels on:
   #1/#2 must launch, every kernel call of a short serve is held against
   its plain version, greedy tokens against the sorted run are reported;
   (b) 8 Trainer steps of llama3-e8t2 at 2 layers, 1 x 2048 tokens,
   allgather at CF 1.0 (the paper's Table 4 setting; the dropped share is
   printed), kernels and remat on: the loss must fall, #1/#2 launch 4
   times a step and #5-#7 twice, and every kernel call of one more step,
   forward and backward, is held against its plain version;
8. int8 experts at full depth — llama3-e8t2 at all 32 layers and full
   width, expert weights drawn as int8 on the card from ``--seed``, sorted
   dispatcher, ring cache, kernels on, the 8 requests of phase 3: (a) every
   request answered, #10/#11 launched, peak memory, tok/s, prefill and
   decode-step ms and the busy share printed, every kernel call of a short
   serve held against its plain version; (b) the same drawn weights and
   requests with fused dispatch: #14/#15 launched and #10/#11 not, every
   kernel call of a short serve checked, the figures printed beside (a)'s;
   (c) the same weights and requests through the paper config's own
   dispatcher (``alltoall``, which on one card falls back to the padded
   ``allgather`` at CF 4, strict dispatch off): #8/#9 launched and
   #10/#11 not, every kernel call of a short serve checked, the figures
   and greedy tokens against (a) reported; on the one-layer smoke config
   the int8 kernels' first-token logits (sorted #10/#11; allgather #8/#9)
   must agree with their plain versions' within 2e-2 x max|logits| (int8
   against bf16 logits is reported beside ``INT8_LOGIT_BUDGET``);
9. fused dispatch (the sorted dispatcher's gather in the gate/up kernel's
   prologue, the gate-weighted combine in the down kernel's epilogue) —
   (a) #12-#15 at the decode (4 tokens) and prefill (300 tokens) routings
   of phase 2 and #12/#13 at phase 6's training routing (2048 tokens)
   against their plain versions (2e-2 x max|plain|; h's padding rows
   exactly 0; the partials buffer filled with NaN before the down launch
   comes back finite), with kernel, plain and bound times and the whole
   fused path beside the port's unfused path on the same routing; (b)
   phase 3's model and requests through the ring engine with
   ``fused_dispatch=True``: #12/#13 launch and #3/#4 do not, every kernel
   call of a short serve is checked, greedy tokens against the unfused
   run are reported, and on the one-layer smoke config the fused
   kernels' first-token logits must agree with their plain versions' and
   with the unfused kernels' within 2e-2 x max|logits|; (c) phase 6's
   training run (upcycled, 2 layers, 1 x 2048 tokens, 8 steps, remat) with
   fused dispatch: the loss must fall, #12/#13 launch 4 times a step
   (forward and remat recompute), #3/#4 twice (the fused backward's
   recompute of ys) and #5-#7 twice, peak memory is printed beside phase
   6's, every kernel call of one more step is held against its plain
   version, every parameter (the routers through the gates) gets a
   finite nonzero gradient, and the one-layer small-input gradient gate
   holds with fused dispatch.

``--phases 1,2`` stops after the build and the kernel checks; ``--phases
1,6`` is the quick look at training, ``--phases 1,8`` at full-depth int8
serving, ``--phases 1,9`` at fused dispatch. The last two lines are the card's
``nvidia-smi`` name and power limit and the result JSON; the lines before
them list the launches by path, the serve and train figures and the
kernels. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
GG_TOL, FA_TOL, LSE_TOL, LOGIT_TOL, PA_TOL = 2e-2, 2e-2, 1e-3, 2e-2, 2e-2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(out, ref) -> tuple:
    out, ref = out.detach().float(), ref.detach().float()
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: grouped GEMM kernels
# ---------------------------------------------------------------------------


def check_grouped(gen, group_sizes, label: str, D=4096, F=14336, q8: bool = False):
    """The sorted gate/up and down kernels (bf16 #3/#4, or with ``q8`` the
    int8-weight #10/#11) against their plain versions on the same inputs:
    within GG_TOL x max|plain| on the valid rows, padding rows exactly 0."""
    import torch
    from repro_torch.core.dispatch import aligned_rows
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    E = len(group_sizes)
    gs_host = list(group_sizes)
    gs = torch.tensor(gs_host, dtype=torch.int32, device=dev)
    N = sum(gs_host)
    N_pad = aligned_rows(N, E, eg.ROW_TILE)
    # valid rows ~N(0,1); padding rows poisoned: the kernel must mask them
    xs = torch.full((N_pad, D), 7.5, dtype=torch.bfloat16, device=dev)
    valid = torch.zeros(N_pad, dtype=torch.bool, device=dev)
    start = 0
    for g in gs_host:
        xs[start:start + g] = torch.randn((g, D), generator=gen, device=dev).bfloat16()
        valid[start:start + g] = True
        start += -(-g // eg.ROW_TILE) * eg.ROW_TILE
    w = {k: (torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).bfloat16()
         for k, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D)))}
    tg, tr = eg.group_tiling(gs, N_pad // eg.ROW_TILE)
    if q8:
        (wg, sg), (wu, su), (wd, sd) = (quantize_weight(w[k]) for k in ("w_gate", "w_up", "w_down"))
        del w
        gate_up = lambda: eg.gate_up_q8_cuda(xs, wg, wu, sg, su, tg, tr)
        gate_up_plain = lambda: ref.grouped_gate_up_q8_ref(xs, wg, wu, sg, su, gs, eg.ROW_TILE)
        down = lambda h: eg.down_q8_cuda(h, wd, sd, tg, tr)
        down_plain = lambda h: ref.grouped_down_q8_ref(h, wd, sd, gs, eg.ROW_TILE)
        names, w_bytes = ("grouped_gate_up_q8", "grouped_down_q8"), 1
    else:
        gate_up = lambda: eg.gate_up_cuda(xs, w["w_gate"], w["w_up"], tg, tr)
        gate_up_plain = lambda: ref.grouped_gate_up_ref(xs, w["w_gate"], w["w_up"], gs, eg.ROW_TILE)
        down = lambda h: eg.down_cuda(h, w["w_down"], tg, tr)
        down_plain = lambda h: ref.grouped_down_ref(h, w["w_down"], gs, eg.ROW_TILE)
        names, w_bytes = ("grouped_gate_up", "grouped_down"), 2

    h = gate_up()
    h_ref = gate_up_plain()
    y = down(h_ref)
    y_ref = down_plain(h_ref)
    torch.cuda.synchronize()
    rows = []
    touched = sum(1 for g in gs_host if g)
    for name, out, ref_out, k_in, n_out, flops_per_row, fn, plain in (
        (names[0], h, h_ref, D, F, 4 * D * F, gate_up, gate_up_plain),
        (names[1], y, y_ref, F, D, 2 * F * D, lambda: down(h_ref), lambda: down_plain(h_ref)),
    ):
        err, rel = rel_err(out[valid], ref_out[valid])
        pad_zero = bool((out[~valid] == 0).all())
        ok = rel <= GG_TOL and pad_zero and bool(torch.isfinite(out.float()).all())
        n_w = 2 if name.startswith("grouped_gate_up") else 1
        # x rows read once, each touched expert's weights (and int8 scales), all N_pad rows written
        nbytes = (N * k_in * 2 + touched * n_w * k_in * n_out * w_bytes + N_pad * n_out * 2
                  + (touched * n_w * n_out * 2 if q8 else 0))
        b_ms, b_by = bound(nbytes, N * flops_per_row)
        row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, pad_rows_zero=pad_zero,
                   ms=time_ms(fn), plain_ms=time_ms(plain, reps=3, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library="none (no single call)" if q8 else None,
                   shape=f"{label}: N={N} N_pad={N_pad} D={D} F={F} E={E} groups={gs_host}"
                         + (" int8 weights" if q8 else ""))
        if name == "grouped_down":
            row["library_ms"] = grouped_mm_ms(h_ref[valid].contiguous(), w["w_down"], gs)
        rows.append(row)
        print(f"  {name} [{label}] err {err:.4g} (rel {rel:.3g}, tol {GG_TOL}) pad-zero {pad_zero} "
              f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"library {row['library_ms']} ms bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise SystemExit(f"{name} [{label}] disagrees with its plain version")
    return rows


def check_expert(gen, C: int, label: str, E=8, D=4096, F=14336):
    """The padded kernels #1/#2 on an (E, C, D) buffer against their plain
    versions (GG_TOL x max|plain|); every slot is a computed row. #2 is
    also launched a second time (the outputs must be bit-equal: no
    atomics, fixed-order sums) and once over the first E - 1 experts into
    a full (E, C, D) output filled with NaN: the last expert's rows, which
    no block of that launch owns, must stay NaN, so no block writes past C.
    Library yardsticks: two torch.bmm for #1 (the SwiGLU not fused), one
    for #2."""
    import torch
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels.ref import expert_down_ref, expert_gate_up_ref

    dev = torch.device("cuda")
    xe = torch.randn((E, C, D), generator=gen, device=dev).bfloat16()
    wg, wu, wd = ((torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).bfloat16()
                  for shape in ((E, D, F), (E, D, F), (E, F, D)))
    h = eg.expert_gate_up_cuda(xe, wg, wu)
    h_ref = expert_gate_up_ref(xe, wg, wu)
    y = eg.expert_down_cuda(h_ref, wd)
    y_again = eg.expert_down_cuda(h_ref, wd)
    y_part = torch.full((E, C, D), float("nan"), dtype=torch.bfloat16, device=dev)
    eg.expert_down_cuda(h_ref[:E - 1], wd[:E - 1], out=y_part[:E - 1])
    y_ref = expert_down_ref(h_ref, wd)
    torch.cuda.synchronize()
    same = torch.equal(y.view(torch.int16), y_again.view(torch.int16))
    part_err = rel_err(y_part[:E - 1], y_ref[:E - 1])[1]
    untouched = bool(torch.isnan(y_part[E - 1].float()).all())
    print(f"  expert_down [{label}, C={C}] two launches bit-equal {same}; over E-1 experts into NaN: rel err "
          f"{part_err:.3g}, last expert's rows untouched {untouched}")
    rows = []
    for name, out, ref_out, nbytes, flops, fn, plain, lib, lib_name, side_ok in (
        ("expert_gate_up", h, h_ref, E * C * D * 2 + 2 * E * D * F * 2 + E * C * F * 2, 4 * E * C * D * F,
         lambda: eg.expert_gate_up_cuda(xe, wg, wu), lambda: expert_gate_up_ref(xe, wg, wu),
         [lambda: torch.bmm(xe, wg), lambda: torch.bmm(xe, wu)], "sum of two torch.bmm (x Wg, x Wu)", True),
        ("expert_down", y, y_ref, E * C * F * 2 + E * F * D * 2 + E * C * D * 2, 2 * E * C * F * D,
         lambda: eg.expert_down_cuda(h_ref, wd), lambda: expert_down_ref(h_ref, wd),
         [lambda: torch.bmm(h_ref, wd)], "torch.bmm", same and untouched and part_err <= GG_TOL),
    ):
        err, rel = rel_err(out, ref_out)
        ok = rel <= GG_TOL and side_ok and bool(torch.isfinite(out.float()).all())
        b_ms, b_by = bound(nbytes, flops)
        row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, ms=time_ms(fn),
                   plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
                   library_ms=sum(time_ms(f) for f in lib), library=lib_name,
                   shape=f"{label}: E={E} C={C} D={D} F={F}")
        if name == "expert_down":
            row.update(bit_equal=same, next_expert_untouched=untouched)
        rows.append(row)
        print(f"  {name} [{label}, C={C}] err {err:.4g} (rel {rel:.3g}, tol {GG_TOL}) kernel {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} ms library ({lib_name}) {row['library_ms']:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by}); kernel / library {row['ms'] / row['library_ms']:.3f}, "
              f"bound / kernel {b_ms / row['ms']:.3f}")
        if not ok:
            raise SystemExit(f"{name} [{label}, C={C}] disagrees with its plain version, differs between two "
                             f"launches or wrote past C")
    return rows


def check_expert_q8(gen, C: int, label: str, E=8, D=4096, F=14336):
    """The padded int8-weight kernels #8/#9 on an (E, C, D) buffer against
    their plain versions (GG_TOL x max|plain|). Each kernel is also
    launched (through its C entry point, uncounted) over the first E - 1
    experts into a full (E, C, .) output filled with NaN: the rows of the
    last expert, which no block of that launch owns, must stay NaN, so the
    block that straddles C writes no row past it. Beside the kernel: its
    bf16 twin (#1/#2) on the same shapes with the dequantised weights, and
    ``torch.bmm`` on those bf16 weights as the library yardstick (no
    single library call computes the int8 function)."""
    import torch
    from repro_torch.core.quant import dequantize_weight, quantize_weight
    from repro_torch.kernels import _build
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels.ref import expert_down_q8_ref, expert_gate_up_q8_ref

    dev = torch.device("cuda")
    xe = torch.randn((E, C, D), generator=gen, device=dev).bfloat16()
    (wg, sg), (wu, su), (wd, sd) = (
        quantize_weight((torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).bfloat16())
        for shape in ((E, D, F), (E, D, F), (E, F, D)))
    bg, bu, bd = (dequantize_weight(q, s, torch.bfloat16) for q, s in ((wg, sg), (wu, su), (wd, sd)))
    h = eg.expert_gate_up_q8_cuda(xe, wg, wu, sg, su)
    h_ref = expert_gate_up_q8_ref(xe, wg, wu, sg, su)
    y = eg.expert_down_q8_cuda(h_ref, wd, sd)
    y_ref = expert_down_q8_ref(h_ref, wd, sd)
    lib = _build.load("grouped_gemm", eg._SIGS)
    stream = torch.cuda.current_stream().cuda_stream
    h_part = torch.full((E, C, F), float("nan"), dtype=torch.bfloat16, device=dev)
    _build.check(lib.expert_gate_up_q8(xe.data_ptr(), wg.data_ptr(), wu.data_ptr(), sg.data_ptr(), su.data_ptr(),
                                       h_part.data_ptr(), E - 1, C, D, F, stream), "expert_gate_up_q8")
    y_part = torch.full((E, C, D), float("nan"), dtype=torch.bfloat16, device=dev)
    _build.check(lib.expert_down_q8(h_ref.data_ptr(), wd.data_ptr(), sd.data_ptr(), y_part.data_ptr(), E - 1, C,
                                    F, D, stream), "expert_down_q8")
    torch.cuda.synchronize()
    rows = []
    for name, out, ref_out, part, nbytes, flops, fn, plain, twin, lib_calls, lib_name in (
        ("expert_gate_up_q8", h, h_ref, h_part,
         E * C * D * 2 + 2 * E * D * F + 2 * E * F * 2 + E * C * F * 2, 4 * E * C * D * F,
         lambda: eg.expert_gate_up_q8_cuda(xe, wg, wu, sg, su), lambda: expert_gate_up_q8_ref(xe, wg, wu, sg, su),
         lambda: eg.expert_gate_up_cuda(xe, bg, bu), [lambda: torch.bmm(xe, bg), lambda: torch.bmm(xe, bu)],
         "sum of two torch.bmm (x Wg, x Wu) on the bf16-dequantised weights"),
        ("expert_down_q8", y, y_ref, y_part, E * C * F * 2 + E * F * D + E * D * 2 + E * C * D * 2,
         2 * E * C * F * D, lambda: eg.expert_down_q8_cuda(h_ref, wd, sd), lambda: expert_down_q8_ref(h_ref, wd, sd),
         lambda: eg.expert_down_cuda(h_ref, bd), [lambda: torch.bmm(h_ref, bd)],
         "torch.bmm on the bf16-dequantised weights"),
    ):
        err, rel = rel_err(out, ref_out)
        part_err = rel_err(part[:E - 1], ref_out[:E - 1])[1]
        untouched = bool(torch.isnan(part[E - 1].float()).all())
        ok = rel <= GG_TOL and part_err <= GG_TOL and untouched and bool(torch.isfinite(out.float()).all())
        b_ms, b_by = bound(nbytes, flops)
        row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, next_expert_untouched=untouched,
                   ms=time_ms(fn), plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by,
                   twin_ms=time_ms(twin), library_ms=sum(time_ms(f) for f in lib_calls), library=lib_name,
                   shape=f"{label}: E={E} C={C} D={D} F={F} int8 weights")
        rows.append(row)
        print(f"  {name} [{label}, C={C}] err {err:.4g} (rel {rel:.3g}; over E-1 experts {part_err:.3g}; "
              f"tol {GG_TOL}) last expert's rows untouched {untouched} kernel {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} ms bf16 twin {row['twin_ms']:.4f} ms library ({lib_name}) "
              f"{row['library_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise SystemExit(f"{name} [{label}, C={C}] disagrees with its plain version or wrote past C")
    return rows


def grouped_mm_ms(x_compact, w, gs):
    """``torch._grouped_mm`` over the compact rows, when this PyTorch has it
    and takes these operands: the library yardstick, never used by the port."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None
    offs = torch.cumsum(gs, 0).to(torch.int32)
    w_t = w.transpose(-2, -1).contiguous().transpose(-2, -1)  # column-major B
    for b in (w, w_t):
        try:
            torch._grouped_mm(x_compact, b, offs=offs)
        except (RuntimeError, TypeError, NotImplementedError) as e:
            last = e
            continue
        return time_ms(lambda: torch._grouped_mm(x_compact, b, offs=offs))
    print(f"  torch._grouped_mm not usable here: {last}")
    return None


# ---------------------------------------------------------------------------
# phase 2: flash attention
# ---------------------------------------------------------------------------


def check_flash(gen, S: int, window=None, B=1, H=32, KV=8, d=128):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    dev = torch.device("cuda")
    q = torch.randn((B, S, H, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, d), generator=gen, device=dev).bfloat16()
    out, lse = fa.flash_fwd_cuda(q, k, v, True, window, d ** -0.5)
    ref, lse_ref = flash_attention_ref(q, k, v, True, window, d ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    lse_err = float((lse - lse_ref).abs().max())
    ok = rel <= FA_TOL and lse_err <= LSE_TOL and bool(torch.isfinite(out.float()).all())
    pos = torch.arange(S, device=dev)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    pairs = int(mask.sum())
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2 + v.numel() * 2 + out.numel() * 2 + lse.numel() * 4),
                       4 * B * H * d * pairs)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    row = dict(name="flash_fwd", max_abs_err=err, rel_err=rel, lse_err=lse_err, ok=ok,
               ms=time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, window, d ** -0.5)),
               plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, True, window, d ** -0.5, return_lse=True)),
               bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib),
               shape=f"B={B} S={S} H={H} KV={KV} d={d} causal window={window}")
    print(f"  flash_fwd [S={S} window={window}] err {err:.4g} (rel {rel:.3g}, tol {FA_TOL}) "
          f"lse err {lse_err:.3g} (tol {LSE_TOL}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
          f"sdpa {row['library_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    if not ok:
        raise SystemExit(f"flash_fwd [S={S} window={window}] disagrees with its plain version")
    return row


# ---------------------------------------------------------------------------
# phase 2: paged attention
# ---------------------------------------------------------------------------


def paged_case(gen, lens=(332, 300, 17, 0), H=32, KV=8, d=128, ps=16, maxP=22, hole_row=1):
    """Random bf16 pools, a shuffled page per logical page of each row, the
    idle row (length 0) with no pages, and one -1 page in the middle of row
    ``hole_row``'s table."""
    import torch

    dev = torch.device("cuda")
    B = len(lens)
    num_pages = B * maxP + 1
    q = torch.randn((B, H, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((num_pages, ps, KV, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((num_pages, ps, KV, d), generator=gen, device=dev).bfloat16()
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev).tolist()
    bt = torch.full((B, maxP), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lens):
        need = -(-n // ps)
        bt[b, :need] = torch.tensor(perm[used:used + need], dtype=torch.int32)
        used += need
    bt[hole_row, (-(-lens[hole_row] // ps)) // 2] = -1
    return q, k, v, bt.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)


def live_keys(bt, lens, ps: int, window=None) -> int:
    """Keys the kernel must read: positions p of each row with an assigned
    page, p < length and, with a window, p >= length - window."""
    n = 0
    for row, L in zip(bt.tolist(), lens.tolist()):
        lo = max(L - window, 0) if window else 0
        n += sum(1 for p in range(lo, L) if row[p // ps] >= 0)
    return n


def check_paged(gen, q8: bool, window=None):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import dequantize_kv, quantize_kv
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_q8_ref, paged_attention_ref

    q, k, v, bt, sl = paged_case(gen)
    B, H, d = q.shape
    ps, KV = k.shape[1], k.shape[2]
    scale = d ** -0.5
    name = "paged_attention_q8" if q8 else "paged_attention"
    if q8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        fn = lambda: pa.paged_attention_q8_cuda(q, kq, vq, ks, vs, bt, sl, window, scale)
        plain = lambda: paged_attention_q8_ref(q, kq, vq, ks, vs, bt, sl, window, scale)
        kg_src, vg_src = dequantize_kv(kq, ks, torch.bfloat16), dequantize_kv(vq, vs, torch.bfloat16)
        elem = 1 + 4 / d  # int8 payload plus the fp32 scale per (token, head)
    else:
        fn = lambda: pa.paged_attention_cuda(q, k, v, bt, sl, window, scale)
        plain = lambda: paged_attention_ref(q, k, v, bt, sl, window, scale)
        kg_src, vg_src = k, v
        elem = 2
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    idle = [b for b, n in enumerate(sl.tolist()) if n == 0]
    idle_max = float(out[idle].float().abs().max()) if idle else 0.0
    ok = rel <= PA_TOL and idle_max == 0.0 and bool(torch.isfinite(out.float()).all())
    keys = live_keys(bt, sl, ps, window)
    # k and v of each live key (with its scales), q and out, the table and lengths
    nbytes = 2 * keys * KV * d * elem + 2 * q.numel() * 2 + 4 * (bt.numel() + sl.numel())
    b_ms, b_by = bound(nbytes, 4 * H * d * keys)
    # the library yardstick: SDPA over KV already gathered to (B, KV, L, d)
    # (the gather is not timed; no single library call reads a page table)
    btc = bt.long().clamp_min(0)
    kg = kg_src[btc].reshape(B, -1, KV, d).transpose(1, 2).contiguous()
    vg = vg_src[btc].reshape(B, -1, KV, d).transpose(1, 2).contiguous()
    pos = torch.arange(kg.shape[2], device=q.device)
    mask = (pos[None] < sl[:, None]) & (bt >= 0)[:, pos // ps]
    if window:
        mask &= pos[None] > sl[:, None] - 1 - window
    mask = mask[:, None, None, :]
    qt = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask, enable_gqa=True)
    row = dict(name=name, max_abs_err=err, rel_err=rel, idle_row_max=idle_max, ok=ok,
               ms=time_ms(fn, reps=50, warmup=5), plain_ms=time_ms(plain, reps=5, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, reps=50, warmup=5),
               shape=f"B={B} H={H} KV={KV} d={d} ps={ps} maxP={bt.shape[1]} seq_lens={sl.tolist()} "
                     f"window={window} live keys={keys}")
    print(f"  {name} [window={window}] err {err:.4g} (rel {rel:.3g}, tol {PA_TOL}) idle row max|out| "
          f"{idle_max} kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa on gathered KV "
          f"{row['library_ms']:.4f} ms bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
    if not ok:
        raise SystemExit(f"{name} [window={window}] disagrees with its plain version")
    return row


# ---------------------------------------------------------------------------
# phase 6: backward kernels
# ---------------------------------------------------------------------------


def library_sum_ms(calls):
    """Summed time of PyTorch library calls that together compute what a
    kernel computes (``torch._grouped_mm`` products), or None where one of
    them does not run here; the yardstick only, never used by the port."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None
    total = 0.0
    for fn in calls:
        try:
            fn()
        except (RuntimeError, TypeError, NotImplementedError, ValueError) as e:
            print(f"  torch._grouped_mm not usable for this product here: {str(e)[:160]}")
            return None
        total += time_ms(fn, reps=5, warmup=1)
    return total


GMM_SUM = "sum of torch._grouped_mm calls"


def grouped_bwd_case(gen, group_sizes, D=4096, F=14336):
    """Random sorted-buffer inputs of the grouped backward: valid rows
    ~N(0,1), padding rows of xs and dy poisoned with 7.5 (the kernels must
    mask them), weights ~N(0, 1/fan_in)."""
    import torch
    from repro_torch.core.dispatch import aligned_rows
    from repro_torch.kernels import expert_gemm as eg

    dev = torch.device("cuda")
    E = len(group_sizes)
    gs = torch.tensor(group_sizes, dtype=torch.int32, device=dev)
    N = sum(group_sizes)
    N_pad = aligned_rows(N, E, eg.ROW_TILE)
    xs = torch.full((N_pad, D), 7.5, dtype=torch.bfloat16, device=dev)
    dy = torch.full((N_pad, D), 7.5, dtype=torch.bfloat16, device=dev)
    valid = torch.zeros(N_pad, dtype=torch.bool, device=dev)
    start = 0
    for g in group_sizes:
        xs[start:start + g] = torch.randn((g, D), generator=gen, device=dev).bfloat16()
        dy[start:start + g] = torch.randn((g, D), generator=gen, device=dev).bfloat16()
        valid[start:start + g] = True
        start += -(-g // eg.ROW_TILE) * eg.ROW_TILE
    w = [(torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).bfloat16()
         for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return xs, dy, w, gs, valid, N, N_pad


def valid_rows(gs, n_pad: int):
    """(N_pad,) mask of the rows that hold an assignment in the aligned
    sorted buffer."""
    import torch
    from repro_torch.kernels import expert_gemm as eg

    valid = torch.zeros(n_pad, dtype=torch.bool, device=gs.device)
    for s, g in zip(*(t.tolist() for t in eg.expert_rows(gs))):
        valid[s:s + g] = True
    return valid


def grouped_bwd_checked(xs, dy, wg, wu, wd, gs):
    """The three grouped backward kernels in the order the backward runs
    them, each held against its plain version fed the same inputs (the
    kernel pass before it's outputs). Returns ((dx, dWg, dWu, dWd) from the
    kernels, {kernel: [(max|diff|, max|diff|/max|plain|) per output]}, whether padding
    rows and empty experts came out exactly zero)."""
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ref

    valid = valid_rows(gs, xs.shape[0])
    tg, tr = eg.group_tiling(gs, xs.shape[0] // eg.ROW_TILE)
    h, dg, du = eg.bwd_dh_cuda(xs, dy, wg, wu, wd, tg, tr)
    plain = ref.grouped_bwd_dh_ref(xs, dy, wg, wu, wd, gs, eg.ROW_TILE)
    errs = {"grouped_bwd_dh": [rel_err(o[valid], r[valid]) for o, r in zip((h, dg, du), plain)]}
    zeros = all(bool((o[~valid] == 0).all()) for o in (h, dg, du))
    del plain
    dx = eg.bwd_dx_cuda(dg, du, wg, wu, tg, tr)
    dx_r = ref.grouped_bwd_dx_ref(dg, du, wg, wu, gs, eg.ROW_TILE)
    errs["grouped_bwd_dx"] = [rel_err(dx[valid], dx_r[valid])]
    zeros &= bool((dx[~valid] == 0).all())
    del dx_r
    dws = eg.bwd_wgrad_cuda(xs, dy, h, dg, du, gs)
    errs["grouped_bwd_wgrad"], empty_zero = wgrad_errors(dws, xs, dy, h, dg, du, gs)
    return (dx, *dws), errs, zeros and empty_zero


def check_grouped_bwd(gen, group_sizes, label: str, D=4096, F=14336):
    """Kernels #5-#7 against their plain versions (grouped_bwd_checked),
    again with NaN padding rows in xs and dy, each written over NaN and
    launched twice (bit-equal), then kernel, plain and library times and
    the bound of each."""
    import torch
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ref

    xs, dy, (wg, wu, wd), gs, valid, N, N_pad = grouped_bwd_case(gen, group_sizes, D, F)
    E = len(group_sizes)
    touched = sum(1 for g in group_sizes if g)
    empty = [e for e, g in enumerate(group_sizes) if not g]
    tg, tr = eg.group_tiling(gs, N_pad // eg.ROW_TILE)
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=torch.bfloat16, device=xs.device)
    bits = lambda a, b: all(torch.equal(x.view(torch.int16), y.view(torch.int16)) for x, y in zip(a, b))
    finite = lambda outs: all(bool(torch.isfinite(o.float()).all()) for o in outs)
    _, errs, zeros = grouped_bwd_checked(xs, dy, wg, wu, wd, gs)
    # untimed: NaN, not 7.5, in the padding rows of xs and dy (7.5 x 0 = 0
    # would hide a padding row entering #7's sums): each kernel within
    # GG_TOL with padding rows and empty experts 0, #7's outputs finite
    nan_pad = lambda t: t.masked_fill(~valid[:, None], float("nan"))
    (_, *dws), errs_n, zeros_n = grouped_bwd_checked(nan_pad(xs), nan_pad(dy), wg, wu, wd, gs)
    nan_case = {name: all(e[1] <= GG_TOL for e in v) and zeros_n for name, v in errs_n.items()}
    nan_case["grouped_bwd_wgrad"] &= finite(dws)
    print(f"  grouped backward [{label}] with NaN padding rows in xs and dy: {nan_case} (worst rel "
          f"{max(e[1] for v in errs_n.values() for e in v):.4g}, tol {GG_TOL})")
    del dws
    h, dg, du = ref.grouped_bwd_dh_ref(xs, dy, wg, wu, wd, gs, eg.ROW_TILE)
    # each written over NaN (every row or element must come back written:
    # padding rows and empty experts exactly 0), then again into fresh
    # outputs (bit-equal)
    outs = eg.bwd_dh_cuda(xs, dy, wg, wu, wd, tg, tr, out=tuple(nan(N_pad, F) for _ in range(3)))
    again = eg.bwd_dh_cuda(xs, dy, wg, wu, wd, tg, tr)
    torch.cuda.synchronize()
    over_nan = {"grouped_bwd_dh": {"every row finite": finite(outs),
                                   "padding rows 0": all(bool((o[~valid] == 0).all()) for o in outs),
                                   "two launches bit-equal": bits(outs, again)}}
    del outs, again
    dx = eg.bwd_dx_cuda(dg, du, wg, wu, tg, tr, out=nan(N_pad, D))
    dx_again = eg.bwd_dx_cuda(dg, du, wg, wu, tg, tr)
    torch.cuda.synchronize()
    over_nan["grouped_bwd_dx"] = {"every row finite": finite([dx]), "padding rows 0": bool((dx[~valid] == 0).all()),
                                  "two launches bit-equal": bits([dx], [dx_again])}
    del dx, dx_again
    outs = eg.bwd_wgrad_cuda(xs, dy, h, dg, du, gs, out=(nan(E, D, F), nan(E, D, F), nan(E, F, D)))
    again = eg.bwd_wgrad_cuda(xs, dy, h, dg, du, gs)
    torch.cuda.synchronize()
    over_nan["grouped_bwd_wgrad"] = {"every element finite": finite(outs),
                                     f"empty experts {empty} 0": all(bool((o[e] == 0).all()) for o in outs
                                                                    for e in empty),
                                     "two launches bit-equal": bits(outs, again)}
    del outs, again
    for name, flags in over_nan.items():
        print(f"  {name} [{label}] written over NaN: {flags}")
    torch.cuda.empty_cache()
    shape = f"{label}: N={N} N_pad={N_pad} D={D} F={F} E={E} groups={list(group_sizes)}"
    xv, dyv, hv, dgv, duv = (t[valid] for t in (xs, dy, h, dg, du))
    offs = torch.cumsum(gs, 0).to(torch.int32)
    gmm = lambda a, b: (lambda: torch._grouped_mm(a, b, offs=offs))
    t = lambda w: w.transpose(-2, -1)
    cases = (
        ("grouped_bwd_dh", lambda: eg.bwd_dh_cuda(xs, dy, wg, wu, wd, tg, tr),
         lambda: ref.grouped_bwd_dh_ref(xs, dy, wg, wu, wd, gs, eg.ROW_TILE),
         2 * N * D * 2 + touched * 3 * D * F * 2 + 3 * N_pad * F * 2, 3 * 2 * N * D * F,
         [gmm(xv, wg), gmm(xv, wu), gmm(dyv, t(wd))]),
        ("grouped_bwd_dx", lambda: eg.bwd_dx_cuda(dg, du, wg, wu, tg, tr),
         lambda: ref.grouped_bwd_dx_ref(dg, du, wg, wu, gs, eg.ROW_TILE),
         2 * N * F * 2 + touched * 2 * D * F * 2 + N_pad * D * 2, 2 * 2 * N * D * F,
         [gmm(dgv, t(wg)), gmm(duv, t(wu))]),
        ("grouped_bwd_wgrad", lambda: eg.bwd_wgrad_cuda(xs, dy, h, dg, du, gs),
         lambda: ref.grouped_bwd_wgrad_ref(xs, dy, h, dg, du, gs, eg.ROW_TILE),
         2 * N * D * 2 + 3 * N * F * 2 + 3 * E * D * F * 2, 3 * 2 * N * D * F,
         [gmm(t(xv), dgv), gmm(t(xv), duv), gmm(t(hv), dyv)]),
    )
    rows = []
    for name, fn, plain, nbytes, flops, lib in cases:
        side_ok = zeros and nan_case[name] and all(over_nan[name].values())
        row = _bwd_row(name, errs[name], side_ok, shape, fn, plain, nbytes, flops, library_sum_ms(lib), GMM_SUM,
                       GG_TOL)
        if row["library_ms"]:
            print(f"  {name} [{label}] kernel / library {row['ms'] / row['library_ms']:.3f}, "
                  f"bound / kernel {row['bound_ms'] / row['ms']:.3f}")
        rows.append(row)
    return rows


def digests(seed: int) -> dict:
    """SHA-256 (first 16 hex digits) of the outputs of the wgmma/TMA GEMM
    kernels (#2, #5-#7) at llama3-e8t2 widths on inputs drawn from
    ``seed``, each kernel fed its own random inputs. Two trees whose
    digests agree compute bit-equal outputs (``--digest``)."""
    import hashlib

    import torch
    from repro_torch.kernels import expert_gemm as eg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    sha = lambda *ts: hashlib.sha256(b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                              for t in ts)).hexdigest()[:16]
    rand = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()
    out = {}
    for C in (4, 300, 512):
        wd = rand(8, 14336, 4096, scale=14336 ** -0.5)
        out[f"expert_down C={C}"] = sha(eg.expert_down_cuda(rand(8, C, 14336), wd))
    xs, dy, (wg, wu, wd), gs, _, _, N_pad = grouped_bwd_case(gen, (1100, 0, 517, 803, 64, 700, 431, 481))
    tg, tr = eg.group_tiling(gs, N_pad // eg.ROW_TILE)
    out["grouped_bwd_dh"] = sha(*eg.bwd_dh_cuda(xs, dy, wg, wu, wd, tg, tr))
    h, dg, du = (rand(N_pad, 14336) for _ in range(3))
    out["grouped_bwd_dx"] = sha(eg.bwd_dx_cuda(dg, du, wg, wu, tg, tr))
    out["grouped_bwd_wgrad"] = sha(*eg.bwd_wgrad_cuda(xs, dy, h, dg, du, gs))
    return out


def wgrad_errors(dws, xs, dy, h, dg, du, gs):
    """Worst max|diff|/max|plain| of (dWg, dWu, dWd) against the plain
    version, one expert at a time (the full fp32 plain result would not fit
    beside a training step), and whether empty experts got exact zeros."""
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels.ref import grouped_bwd_wgrad_expert_ref

    starts, counts = (t.tolist() for t in eg.expert_rows(gs))
    diff, scale, empty_zero = [0.0] * 3, [0.0] * 3, True
    for e, (s, g) in enumerate(zip(starts, counts)):
        if g == 0:
            empty_zero &= all(bool((d[e] == 0).all()) for d in dws)
            continue
        for i, r in enumerate(grouped_bwd_wgrad_expert_ref(xs, dy, h, dg, du, s, g)):
            diff[i] = max(diff[i], float((dws[i][e].float() - r).abs().max()))
            scale[i] = max(scale[i], float(r.abs().max()))
    return [(d, d / max(m, 1e-30)) for d, m in zip(diff, scale)], empty_zero


def _bwd_row(name, errs, side_ok, shape, fn, plain, nbytes, flops, lib_ms, lib_name, tol, reps: int = 5):
    import torch

    err = max(e[0] for e in errs)
    rel = max(e[1] for e in errs)
    ok = rel <= tol and side_ok and all(e[0] == e[0] for e in errs)  # e == e: not NaN
    b_ms, b_by = bound(nbytes, flops)
    row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, masked_ok=side_ok,
               ms=time_ms(fn, reps=reps, warmup=1), plain_ms=time_ms(plain, reps=2, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library=lib_name,
               shape=shape)
    torch.cuda.empty_cache()
    print(f"  {name} [{shape}] err {err:.4g} (rel {rel:.3g}, tol {tol}) masked rows / empty experts ok {side_ok} "
          f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library ({lib_name}) {lib_ms} ms "
          f"bound {b_ms:.4f} ms ({b_by})")
    if not ok:
        raise SystemExit(f"{name} [{shape}] disagrees with its plain version")
    return row


def live_pairs(Sq: int, Sk: int, window=None) -> int:
    """(query, key) pairs that causality and the window leave live."""
    import torch

    qp = torch.arange(Sq)[:, None] + (Sk - Sq)
    kp = torch.arange(Sk)[None, :]
    m = kp <= qp
    if window is not None:
        m &= kp > qp - window
    return int(m.sum())


def check_flash_bwd(gen, S: int, window=None, B=1, H=32, KV=8, d=128):
    """Kernels #17 and #18 against their plain versions on the same inputs
    (the forward kernel's out and lse, a random dout). Each kernel first
    writes into outputs filled with NaN, so a row it leaves unwritten stays
    NaN and fails the finiteness check instead of inheriting a right value
    from the caching allocator; a second launch into fresh outputs must be
    bit-equal to the first (no atomics, sums in a fixed order). Prints
    each kernel's time over SDPA's backward and its bound over its time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    scale = d ** -0.5
    q = torch.randn((B, S, H, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, d), generator=gen, device=dev).bfloat16()
    dout = torch.randn((B, S, H, d), generator=gen, device=dev).bfloat16()
    out, lse = fa.flash_fwd_cuda(q, k, v, True, window, scale)
    delta = ref.flash_bwd_delta(out, dout)
    args = (q, k, v, dout, lse, delta, True, window, scale)
    nan = float("nan")
    dq = fa.flash_bwd_dq_cuda(*args, out=torch.full_like(q, nan))
    dk, dv = fa.flash_bwd_dkv_cuda(*args, out=(torch.full_like(k, nan), torch.full_like(v, nan)))
    dq2 = fa.flash_bwd_dq_cuda(*args)
    dk2, dv2 = fa.flash_bwd_dkv_cuda(*args)
    dq_r = ref.flash_bwd_dq_ref(*args)
    dk_r, dv_r = ref.flash_bwd_dkv_ref(*args)
    torch.cuda.synchronize()
    pairs = B * H * live_pairs(S, S, window)
    shape = f"B={B} S={S} H={H} KV={KV} d={d} causal window={window}"
    # SDPA's backward alone (dq, dk, dv together), timed on a retained graph
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    if window is None:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    do_t = dout.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True), reps=20)
    in_bytes = (q.numel() + k.numel() + v.numel() + dout.numel()) * 2 + (lse.numel() + delta.numel()) * 4
    rows = []
    for name, outs, again, refs, out_bytes, flops, fn, plain in (
        ("flash_bwd_dq", (dq,), (dq2,), (dq_r,), dq.numel() * 2, 6 * d * pairs,
         lambda: fa.flash_bwd_dq_cuda(*args), lambda: ref.flash_bwd_dq_ref(*args)),
        ("flash_bwd_dkv", (dk, dv), (dk2, dv2), (dk_r, dv_r), (dk.numel() + dv.numel()) * 2, 8 * d * pairs,
         lambda: fa.flash_bwd_dkv_cuda(*args), lambda: ref.flash_bwd_dkv_ref(*args)),
    ):
        errs = [rel_err(a, b) for a, b in zip(outs, refs)]
        finite = all(bool(torch.isfinite(a.float()).all()) for a in outs)
        same = all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(outs, again))
        print(f"  {name} [{shape}] written over NaN: every value finite {finite}; two launches bit-equal {same}")
        row = _bwd_row(name, errs, finite and same, shape, fn, plain, in_bytes + out_bytes, flops, lib_ms,
                       "SDPA backward, dq dk dv together", FA_TOL, reps=20)
        print(f"  {name} [{shape}] kernel / SDPA backward {row['ms'] / lib_ms:.3f}; "
              f"bound / kernel {row['bound_ms'] / row['ms']:.3f}")
        rows.append(row)
    pair = rows[0]["ms"] + rows[1]["ms"]
    print(f"  flash_bwd_dq + flash_bwd_dkv [{shape}] {pair:.4f} ms, {pair / lib_ms:.3f} x SDPA's backward "
          f"({lib_ms:.4f} ms); bound {rows[0]['bound_ms'] + rows[1]['bound_ms']:.4f} ms")
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel call sites (``ops.grouped_gemm``,
    ``ops.grouped_gemm_q8``, ``ops.grouped_gemm_fused``,
    ``ops.grouped_gemm_fused_q8``, ``ops.flash_attention``,
    ``ops.paged_attention``, ``ops.paged_attention_q8``, and
    ``expert_gemm.expert_gemm`` and ``expert_gemm.expert_gemm_q8`` under
    ``ops.expert_gemm`` and ``ops.expert_gemm_q8``) to the kernels' plain
    versions for the block: the same path and arithmetic as the kernel run,
    without the kernels."""
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ops, ref

    names = ("grouped_gemm", "grouped_gemm_q8", "grouped_gemm_fused", "grouped_gemm_fused_q8", "flash_attention",
             "paged_attention", "paged_attention_q8")
    saved = {n: getattr(ops, n) for n in names}
    saved_eg, saved_eg_q8 = eg.expert_gemm, eg.expert_gemm_q8
    ops.grouped_gemm = ref.grouped_gemm_ref
    ops.grouped_gemm_q8 = ref.grouped_gemm_q8_ref
    ops.grouped_gemm_fused = ref.grouped_gemm_fused_ref
    ops.grouped_gemm_fused_q8 = ref.grouped_gemm_fused_q8_ref
    ops.flash_attention = lambda q, k, v, causal=True, window=None, scale=None: ref.flash_attention_ref(
        q, k, v, causal, window, scale)
    ops.paged_attention = ref.paged_attention_ref
    ops.paged_attention_q8 = ref.paged_attention_q8_ref
    eg.expert_gemm, eg.expert_gemm_q8 = ref.expert_gemm_ref, ref.expert_gemm_q8_ref
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)
        eg.expert_gemm, eg.expert_gemm_q8 = saved_eg, saved_eg_q8


def fused_checked(report: list, x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                  scales=None):
    """The fused path's two kernels in order (#12 then #13, or with
    ``scales`` #14 then #15), each held against its plain version fed the
    same inputs (the gate/up kernel's own h for the down check); appends
    one (kernel, shape, max|diff|/max|plain|) per kernel to ``report``
    (inf where a padding row of h is not exactly 0) and returns the
    kernels' combined output."""
    import torch
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ref

    T = x.shape[0]
    tok_pad, row_out, gate_pad, tg, tr, k = eg.fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted, T)
    valid = valid_rows(group_sizes, tok_pad.shape[0])
    with torch.no_grad():
        if scales is None:
            h = eg.fused_gate_up_cuda(x, w_gate, w_up, tok_pad, tg, tr)
            h_r = ref.fused_gate_up_ref(x, w_gate, w_up, tok_pad, tg, tr)
            part = eg.fused_down_cuda(h, w_down, row_out, gate_pad, tg, tr, k, T)
            part_r = ref.fused_down_ref(h, w_down, row_out, gate_pad, tg, tr, k, T)
            names = ("grouped_gate_up_fused", "grouped_down_fused")
        else:
            sg, su, sd = scales
            h = eg.fused_gate_up_q8_cuda(x, w_gate, w_up, sg, su, tok_pad, tg, tr)
            h_r = ref.fused_gate_up_q8_ref(x, w_gate, w_up, sg, su, tok_pad, tg, tr)
            part = eg.fused_down_q8_cuda(h, w_down, sd, row_out, gate_pad, tg, tr, k, T)
            part_r = ref.fused_down_q8_ref(h, w_down, sd, row_out, gate_pad, tg, tr, k, T)
            names = ("grouped_gate_up_fused_q8", "grouped_down_fused_q8")
    pad_zero = bool((h[~valid] == 0).all())
    report.append((names[0], tuple(x.shape), rel_err(h[valid], h_r[valid])[1] if pad_zero else float("inf")))
    report.append((names[1], tuple(x.shape), rel_err(part, part_r)[1]))
    return ref.combine_partials(part, x.dtype)


@contextlib.contextmanager
def checked_kernels(report: list):
    """Inside the block every kernel call of the model, forward and backward,
    also runs its plain version on the same inputs and appends (kernel,
    input shape, max|diff| / max|plain|) to ``report``; the kernel's output
    is what the model uses. The grouped and fused forwards and the backward
    passes are wrapped where the autograd Functions look them up
    (``expert_gemm.grouped_gemm_fwd``, ``grouped_gemm_fused_fwd``,
    ``grouped_gemm_bwd``, ``flash_attention.flash_bwd``), so the fused
    backward's recompute is held too; each kernel of a multi-kernel pass
    is held against its plain version fed that kernel's own inputs (the
    padded int8 FFN ``expert_gemm.expert_gemm_q8`` as #8 then #9)."""
    import torch
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref

    gfwd, fa, pa, pa8 = eg.grouped_gemm_fwd, ops.flash_attention, ops.paged_attention, ops.paged_attention_q8
    gq8, egm, egq8 = ops.grouped_gemm_q8, eg.expert_gemm, eg.expert_gemm_q8
    gbwd, fbwd = eg.grouped_gemm_bwd, fa_mod.flash_bwd
    ffwd, fq8 = eg.grouped_gemm_fused_fwd, ops.grouped_gemm_fused_q8

    def grouped_q8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block=128):
        y = gq8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)
        r = ref.grouped_gemm_q8_ref(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)
        report.append(("grouped_gemm_q8", tuple(xs.shape), rel_err(y, r)[1]))
        return y

    def expert(xe, w_gate, w_up, w_down):
        y = egm(xe, w_gate, w_up, w_down)
        with torch.no_grad():
            r = ref.expert_gemm_ref(xe, w_gate, w_up, w_down)
        report.append(("expert_gemm", tuple(xe.shape), rel_err(y, r)[1]))
        return y

    def expert_q8(xe, w_gate, w_up, w_down, s_gate, s_up, s_down):
        eg._check_padded(xe, w_gate, w_up, w_down, torch.int8, (s_gate, s_up, s_down))
        h = eg.expert_gate_up_q8_cuda(xe, w_gate, w_up, s_gate, s_up)
        y = eg.expert_down_q8_cuda(h, w_down, s_down)
        report.append(("expert_gate_up_q8", tuple(xe.shape),
                       rel_err(h, ref.expert_gate_up_q8_ref(xe, w_gate, w_up, s_gate, s_up))[1]))
        report.append(("expert_down_q8", tuple(xe.shape), rel_err(y, ref.expert_down_q8_ref(h, w_down, s_down))[1]))
        return y

    def grouped(xs, w_gate, w_up, w_down, group_sizes, row_block=128):
        y = gfwd(xs, w_gate, w_up, w_down, group_sizes, row_block)
        with torch.no_grad():
            r = ref.grouped_gemm_ref(xs, w_gate, w_up, w_down, group_sizes, row_block)
        report.append(("grouped_gemm", tuple(xs.shape), rel_err(y, r)[1]))
        return y

    def fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block=128):
        return fused_checked(report, x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted)

    def fused_q8(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot, gate_sorted,
                 row_block=128):
        return fused_checked(report, x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                             (s_gate, s_up, s_down))

    def flash(q, k, v, causal=True, window=None, scale=None):
        y = fa(q, k, v, causal, window, scale)
        with torch.no_grad():
            r = ref.flash_attention_ref(q, k, v, causal, window, scale)
        report.append(("flash_fwd", tuple(q.shape), rel_err(y, r)[1]))
        return y

    def paged(q, k_pool, v_pool, bt, sl, window=None, scale=None):
        y = pa(q, k_pool, v_pool, bt, sl, window, scale)
        r = ref.paged_attention_ref(q, k_pool, v_pool, bt, sl, window, scale)
        report.append(("paged_attention", (tuple(q.shape), tuple(bt.shape)), rel_err(y, r)[1]))
        return y

    def paged_q8(q, k_pool, v_pool, k_scale, v_scale, bt, sl, window=None, scale=None):
        y = pa8(q, k_pool, v_pool, k_scale, v_scale, bt, sl, window, scale)
        r = ref.paged_attention_q8_ref(q, k_pool, v_pool, k_scale, v_scale, bt, sl, window, scale)
        report.append(("paged_attention_q8", (tuple(q.shape), tuple(bt.shape)), rel_err(y, r)[1]))
        return y

    def grouped_backward(xs, dy, w_gate, w_up, w_down, group_sizes, row_block=128):
        out, errs, zeros = grouped_bwd_checked(xs, dy, w_gate, w_up, w_down, group_sizes)
        for name, e in errs.items():
            report.append((name, tuple(xs.shape), max(x[1] for x in e) if zeros else float("inf")))
        return out

    def flash_backward(q, k, v, out, lse, dout, causal, window, scale):
        delta = ref.flash_bwd_delta(out, dout)
        args = (q, k, v, dout, lse, delta, causal, window, scale)
        dq = fa_mod.flash_bwd_dq_cuda(*args)
        report.append(("flash_bwd_dq", tuple(q.shape), rel_err(dq, ref.flash_bwd_dq_ref(*args))[1]))
        dk, dv = fa_mod.flash_bwd_dkv_cuda(*args)
        report.append(("flash_bwd_dkv", tuple(q.shape),
                       max(rel_err(a, b)[1] for a, b in zip((dk, dv), ref.flash_bwd_dkv_ref(*args)))))
        return dq, dk, dv

    eg.grouped_gemm_fwd, ops.flash_attention = grouped, flash
    ops.paged_attention, ops.paged_attention_q8 = paged, paged_q8
    ops.grouped_gemm_q8, eg.expert_gemm, eg.expert_gemm_q8 = grouped_q8, expert, expert_q8
    eg.grouped_gemm_bwd, fa_mod.flash_bwd = grouped_backward, flash_backward
    eg.grouped_gemm_fused_fwd, ops.grouped_gemm_fused_q8 = fused, fused_q8
    try:
        yield
    finally:
        eg.grouped_gemm_fwd, ops.flash_attention, ops.paged_attention, ops.paged_attention_q8 = gfwd, fa, pa, pa8
        ops.grouped_gemm_q8, eg.expert_gemm, eg.expert_gemm_q8 = gq8, egm, egq8
        eg.grouped_gemm_bwd, fa_mod.flash_bwd = gbwd, fbwd
        eg.grouped_gemm_fused_fwd, ops.grouped_gemm_fused_q8 = ffwd, fq8


def report_checked(report: list, names, path: str = "serving") -> None:
    """Print the worst per-call disagreement of each kernel in ``report``;
    fail if a kernel was never called or disagrees."""
    for name in names:
        calls = [r for r in report if r[0] == name]
        if not calls:
            raise SystemExit(f"{name} was never called in the checked {path} run")
        w = max(r[2] for r in calls)
        print(f"  in the {path} path: {len(calls)} {name} calls vs their plain versions on the same "
              f"inputs, worst max|diff|/max|plain| {w:.4g} (tol {GG_TOL}); shapes "
              f"{sorted({r[1] for r in calls})}")
        if not w <= GG_TOL:
            raise SystemExit(f"{name} disagrees with its plain version inside the {path} path")


def ring_prompts(seed: int, vocab: int, requests: int = 8, max_new: int = 32):
    """The ring serves' requests: ``requests`` prompts of 16-300 tokens
    (the first 300, so its bucket is the ragged cap) drawn from ``seed``,
    and the engine's max_seq as launch/serve.py sets it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 301, size=requests)
    lens[0] = 300
    prompts = [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lens]
    return lens, prompts, int(lens.max()) + max_new + 8


def serve(seed: int, layers: int = 4, requests: int = 8, max_new: int = 32, max_batch: int = 4):
    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.kernels import ops
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    cfg = with_dispatcher(get_config("llama3-e8t2").replace(num_layers=layers), "sorted")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"d_ff {cfg.d_ff}, experts {cfg.moe.num_experts} top-{cfg.moe.top_k}, vocab {cfg.vocab_size} "
          f"(padded {cfg.padded_vocab}); cut: num_layers 32 -> {layers}")
    t0 = time.perf_counter()
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    torch.cuda.synchronize()
    print(f"  weights drawn on the card from seed {seed} in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    lens, prompts, max_seq = ring_prompts(seed, cfg.vocab_size, requests, max_new)

    def run(_kernels: bool, which=None, new=max_new):  # kernels on; the flag is profile_window's
        return ring_serve_run(cfg, params, prompts, max_seq, which, new, max_batch)

    run(True, [len(prompts) - 1], 2)  # warm-up: library load, cuBLAS handles
    ops.reset_launch_counts()
    eng, out_k, wall = run(True)
    launches = ops.launch_counts()
    buckets = sorted({eng._bucket(int(L)) for L in lens})
    ntok = sum(len(v) for v in out_k.values())
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    print(f"  prompt lengths {lens.tolist()}, max_seq {max_seq}, prefill buckets {buckets}")
    print(f"  served {len(out_k)} requests, {ntok} tokens in {wall:.3f} s ({ntok / wall:.2f} tok/s); "
          f"prefill mean {1e3 * sum(pre) / len(pre):.3f} ms over {len(pre)}; "
          f"decode step mean {1e3 * sum(dec) / len(dec):.3f} ms over {len(dec)} steps")
    print(f"  kernel launches during the serve run: {launches}")
    if not all(len(v) == max_new for v in out_k.values()):
        raise SystemExit("a request did not receive all its tokens")
    ring_kernels = ("grouped_gate_up", "grouped_down", "flash_fwd")
    if not all(launches[n] > 0 for n in ring_kernels):
        raise SystemExit(f"a kernel of the serving path was never launched: {launches}")

    # every kernel call of a prefill (at the 340 and 32 buckets) and of the
    # decode steps, held against its plain version on the same inputs
    report: list = []
    with checked_kernels(report):
        run(True, [0, 5], 3)
    report_checked(report, ("grouped_gemm", "flash_fwd"))

    # end to end at full width: the kernels' path, the same path on the
    # kernels' plain versions, and the use_kernel=False path. With random
    # weights this model amplifies bf16 rounding (two kernel-free paths
    # differ by tens of percent), so these are reported, not gated; the
    # gate is the per-call check above and the small-input check below.
    diffs = {"kernels_vs_plain": 0.0, "kernels_vs_xla": 0.0, "plain_vs_xla": 0.0}
    with torch.inference_mode():
        for p in prompts:
            lk, lp, lx = prefill_three_ways(cfg, params, p, eng._bucket(len(p)), max_seq)
            for k, (a, b) in {"kernels_vs_plain": (lk, lp), "kernels_vs_xla": (lk, lx),
                              "plain_vs_xla": (lp, lx)}.items():
                diffs[k] = max(diffs[k], rel_err(a, b)[1])
    print(f"  first-token logits at full width, max |diff| / max |logits| over the {len(prompts)} prompts: "
          + ", ".join(f"{k} {v:.4g}" for k, v in diffs.items()))
    with plain_kernels():
        _, out_p, wall_p = run(True)
    same = sum(a == b for r in out_k for a, b in zip(out_k[r], out_p[r]))
    print(f"  greedy tokens, kernels vs plain-version serve run: {same}/{ntok} positions equal "
          f"(plain run {wall_p:.3f} s)")
    profile_window(run)
    del eng, params
    torch.cuda.empty_cache()
    small_input_check(seed)
    return launches, dict(tokens_per_s=ntok / wall, prefill_ms=1e3 * sum(pre) / len(pre),
                          decode_step_ms=1e3 * sum(dec) / len(dec), **diffs)


def prefill_three_ways(cfg, params, prompt, bucket: int, cache_len: int):
    """First-token logits of one prompt through the kernels, through their
    plain versions on the same path, and through the use_kernel=False path;
    each is checked for shape and finiteness."""
    import torch
    from repro_torch.models.model import prefill_forward

    dev = params["final_norm"]["scale"].device
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
    vl = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    batch = {"tokens": toks}
    lk, _ = prefill_forward(cfg, params, batch, cache_len, True, vl)
    with plain_kernels():
        lp, _ = prefill_forward(cfg, params, batch, cache_len, True, vl)
    lx, _ = prefill_forward(cfg, params, batch, cache_len, False, vl)
    for lg in (lk, lp, lx):
        if lg.shape != (1, cfg.padded_vocab) or not bool(torch.isfinite(lg).all()):
            raise SystemExit(f"prefill logits malformed: {tuple(lg.shape)}")
    return lk, lp, lx


def small_input_check(seed: int) -> None:
    """End to end on a small input: the smoke config of llama3-e8t2 cut to
    one layer (d_model 256, head_dim 64, 4 experts), seeded weights. The
    first-token logits through the kernels must agree with the same path on
    the kernels' plain versions within LOGIT_TOL x max|logits|. One layer
    keeps the check well conditioned: each added random bf16 layer
    amplifies rounding (at two layers the card measured 5.9% between two
    kernel-free paths, at one layer the CPU measures 0.1%)."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, smoke_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    cfg = with_dispatcher(smoke_config(get_config("llama3-e8t2")).replace(num_layers=1), "sorted")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    rng = np.random.default_rng(seed)
    worst, worst_xla, agree = 0.0, 0.0, 0
    lens = (12, 40, 100)
    with torch.inference_mode():
        for L in lens:
            p = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            lk, lp, lx = prefill_three_ways(cfg, params, p, max(16, 1 << (L - 1).bit_length()), 128)
            worst = max(worst, rel_err(lk, lp)[1])
            worst_xla = max(worst_xla, rel_err(lp, lx)[1])
            agree += int(lk[0, :cfg.vocab_size].argmax() == lp[0, :cfg.vocab_size].argmax())
    print(f"  small input (smoke config, 1 layer, prompts {list(lens)}): first-token logits, kernels vs their "
          f"plain versions {worst:.4g} of max|logits| (tol {LOGIT_TOL}); plain vs use_kernel=False "
          f"{worst_xla:.4g}; greedy first tokens agree {agree}/{len(lens)}")
    if worst > LOGIT_TOL:
        raise SystemExit("kernel path logits disagree with the plain versions on the small input")


# ---------------------------------------------------------------------------
# phase 5: paged serve
# ---------------------------------------------------------------------------


def serve_paged(seed: int, layers: int = 4, requests: int = 8, max_new: int = 32, max_batch: int = 4,
                stem_len: int = 64):
    """llama3-e8t2 at full width (``layers`` deep) through the paged engine:
    page size 16, prefill chunk 32, prefix cache on, once with bf16 KV pages
    and once with int8. The prompts (16-300 tokens) share a 64-token stem,
    so requests admitted after the first wave hit the prefix trie."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.kernels import ops
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.kv_cache import ring_kv_bytes

    cfg = with_dispatcher(get_config("llama3-e8t2").replace(num_layers=layers), "sorted")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(16, 301, size=requests)
    lens[0] = 300
    stem = rng.integers(0, cfg.vocab_size, stem_len)
    prompts = [np.concatenate([stem, rng.integers(0, cfg.vocab_size, max(int(L) - stem_len, 0))])[:L]
               .astype(np.int32) for L in lens]
    max_seq = int(lens.max()) + max_new + 8
    print(f"  {cfg.name}, {layers} layers at full width, prompt lengths {lens.tolist()} sharing a "
          f"{stem_len}-token stem, max_seq {max_seq}, page size 16, prefill chunk 32, max_batch {max_batch}")

    def run(use_kernel: bool, which=None, new=max_new, quant="none", mode="paged"):
        kw = (dict(cache_mode="paged", page_size=16, prefill_chunk=32, prefix_cache=True, quant_kv=quant)
              if mode == "paged" else {})
        eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq, use_kernel=use_kernel,
                            device="cuda", **kw)
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=new)
                for i in (which if which is not None else range(len(prompts)))]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t

    run(True, [len(prompts) - 1], 2, mode="ring")  # warm-up: library load, cuBLAS handles
    _, out_ring, _ = run(True, mode="ring")
    ring_bytes = ring_kv_bytes(cfg, max_batch, max_seq)
    results, launches_by_mode = {}, {}
    for quant in ("none", "int8"):
        pa_name = "paged_attention_q8" if quant == "int8" else "paged_attention"
        tag = f"paged {'int8' if quant == 'int8' else 'bf16'} KV"
        run(True, [len(prompts) - 1], 2, quant=quant)  # warm-up
        ops.reset_launch_counts()
        eng, out, wall = run(True, quant=quant)
        launches = ops.launch_counts()
        ntok = sum(len(v) for v in out.values())
        pre, dec, plan = eng.timings["prefill_chunk_s"], eng.timings["decode_s"], eng.timings["plan_s"]
        kv = eng.kv_stats()
        px = kv["prefix"]
        preempt = sum(r.preemptions for r in eng.sched.requests.values())
        same = sum(a == b for r in out for a, b in zip(out[r], out_ring[r]))
        print(f"  [{tag}] served {len(out)} requests, {ntok} tokens in {wall:.3f} s ({ntok / wall:.2f} tok/s); "
              f"prefill chunk mean {1e3 * sum(pre) / len(pre):.3f} ms over {len(pre)}; decode step mean "
              f"{1e3 * sum(dec) / len(dec):.3f} ms over {len(dec)} steps; scheduler plan mean "
              f"{1e3 * sum(plan) / len(plan):.4f} ms (host) over {len(plan)} steps")
        print(f"  [{tag}] peak KV {kv['kv_bytes_peak']} bytes ({kv['peak_used_pages']}/{kv['num_pages']} pages) "
              f"vs the ring cache's {ring_bytes} bytes; prefix cache {px['hits']}/{px['lookups']} hits, "
              f"{px['hit_tokens']} prompt tokens from cache, {px['cow_clones']} COW clones; "
              f"preemptions {preempt}")
        print(f"  [{tag}] kernel launches during the serve run: {launches}")
        print(f"  [{tag}] greedy tokens vs the ring engine on the same requests: {same}/{ntok} positions "
              f"equal (reported, not gated: bf16 rounding differs between the two paths)")
        if not all(len(v) == max_new for v in out.values()):
            raise SystemExit(f"[{tag}] a request did not receive all its tokens")
        needed = ("grouped_gate_up", "grouped_down", pa_name)
        if not all(launches[n] > 0 for n in needed):
            raise SystemExit(f"[{tag}] a kernel of the paged path was never launched: {launches}")
        if px["hits"] < 1:
            raise SystemExit(f"[{tag}] the prefix cache never hit")
        report: list = []
        with checked_kernels(report):
            run(True, [0, 5], 3, quant=quant)
        report_checked(report, ("grouped_gemm", pa_name))
        busy = profile_window(lambda *a: run(*a, quant=quant))
        launches_by_mode[quant] = launches
        results["bf16" if quant == "none" else "int8"] = dict(
            tokens_per_s=ntok / wall, prefill_chunk_ms=1e3 * sum(pre) / len(pre),
            decode_step_ms=1e3 * sum(dec) / len(dec), plan_ms=1e3 * sum(plan) / len(plan),
            kv_bytes_peak=kv["kv_bytes_peak"],
            ring_kv_bytes=ring_bytes, prefix_hits=px["hits"], prefix_lookups=px["lookups"],
            preemptions=preempt, equal_to_ring=f"{same}/{ntok}", device_busy_share=busy)
    del params
    torch.cuda.empty_cache()
    paged_small_input_check(seed)
    return launches_by_mode, results


def paged_logits(cfg, params, prompt, next_tok=None, ps: int = 16, chunk: int = 32):
    """First-token logits of one prompt prefilled in chunks through
    ``paged_forward``, then the logits of one decode step on ``next_tok``
    (default: the first token's argmax); kernels wherever ``ops`` routes."""
    import torch
    from repro_torch.models.model import decode_step_paged, paged_forward
    from repro_torch.serving.kv_cache import init_paged_pool

    dev = torch.device("cuda")
    L = len(prompt)
    n_pages = -(-(L + 1) // ps)
    pool = init_paged_pool(cfg, n_pages, ps, device=dev)
    bt = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)
    for start in range(0, L, chunk):
        n = min(chunk, L - start)
        toks = torch.zeros((1, chunk), dtype=torch.long, device=dev)
        toks[0, :n] = torch.as_tensor(prompt[start:start + n], device=dev)
        first, _ = paged_forward(cfg, params, pool, toks, one(start), bt, one(n), use_kernel=True)
    tok = int(first[0, :cfg.vocab_size].argmax()) if next_tok is None else next_tok
    dec, _ = decode_step_paged(cfg, params, pool, one(tok), one(L), bt, one(1), use_kernel=True)
    for lg in (first, dec):
        if lg.shape != (1, cfg.padded_vocab) or not bool(torch.isfinite(lg).all()):
            raise SystemExit(f"paged logits malformed: {tuple(lg.shape)}")
    return first, dec, tok


def paged_small_input_check(seed: int) -> None:
    """The small-input gate of the paged path: the smoke config of
    llama3-e8t2 cut to one layer, bf16 and int8 KV pages. The first-token
    logits and the next decode step's logits through the kernels (grouped
    GEMM, paged attention) must agree with the same path on the kernels'
    plain versions within LOGIT_TOL x max|logits|."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, smoke_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    cfg = with_dispatcher(smoke_config(get_config("llama3-e8t2")).replace(num_layers=1), "sorted")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    rng = np.random.default_rng(seed)
    lens = (12, 40, 100)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32) for L in lens]
    with torch.inference_mode():
        for quant in ("none", "int8"):
            qcfg = cfg.replace(quant_kv=quant)
            worst_first = worst_dec = 0.0
            for p in prompts:
                fk, dk, tok = paged_logits(qcfg, params, p)
                with plain_kernels():
                    fp, dp, _ = paged_logits(qcfg, params, p, next_tok=tok)
                worst_first = max(worst_first, rel_err(fk, fp)[1])
                worst_dec = max(worst_dec, rel_err(dk, dp)[1])
            print(f"  small input (smoke config, 1 layer, paged, {quant} KV, prompts {list(lens)}): kernels vs "
                  f"their plain versions, first-token logits {worst_first:.4g}, decode-step logits "
                  f"{worst_dec:.4g} of max|logits| (tol {LOGIT_TOL})")
            if max(worst_first, worst_dec) > LOGIT_TOL:
                raise SystemExit(f"paged kernel path logits ({quant} KV) disagree with the plain versions")


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

UPCYCLE_CE_TOL = 1e-3  # nats: MoE vs dense CE on one batch at the upcycled start
# of max|logits|: the upcycled params vs the dense parent's, both cast to
# fp32, logits through the plain path on the first batch (a smoke-size CPU
# run gives 1.2e-6 clean and 0.26 with one expert's w_down redrawn; in bf16
# the random-weight model's rounding alone reaches a few % of max|logits|)
UPCYCLE_LOGIT_TOL = 1e-4
GRAD_TOL = 2e-2  # of max|grad| per parameter, kernels vs autograd of the plain forward
PEAK_BF16_TFLOPS = BF16_FLOP_PER_S / 1e12


def named_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def moe_train_config(layers: int, smoke: bool = False):
    """llama3-e8t2 (or its smoke config) cut to ``layers``, trained as the
    JAX launcher's ``--upcycle 8 --top-k 2 --cf -1 --dispatcher sorted``:
    dropless, so no capacity factor."""
    import dataclasses
    from repro_torch.config import get_config, smoke_config

    cfg = get_config("llama3-e8t2")
    cfg = smoke_config(cfg) if smoke else cfg
    return cfg.replace(num_layers=layers, moe=dataclasses.replace(cfg.moe, capacity_factor=None, dispatcher="sorted"))


def train(seed: int, layers: int = 2, steps: int = 8, seq: int = 2048):
    """Phase 6 (b)-(d): upcycle a dense llama3-8b drawn from the seed, check
    the warm start, train ``steps`` steps of 1 x ``seq`` tokens with kernels
    on, profile one more step, hold every kernel call of one more step
    against its plain version and check every parameter's gradient."""
    import gc

    import torch
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data.pipeline import make_train_iter
    from repro_torch.kernels import ops
    from repro_torch.models.model import forward, loss_fn, model_decl
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.params import init_from_decls, tree_map
    from repro_torch.train.callbacks import LoggingCallback
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  memory allocated at the start of the phase: {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    dense_cfg = get_config("llama3-8b").replace(num_layers=layers)
    cfg = moe_train_config(layers)
    total, active = cfg.param_counts()
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, "
          f"experts {cfg.moe.num_experts} top-{cfg.moe.top_k} (dropless, sorted), vocab {cfg.vocab_size}; cut: "
          f"num_layers 32 -> {layers}; {total / 1e9:.3f} B params, {active / 1e9:.3f} B active; remat "
          f"{cfg.remat}; batch 1 x {seq} tokens")
    tcfg = TrainConfig(global_batch=1, seq_len=seq, lr=3e-4, lr_min=3e-6, warmup_steps=1,
                       total_steps=steps + 2, seed=seed, log_every=1)
    data = lambda: make_train_iter(cfg.vocab_size, seq, 1, tcfg.blend_ratio, seed)
    dev = torch.device("cuda")
    first = {k: torch.from_numpy(v).to(dev) for k, v in next(data()).items()}

    # (b) the upcycled start: dense parent vs MoE on the first batch
    t0 = time.perf_counter()
    dense = init_from_decls(model_decl(dense_cfg), seed, dev)
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    with torch.no_grad():
        _, dm = loss_fn(dense_cfg, dense, first, use_kernel=True)
        params = upcycle_params(dense_cfg, cfg, dense, seed)
        dense_logits, _ = forward(dense_cfg.replace(dtype="float32"), f32(dense), first)
        moe_logits, _ = forward(cfg.replace(dtype="float32"), f32(params), first)
    _, logit_err = rel_err(moe_logits, dense_logits)
    del dense, dense_logits, moe_logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  upcycled start: MoE vs dense parent logits, params cast to fp32, plain path, first batch: "
          f"{logit_err:.4g} of max|logits| (tol {UPCYCLE_LOGIT_TOL})")
    if not logit_err <= UPCYCLE_LOGIT_TOL:
        raise SystemExit("the upcycled MoE's logits are not the dense parent's")
    state = TrainState(0, params, adamw_init(params), torch.Generator(device=dev))
    torch.cuda.synchronize()
    print(f"  dense llama3-8b ({layers} layers) drawn from seed {seed} and upcycled in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated with the optimizer state")

    # (c) the training run
    trainer = Trainer(cfg, tcfg, state=state, data_iter=data(), use_kernel=True)
    log = LoggingCallback(log=lambda m: print("  " + m), log_every=1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer.run(steps, callbacks=[log])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    steady_ms = hist[-1]["ms_per_step_steady"]
    tflops = hist[-1]["model_tflops_per_sec"]
    per_step = {k: v / steps for k, v in launches.items() if v}
    print(f"  losses {[round(r['loss'], 4) for r in hist]}")
    print(f"  steady {steady_ms:.3f} ms/step (steps 2-{steps}), {seq / steady_ms * 1e3:.1f} tok/s, model "
          f"{tflops:.2f} TFLOP/s (3x convention), MFU {100 * tflops / PEAK_BF16_TFLOPS:.2f}% of "
          f"{PEAK_BF16_TFLOPS:.0f} TFLOP/s; first step {1e3 * log.durations[0]:.1f} ms")
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    print(f"  kernel launches per step: {per_step}")
    ce1, dce = hist[0]["ce"], float(dm["ce"])
    print(f"  upcycled start: step-1 CE {ce1:.5f} (loss {hist[0]['loss']:.5f} with aux) vs the dense parent's "
          f"CE {dce:.5f} on the same batch: |diff| {abs(ce1 - dce):.3g} (tol {UPCYCLE_CE_TOL})")
    if not abs(ce1 - dce) <= UPCYCLE_CE_TOL:
        raise SystemExit("the upcycled MoE's first loss is not the dense parent's")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit(f"the loss did not fall over {steps} steps")
    expect = {"grouped_gate_up": 2 * layers, "grouped_down": 2 * layers, "flash_fwd": 2 * layers,
              **{k: layers for k in ("grouped_bwd_dh", "grouped_bwd_dx", "grouped_bwd_wgrad",
                                     "flash_bwd_dq", "flash_bwd_dkv")}}
    if any(launches.get(k, 0) != n * steps for k, n in expect.items()):
        raise SystemExit(f"launches per step {per_step}, expected {expect}")
    if not peak < torch.cuda.get_device_properties(0).total_memory:
        raise SystemExit("peak memory above the card's capacity")

    busy = profile_train_step(trainer)

    # (d) every kernel call of one step against its plain version; every
    # parameter's gradient
    report: list = []
    named = named_leaves(trainer.params)
    batch = trainer._to_device(next(trainer.data_iter))
    with checked_kernels(report):
        loss, _ = loss_fn(cfg, trainer.params, batch, trainer.state.gen, use_kernel=True)
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    torch.cuda.synchronize()
    report_checked(report, ("grouped_gemm", "flash_fwd", "grouped_bwd_dh", "grouped_bwd_dx", "grouped_bwd_wgrad",
                            "flash_bwd_dq", "flash_bwd_dkv"), "training")
    bad = [n for (n, _), g in zip(named, grads)
           if g is None or not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0]
    print(f"  gradients: {len(named) - len(bad)}/{len(named)} parameters with a finite, nonzero gradient")
    if bad:
        raise SystemExit(f"parameters without a gradient: {bad}")
    del grads, loss, trainer, state, params
    gc.collect()
    torch.cuda.empty_cache()
    grad_err = small_grad_check(seed)
    return launches, dict(
        losses=[r["loss"] for r in hist], ces=[r["ce"] for r in hist], ms_per_step=steady_ms,
        tokens_per_s=seq / steady_ms * 1e3, model_tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS,
        peak_bytes=peak, launches_per_step=per_step, device_busy_share=busy, step1_ce=ce1, dense_ce=dce,
        upcycle_logit_rel_err=logit_err,
        small_grad_rel_err=grad_err)


def profile_train_step(trainer) -> float:
    """torch.profiler over one training step: device time by kernel and the
    device's busy share of the step's wall time, which it returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(1, callbacks=[])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return device_busy(prof, wall, "one training step")


def small_grad_check(seed: int, fused: bool = False) -> float:
    """End-to-end gradients on a small input: the smoke config of
    llama3-e8t2 cut to one layer (d_model 256, head_dim 64, 4 experts),
    batch 2 x 128, with ``fused`` through fused dispatch. Every parameter's
    gradient through the kernels (forward and backward) must agree with
    autograd through the plain forward (``plain_kernels``) within GRAD_TOL
    x max|grad|."""
    import dataclasses

    import torch
    from repro_torch.data.pipeline import make_train_iter
    from repro_torch.models.model import loss_fn, model_decl
    from repro_torch.params import init_from_decls

    cfg = moe_train_config(1, smoke=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, fused_dispatch=fused))
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(make_train_iter(cfg.vocab_size, 128, 2, seed=seed)).items()}
    grads = {}
    for mode in ("kernels", "plain"):
        with plain_kernels() if mode == "plain" else contextlib.nullcontext():
            loss, _ = loss_fn(cfg, params, batch, use_kernel=True)
            grads[mode] = torch.autograd.grad(loss, [t for _, t in named])
    errs = {n: rel_err(a, b)[1] for (n, _), a, b in zip(named, grads["kernels"], grads["plain"])}
    worst = max(errs, key=errs.get)
    print(f"  small input (smoke config, 1 layer, batch 2 x 128{', fused dispatch' if fused else ''}): gradients "
          f"through the kernels vs autograd "
          f"through the plain forward, worst {errs[worst]:.4g} of max|grad| ({worst}; tol {GRAD_TOL}); "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    if not errs[worst] <= GRAD_TOL:
        raise SystemExit("gradients through the kernels disagree with the plain forward's")
    return errs[worst]


def device_busy(prof, wall: float, label: str) -> float:
    """Device busy share of ``wall`` seconds from a torch.profiler trace:
    the union of the CUDA kernels' own intervals (an operator's device time
    would count its kernels a second time), with the kernels that took the
    most time by name."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"  profile ({label}): wall {1e3 * wall:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall) in {len(kernels)} kernels")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"    {t / 1e3:9.3f} ms  {n:5d} calls  {name[:100]}")
    return busy_us / 1e6 / wall


def profile_window(run) -> float:
    """torch.profiler over a short serve (prompts 0 and 5, 8 new tokens):
    device time by kernel and the device's busy share of the wall time,
    which it returns."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = run(True, [0, 5], 8)
    return device_busy(prof, wall, "2 requests, 8 new tokens")


# ---------------------------------------------------------------------------
# phase 7: padded (allgather) dispatch, serving and training
# ---------------------------------------------------------------------------


def ring_serve_run(cfg, params, prompts, max_seq: int, which=None, new: int = 32, max_batch: int = 4, **kw):
    """One ring-cache ServingEngine run with kernels on: (engine, outputs,
    wall seconds ending in a synchronise)."""
    import torch
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq, use_kernel=True, device="cuda", **kw)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=new)
            for i in (which if which is not None else range(len(prompts)))]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t


def counted_serve(tag: str, cfg, params, prompts, max_seq: int, needed, checked, max_new: int = 32, **kw):
    """Warm up, then one counted serve of all ``prompts`` (launch counts set
    to 0 just before, read just after; every kernel in ``needed`` must have
    launched and every request got all its tokens), then a short serve with
    every kernel call in ``checked`` held against its plain version, then a
    profiled window. Returns (launches, outputs, figures)."""
    from repro_torch.kernels import ops

    run = lambda which=None, new=max_new: ring_serve_run(cfg, params, prompts, max_seq, which, new, **kw)
    run([len(prompts) - 1], 2)  # warm-up
    ops.reset_launch_counts()
    eng, out, wall = run()
    launches = ops.launch_counts()
    ntok = sum(len(v) for v in out.values())
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    print(f"  [{tag}] served {len(out)} requests, {ntok} tokens in {wall:.3f} s ({ntok / wall:.2f} tok/s); "
          f"prefill mean {1e3 * sum(pre) / len(pre):.3f} ms over {len(pre)}; "
          f"decode step mean {1e3 * sum(dec) / len(dec):.3f} ms over {len(dec)} steps")
    print(f"  [{tag}] kernel launches during the serve run: { {k: v for k, v in launches.items() if v} }")
    if sorted(out) != list(range(len(prompts))) or not all(len(v) == max_new for v in out.values()):
        raise SystemExit(f"[{tag}] a request did not receive all its tokens")
    if not all(launches[n] > 0 for n in needed):
        raise SystemExit(f"[{tag}] a kernel of the path was never launched: {launches}")
    report: list = []
    with checked_kernels(report):
        run([0, 5], 3)
    report_checked(report, checked, tag)
    busy = profile_window(lambda _kernels, which, new: run(which, new))
    return launches, out, dict(tokens_per_s=ntok / wall, prefill_ms=1e3 * sum(pre) / len(pre),
                               decode_step_ms=1e3 * sum(dec) / len(dec), device_busy_share=busy)


def serve_padded(seed: int, layers: int = 4):
    """Phase 7 (a): llama3-e8t2 at full width, ``layers`` deep, through the
    padded allgather dispatcher at the config's CF 4 (C = T at E 8, top-2:
    prefill buckets pad to T slots per expert, decode has C 4), kernels on,
    the 8 requests of phase 3. Greedy tokens against the sorted run on the
    same weights are reported (CF 4 at this T drops nothing, but bf16
    rounding differs between the two paths)."""
    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    base = get_config("llama3-e8t2").replace(num_layers=layers)
    cfg = with_dispatcher(base, "allgather")
    print(f"  {cfg.name}, {layers} layers at full width, dispatcher allgather, capacity factor "
          f"{cfg.moe.capacity_factor}")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    lens, prompts, max_seq = ring_prompts(seed, cfg.vocab_size)
    launches, out, stats = counted_serve("padded ring", cfg, params, prompts, max_seq,
                                         ("expert_gate_up", "expert_down", "flash_fwd"), ("expert_gemm", "flash_fwd"))
    _, out_sorted, _ = ring_serve_run(with_dispatcher(base, "sorted"), params, prompts, max_seq)
    ntok = sum(len(v) for v in out.values())
    same = sum(a == b for r in out for a, b in zip(out[r], out_sorted[r]))
    print(f"  [padded ring] greedy tokens vs the sorted dispatcher on the same weights and requests: "
          f"{same}/{ntok} positions equal (reported, not gated)")
    del params
    torch.cuda.empty_cache()
    return launches, {**stats, "equal_to_sorted": f"{same}/{ntok}", **padded_small_input_check(seed)}


def padded_small_input_check(seed: int) -> dict:
    """The smoke config of llama3-e8t2 cut to one layer through allgather
    at CF 4 (C = T: nothing drops, so it computes the sorted path's
    function): the first-token logits through #1/#2 must agree with their
    plain versions' and with the sorted dispatcher's, each within
    LOGIT_TOL x max|logits| (a CPU run of the same check in bf16 measures
    up to 0.0014 between allgather and sorted)."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, smoke_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    base = smoke_config(get_config("llama3-e8t2")).replace(num_layers=1)
    cfg, cfg_sorted = with_dispatcher(base, "allgather"), with_dispatcher(base, "sorted")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    rng = np.random.default_rng(seed)
    worst, vs_sorted = 0.0, 0.0
    lens = (12, 40, 100)
    with torch.inference_mode():
        for L in lens:
            p = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            bucket = max(16, 1 << (L - 1).bit_length())
            lk, lp, _ = prefill_three_ways(cfg, params, p, bucket, 128)
            ls, _, _ = prefill_three_ways(cfg_sorted, params, p, bucket, 128)
            worst = max(worst, rel_err(lk, lp)[1])
            vs_sorted = max(vs_sorted, rel_err(lk, ls)[1])
    print(f"  small input (smoke config, 1 layer, allgather CF {cfg.moe.capacity_factor}, prompts {list(lens)}): "
          f"first-token logits, #1/#2 vs their plain versions {worst:.4g}, allgather vs sorted {vs_sorted:.4g} of "
          f"max|logits| (tol {LOGIT_TOL} each)")
    if max(worst, vs_sorted) > LOGIT_TOL:
        raise SystemExit("padded-dispatch logits disagree on the small input")
    return dict(small_padded_vs_plain=worst, small_padded_vs_sorted=vs_sorted)


@contextlib.contextmanager
def drop_counter(counts: list):
    """Inside the block every padded dispatch appends (assignments kept,
    assignments routed) to ``counts`` (one host read per MoE layer)."""
    from repro_torch.core.dispatch import allgather

    tables = allgather.dispatch_tables

    def counted(idx, gates, E, C):
        sel, slot_gate = tables(idx, gates, E, C)
        counts.append((int((slot_gate > 0).sum()), idx.numel()))
        return sel, slot_gate

    allgather.dispatch_tables = counted
    try:
        yield
    finally:
        allgather.dispatch_tables = tables


def train_padded(seed: int, layers: int = 2, steps: int = 8, seq: int = 2048, cf: float = 1.0):
    """Phase 7 (b): the Trainer on llama3-e8t2 at full width, ``layers``
    deep, drawn from the seed, 1 x ``seq`` tokens a step through the padded
    allgather dispatcher at CF ``cf`` (the paper's Table 4 setting: tokens
    really drop), kernels and remat on. The loss must fall; #1/#2 launch
    4 times a step (forward and remat recompute, 2 layers) and #5-#7 twice;
    then every kernel call of one more step, forward and backward, is held
    against its plain version."""
    import dataclasses
    import gc

    import torch
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.core.dispatch import capacity
    from repro_torch.data.pipeline import make_train_iter
    from repro_torch.kernels import ops
    from repro_torch.models.model import loss_fn
    from repro_torch.train.callbacks import LoggingCallback
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    base = get_config("llama3-e8t2")
    cfg = base.replace(num_layers=layers, moe=dataclasses.replace(base.moe, capacity_factor=cf,
                                                                  dispatcher="allgather"))
    C = capacity(cfg.moe, seq)
    total, active = cfg.param_counts()
    print(f"  config {cfg.name}: {layers} layers at full width, allgather at CF {cf} (C {C} slots per expert "
          f"for {seq} tokens x top-{cfg.moe.top_k}), {total / 1e9:.3f} B params; remat {cfg.remat}; "
          f"batch 1 x {seq}")
    tcfg = TrainConfig(global_batch=1, seq_len=seq, lr=3e-4, lr_min=3e-6, warmup_steps=1,
                       total_steps=steps + 2, seed=seed, log_every=1)
    trainer = Trainer(cfg, tcfg, data_iter=make_train_iter(cfg.vocab_size, seq, 1, tcfg.blend_ratio, seed),
                      use_kernel=True, device="cuda")
    log = LoggingCallback(log=lambda m: print("  " + m), log_every=1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer.run(steps, callbacks=[log])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    steady_ms, tflops = hist[-1]["ms_per_step_steady"], hist[-1]["model_tflops_per_sec"]
    per_step = {k: v / steps for k, v in launches.items() if v}
    counts: list = []
    batch = trainer._to_device(next(trainer.data_iter))
    with torch.no_grad(), drop_counter(counts):
        loss_fn(cfg, trainer.params, batch, use_kernel=True)
    dropped = 1.0 - sum(k for k, _ in counts) / sum(n for _, n in counts)
    print(f"  losses {[round(r['loss'], 4) for r in hist]}")
    print(f"  steady {steady_ms:.3f} ms/step (steps 2-{steps}), {seq / steady_ms * 1e3:.1f} tok/s, model "
          f"{tflops:.2f} TFLOP/s (3x convention), MFU {100 * tflops / PEAK_BF16_TFLOPS:.2f}% of "
          f"{PEAK_BF16_TFLOPS:.0f} TFLOP/s; peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    print(f"  dropped share of the top-{cfg.moe.top_k} assignments at CF {cf} on the next batch: "
          f"{dropped:.4f} (per layer kept/routed {counts})")
    print(f"  kernel launches per step: {per_step}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit(f"the padded-dispatch loss did not fall over {steps} steps")
    expect = {"expert_gate_up": 2 * layers, "expert_down": 2 * layers, "flash_fwd": 2 * layers,
              **{k: layers for k in ("grouped_bwd_dh", "grouped_bwd_dx", "grouped_bwd_wgrad",
                                     "flash_bwd_dq", "flash_bwd_dkv")}}
    if any(launches.get(k, 0) != n * steps for k, n in expect.items()) or launches["grouped_gate_up"]:
        raise SystemExit(f"launches per step {per_step}, expected {expect}")
    report: list = []
    named = named_leaves(trainer.params)
    with checked_kernels(report):
        loss, _ = loss_fn(cfg, trainer.params, batch, trainer.state.gen, use_kernel=True)
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    torch.cuda.synchronize()
    report_checked(report, ("expert_gemm", "flash_fwd", "grouped_bwd_dh", "grouped_bwd_dx", "grouped_bwd_wgrad",
                            "flash_bwd_dq", "flash_bwd_dkv"), "padded training")
    bad = [n for (n, _), g in zip(named, grads) if g is None or not bool(torch.isfinite(g).all())]
    if bad:
        raise SystemExit(f"parameters without a finite gradient: {bad}")
    del grads, loss, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(losses=[r["loss"] for r in hist], ms_per_step=steady_ms, tokens_per_s=seq / steady_ms * 1e3,
                          model_tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS, peak_bytes=peak,
                          dropped_share=dropped, capacity=C, launches_per_step=per_step)


# ---------------------------------------------------------------------------
# phase 8: int8 expert weights at full depth
# ---------------------------------------------------------------------------


def serve_int8_full_depth(seed: int):
    """Phase 8: llama3-e8t2 at all 32 layers and full width, expert weights
    drawn as int8 on the card from the seed (the bf16 expert tree never
    exists), sorted dispatcher, ring cache, kernels on, the 8 requests of
    phase 3: (a) every request must be answered and #10/#11 must launch;
    (b) the same weights and requests with fused dispatch: #14/#15 must
    launch and #10/#11 must not; (c) the same weights and requests through
    the paper config's own dispatcher, ``alltoall``, which on one card
    (no EP plan, strict dispatch off) falls back to the padded
    ``allgather`` at CF 4: #8/#9 must launch and #10/#11 must not."""
    import gc
    import os
    import warnings

    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls, tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  memory allocated at the start of the phase: {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    cfg = with_dispatcher(get_config("llama3-e8t2"), "sorted").replace(quant_weights="int8")
    total, _ = cfg.param_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_from_decls(model_decl(cfg), seed, "cuda", quant_weights="int8")
    torch.cuda.synchronize()
    by_dtype: dict = {}
    for t in tree_leaves(params):
        by_dtype[str(t.dtype)] = by_dtype.get(str(t.dtype), 0) + t.numel() * t.element_size()
    print(f"  {cfg.name}, {cfg.num_layers} layers (no cut), {total / 1e9:.3f} B params; drawn as int8 experts "
          f"on the card from seed {seed} in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in by_dtype.items())
          + f"; peak during the draw {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    lens, prompts, max_seq = ring_prompts(seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    launches, out_sorted, stats = counted_serve("int8 full depth", cfg, params, prompts, max_seq,
                                       ("grouped_gate_up_q8", "grouped_down_q8", "flash_fwd"),
                                       ("grouped_gemm_q8", "flash_fwd"), quant_weights="int8")
    peak = torch.cuda.max_memory_allocated()
    print(f"  [int8 full depth] peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    # (b) the same drawn weights and requests with fused dispatch (#14/#15)
    torch.cuda.reset_peak_memory_stats()
    fused = ("grouped_gate_up_fused_q8", "grouped_down_fused_q8")
    fused_launches, _, fused_stats = counted_serve(
        "int8 full depth fused", cfg, params, prompts, max_seq, fused + ("flash_fwd",), fused + ("flash_fwd",),
        quant_weights="int8", fused_dispatch=True)
    if fused_launches["grouped_gate_up_q8"] or fused_launches["grouped_down_q8"]:
        raise SystemExit(f"[int8 full depth fused] the unfused int8 kernels launched: {fused_launches}")
    fused_peak = torch.cuda.max_memory_allocated()
    print(f"  [int8 full depth fused] peak memory allocated {fused_peak} bytes ({fused_peak / 1e9:.2f} GB); "
          f"beside 8a: {fused_stats['tokens_per_s']:.2f} vs {stats['tokens_per_s']:.2f} tok/s, prefill "
          f"{fused_stats['prefill_ms']:.3f} vs {stats['prefill_ms']:.3f} ms, decode step "
          f"{fused_stats['decode_step_ms']:.3f} vs {stats['decode_step_ms']:.3f} ms, busy "
          f"{fused_stats['device_busy_share']:.3f} vs {stats['device_busy_share']:.3f}")
    # (c) the paper config's dispatcher on one card: the allgather fallback
    # at CF 4 through the padded int8 kernels #8/#9
    gc.collect()
    torch.cuda.empty_cache()
    paper = get_config("llama3-e8t2").replace(quant_weights="int8")
    padded = ("expert_gate_up_q8", "expert_down_q8", "flash_fwd")
    strict = os.environ.get("REPRO_STRICT_DISPATCH")
    os.environ["REPRO_STRICT_DISPATCH"] = "0"
    torch.cuda.reset_peak_memory_stats()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            padded_launches, out_padded, padded_stats = counted_serve(
                "int8 full depth padded", paper, params, prompts, max_seq, padded, padded, quant_weights="int8")
    finally:
        if strict is None:
            del os.environ["REPRO_STRICT_DISPATCH"]
        else:
            os.environ["REPRO_STRICT_DISPATCH"] = strict
    fallback = [str(w.message) for w in caught if "falling back to 'allgather'" in str(w.message)]
    if not fallback:
        raise SystemExit("[int8 full depth padded] the alltoall -> allgather fallback did not happen")
    if padded_launches["grouped_gate_up_q8"] or padded_launches["grouped_down_q8"]:
        raise SystemExit(f"[int8 full depth padded] the sorted int8 kernels launched: {padded_launches}")
    padded_peak = torch.cuda.max_memory_allocated()
    ntok = sum(len(v) for v in out_sorted.values())
    same = sum(a == b for r in out_sorted for a, b in zip(out_sorted[r], out_padded[r]))
    print(f"  [int8 full depth padded] dispatcher {paper.moe.dispatcher} at CF {paper.moe.capacity_factor}: "
          f"{len(fallback)} fallback warnings, the first: {fallback[0][:90]}...")
    print(f"  [int8 full depth padded] peak memory allocated {padded_peak} bytes ({padded_peak / 1e9:.2f} GB; 8a "
          f"{peak / 1e9:.2f} GB); beside 8a: {padded_stats['tokens_per_s']:.2f} vs {stats['tokens_per_s']:.2f} "
          f"tok/s, prefill {padded_stats['prefill_ms']:.3f} vs {stats['prefill_ms']:.3f} ms, decode step "
          f"{padded_stats['decode_step_ms']:.3f} vs {stats['decode_step_ms']:.3f} ms, busy "
          f"{padded_stats['device_busy_share']:.3f} vs {stats['device_busy_share']:.3f}; greedy tokens vs 8a "
          f"{same}/{ntok} positions equal (reported, not gated)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(peak_bytes=peak, weight_bytes=by_dtype, **int8_small_input_check(seed))
    stats["fused"] = dict(fused_stats, peak_bytes=fused_peak)
    stats["padded"] = dict(padded_stats, peak_bytes=padded_peak, equal_to_sorted=f"{same}/{ntok}",
                           **int8_small_input_check(seed, "allgather"))
    return launches, fused_launches, padded_launches, stats


def int8_small_input_check(seed: int, dispatcher: str = "sorted") -> dict:
    """The smoke config of llama3-e8t2 cut to one layer, int8 experts,
    through ``dispatcher`` (sorted: #10/#11; allgather at CF 4: #8/#9): the
    first-token logits through the int8 kernels must agree with their plain
    versions' within LOGIT_TOL x max|logits|; the int8 model's logits
    against the bf16 model's are reported beside INT8_LOGIT_BUDGET."""
    import numpy as np
    import torch
    from repro_torch.config import get_config, smoke_config, with_dispatcher
    from repro_torch.core.quant import INT8_LOGIT_BUDGET, quantize_params
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    cfg = with_dispatcher(smoke_config(get_config("llama3-e8t2")).replace(num_layers=1), dispatcher)
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    qparams = quantize_params(params)
    rng = np.random.default_rng(seed)
    worst, vs_bf16 = 0.0, 0.0
    lens = (12, 40, 100)
    with torch.inference_mode():
        for L in lens:
            p = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            bucket = max(16, 1 << (L - 1).bit_length())
            lk, lp, _ = prefill_three_ways(cfg, qparams, p, bucket, 128)
            lb, _, _ = prefill_three_ways(cfg, params, p, bucket, 128)
            worst = max(worst, rel_err(lk, lp)[1])
            vs_bf16 = max(vs_bf16, float((lk.float() - lb.float()).abs().max()))
    print(f"  small input (smoke config, 1 layer, int8 experts, {dispatcher}, prompts {list(lens)}): first-token "
          f"logits, int8 kernels vs their plain versions {worst:.4g} of max|logits| (tol {LOGIT_TOL}); int8 vs "
          f"bf16 model max|diff| {vs_bf16:.4g} (budget {INT8_LOGIT_BUDGET}, reported)")
    if worst > LOGIT_TOL:
        raise SystemExit(f"int8 kernel path logits ({dispatcher}) disagree with the plain versions on the small input")
    return dict(small_int8_vs_plain=worst, small_int8_vs_bf16=vs_bf16)


# ---------------------------------------------------------------------------
# phase 9: fused dispatch (gather in the gate/up prologue, combine in the
# down epilogue), kernels, serving and training
# ---------------------------------------------------------------------------


def fused_routing(gen, group_sizes, T: int, k: int = 2):
    """Top-k routing of ``T`` tokens whose expert loads are ``group_sizes``
    (each <= T, summing to T * k), with distinct experts per token and the
    tokens in a random order, and random fp32 gates in [0.2, 1); returns
    the sorted dispatcher's (token, slot, dest, gate_sorted, group_sizes)
    at row block 128."""
    import torch
    from repro_torch.config import MoEConfig
    from repro_torch.core.dispatch import SortedDispatcher

    dev = torch.device("cuda")
    E = len(group_sizes)
    assert sum(group_sizes) == T * k and max(group_sizes) <= T
    # assignment i (expert-major) goes to token i % T, slot i // T: a run of
    # <= T equal experts never lands twice on one token
    flat = torch.repeat_interleave(torch.arange(E), torch.tensor(group_sizes))
    perm = torch.randperm(T, generator=torch.Generator().manual_seed(T))
    idx = torch.empty((T, k), dtype=torch.long)
    idx[perm[torch.arange(T * k) % T], torch.arange(T * k) // T] = flat
    gates = 0.2 + 0.8 * torch.rand((T, k), generator=gen, device=dev)
    d = SortedDispatcher(None, MoEConfig(num_experts=E, top_k=k, dispatcher="sorted"))
    return d._indices(idx.to(dev), gates, 128)


def check_fused(gen, group_sizes, T: int, label: str, D=4096, F=14336, q8: bool = False):
    """Kernels #12/#13 (``q8``: #14/#15) on one routing against their plain
    versions (GG_TOL x max|plain|): h's padding rows exactly 0, and the
    partials buffer filled with NaN before the down launch comes back
    finite (every (slot, token) row written once). Then kernel, plain and
    bound times, the unfused twin kernel's time (#3/#4 or #10/#11 on the
    scattered buffer), and the whole fused path (tables, both kernels, k-way sum)
    beside the port's unfused path on the same routing (scatter into the
    aligned buffer, #3/#4 or #10/#11, gather and combine)."""
    import torch
    from repro_torch.core.dispatch import SortedDispatcher
    from repro_torch.core.dispatch.base import DispatchLayout, DispatchState
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    E = len(group_sizes)
    token, slot, dest, gate_sorted, gs = fused_routing(gen, group_sizes, T)
    N = token.shape[0]
    k = N // T
    x = torch.randn((T, D), generator=gen, device=dev).bfloat16()
    w = {n: (torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5).bfloat16()
         for n, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D)))}
    tok_pad, row_out, gate_pad, tg, tr, _ = eg.fused_tables(w["w_gate"], gs, token, dest, slot, gate_sorted, T)
    N_pad = tok_pad.shape[0]
    valid = valid_rows(gs, N_pad)
    if q8:
        (wg, sg), (wu, su), (wd, sd) = (quantize_weight(w[n]) for n in ("w_gate", "w_up", "w_down"))
        del w
        gate_up = lambda: eg.fused_gate_up_q8_cuda(x, wg, wu, sg, su, tok_pad, tg, tr)
        gate_up_plain = lambda: ref.fused_gate_up_q8_ref(x, wg, wu, sg, su, tok_pad, tg, tr)
        down = lambda h, out=None: eg.fused_down_q8_cuda(h, wd, sd, row_out, gate_pad, tg, tr, k, T, out)
        down_plain = lambda h: ref.fused_down_q8_ref(h, wd, sd, row_out, gate_pad, tg, tr, k, T)
        fused_path = lambda: eg.grouped_gemm_fused_q8_cuda(x, wg, wu, wd, sg, su, sd, gs, token, dest, slot,
                                                           gate_sorted)
        unfused_ffn = lambda xs: eg.grouped_gemm_q8_cuda(xs, wg, wu, wd, sg, su, sd, gs)
        twins = (lambda xs: eg.gate_up_q8_cuda(xs, wg, wu, sg, su, tg, tr),
                 lambda h: eg.down_q8_cuda(h, wd, sd, tg, tr))
        names, w_bytes, unfused_names = ("grouped_gate_up_fused_q8", "grouped_down_fused_q8"), 1, "#10/#11"
    else:
        wg, wu, wd = w["w_gate"], w["w_up"], w["w_down"]
        gate_up = lambda: eg.fused_gate_up_cuda(x, wg, wu, tok_pad, tg, tr)
        gate_up_plain = lambda: ref.fused_gate_up_ref(x, wg, wu, tok_pad, tg, tr)
        down = lambda h, out=None: eg.fused_down_cuda(h, wd, row_out, gate_pad, tg, tr, k, T, out)
        down_plain = lambda h: ref.fused_down_ref(h, wd, row_out, gate_pad, tg, tr, k, T)
        fused_path = lambda: eg.grouped_gemm_fused_cuda(x, wg, wu, wd, gs, token, dest, slot, gate_sorted)
        unfused_ffn = lambda xs: eg.grouped_gemm_cuda(xs, wg, wu, wd, gs)
        twins = (lambda xs: eg.gate_up_cuda(xs, wg, wu, tg, tr), lambda h: eg.down_cuda(h, wd, tg, tr))
        names, w_bytes, unfused_names = ("grouped_gate_up_fused", "grouped_down_fused"), 2, "#3/#4"
    sorted_d = SortedDispatcher(None, None)
    state = DispatchState(DispatchLayout("sorted", E, group_sizes=gs, row_block=128),
                          {"token": token, "dest": dest, "gate_sorted": gate_sorted}, {"tokens": T})

    def scatter():
        xs = x.new_zeros((N_pad, D))
        xs[dest] = x[token]
        return xs

    unfused_path = lambda: sorted_d.combine(unfused_ffn(scatter()), state)

    h = gate_up()
    h_ref = gate_up_plain()
    nan_buf = torch.full((k, T, D), float("nan"), dtype=torch.bfloat16, device=dev)
    part = down(h_ref, nan_buf)
    part_ref = down_plain(h_ref)
    y_fused, y_unfused = fused_path(), unfused_path()
    torch.cuda.synchronize()
    all_written = bool(torch.isfinite(part.float()).all())
    path_rel = rel_err(y_fused, y_unfused)[1]
    fused_ms, unfused_ms = time_ms(fused_path), time_ms(unfused_path)
    xs = scatter()
    twin_ms = (time_ms(lambda: twins[0](xs)), time_ms(lambda: twins[1](h_ref)))
    touched = sum(1 for g in group_sizes if g)
    scale_bytes = lambda n_w, n_out: touched * n_w * n_out * 2 if q8 else 0
    rows = []
    for name, twin, out, ref_out, side_ok, nbytes, flops, fn, plain in (
        (names[0], twin_ms[0], h[valid], h_ref[valid], bool((h[~valid] == 0).all()),
         # x (each token's row once), the touched experts' weights (and scales), h (all N_pad rows), tok_pad
         T * D * 2 + touched * 2 * D * F * w_bytes + scale_bytes(2, F) + N_pad * F * 2 + N_pad * 4,
         N * 4 * D * F, gate_up, gate_up_plain),
        (names[1], twin_ms[1], part, part_ref, all_written,
         # h's valid rows, the touched experts' weights (and scales), k*T partial rows, row_out and gate_pad
         N * F * 2 + touched * F * D * w_bytes + scale_bytes(1, D) + k * T * D * 2 + N_pad * 8,
         N * 2 * F * D, lambda: down(h_ref), lambda: down_plain(h_ref)),
    ):
        err, rel = rel_err(out, ref_out)
        ok = rel <= GG_TOL and side_ok and bool(torch.isfinite(out.float()).all())
        b_ms, b_by = bound(nbytes, flops)
        row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, masked_ok=side_ok, ms=time_ms(fn),
                   plain_ms=time_ms(plain, reps=3, warmup=1), bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library="none (no single call)", unfused_twin_ms=twin, fused_path_ms=fused_ms,
                   unfused_path_ms=unfused_ms,
                   shape=f"{label}: T={T} k={k} N={N} N_pad={N_pad} D={D} F={F} E={E} groups={list(group_sizes)}"
                         + (" int8 weights" if q8 else ""))
        rows.append(row)
        side = "padding rows of h zero" if name == names[0] else "every partial row written (NaN-filled before)"
        print(f"  {name} [{label}] err {err:.4g} (rel {rel:.3g}, tol {GG_TOL}) {side} {side_ok} "
              f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by}); its unfused "
              f"twin on the scattered buffer {twin:.4f} ms")
        if not ok:
            raise SystemExit(f"{name} [{label}] disagrees with its plain version")
    print(f"  fused path [{label}] (tables + {names[0]} + {names[1]} + fp32 k-way sum) {fused_ms:.4f} ms; the port's "
          f"unfused path on the same routing (scatter + {unfused_names} + gather/combine) {unfused_ms:.4f} ms; "
          f"fused vs unfused output {path_rel:.4g} of max|unfused| (reported: the two round at other points)")
    return rows


def serve_fused(seed: int, layers: int = 4):
    """Phase 9 (b): phase 3's model (llama3-e8t2, ``layers`` deep at full
    width, random bf16 weights from the seed) and its 8 requests through
    the ring engine with ``fused_dispatch=True``, kernels on: #12/#13 must
    launch and #3/#4 must not; every kernel call of a short serve is held
    against its plain version; greedy tokens against the unfused sorted
    run on the same weights are reported; then the one-layer small-input
    gates."""
    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    cfg = with_dispatcher(get_config("llama3-e8t2").replace(num_layers=layers), "sorted")
    print(f"  {cfg.name}, {layers} layers at full width, sorted dispatcher with fused dispatch, ring cache")
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    lens, prompts, max_seq = ring_prompts(seed, cfg.vocab_size)
    fused = ("grouped_gate_up_fused", "grouped_down_fused")
    launches, out, stats = counted_serve("fused ring", cfg, params, prompts, max_seq, fused + ("flash_fwd",),
                                         fused + ("flash_fwd",), fused_dispatch=True)
    if launches["grouped_gate_up"] or launches["grouped_down"]:
        raise SystemExit(f"[fused ring] the unfused grouped kernels launched: {launches}")
    _, out_unfused, wall_u = ring_serve_run(cfg, params, prompts, max_seq)
    ntok = sum(len(v) for v in out.values())
    same = sum(a == b for r in out for a, b in zip(out[r], out_unfused[r]))
    print(f"  [fused ring] greedy tokens vs the unfused sorted run on the same weights and requests: {same}/{ntok} "
          f"positions equal (reported, not gated; unfused run {ntok / wall_u:.2f} tok/s in the same process)")
    del params
    torch.cuda.empty_cache()
    return launches, {**stats, "equal_to_unfused": f"{same}/{ntok}", "unfused_tokens_per_s": ntok / wall_u,
                      **fused_small_input_check(seed)}


def fused_small_input_check(seed: int) -> dict:
    """The smoke config of llama3-e8t2 cut to one layer, sorted: the
    first-token logits through the fused kernels must agree with their
    plain versions' and with the unfused kernels' (#3/#4), each within
    LOGIT_TOL x max|logits|."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config, smoke_config, with_dispatcher
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls

    base = with_dispatcher(smoke_config(get_config("llama3-e8t2")).replace(num_layers=1), "sorted")
    cfg = base.replace(moe=dataclasses.replace(base.moe, fused_dispatch=True))
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    rng = np.random.default_rng(seed)
    worst, vs_unfused = 0.0, 0.0
    lens = (12, 40, 100)
    with torch.inference_mode():
        for L in lens:
            p = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            bucket = max(16, 1 << (L - 1).bit_length())
            lk, lp, _ = prefill_three_ways(cfg, params, p, bucket, 128)
            lu, _, _ = prefill_three_ways(base, params, p, bucket, 128)
            worst = max(worst, rel_err(lk, lp)[1])
            vs_unfused = max(vs_unfused, rel_err(lk, lu)[1])
    print(f"  small input (smoke config, 1 layer, fused dispatch, prompts {list(lens)}): first-token logits, fused "
          f"kernels vs their plain versions {worst:.4g}, fused vs unfused kernels {vs_unfused:.4g} of max|logits| "
          f"(tol {LOGIT_TOL} each)")
    if max(worst, vs_unfused) > LOGIT_TOL:
        raise SystemExit("fused-dispatch logits disagree on the small input")
    return dict(small_fused_vs_plain=worst, small_fused_vs_unfused=vs_unfused)


def train_fused(seed: int, layers: int = 2, steps: int = 8, seq: int = 2048, phase6_peak=None):
    """Phase 9 (c): phase 6's run with fused dispatch. A dense llama3-8b cut
    to ``layers`` drawn from the seed is upcycled to llama3-e8t2 (dropless
    sorted, ``fused_dispatch``), and the Trainer takes ``steps`` steps of
    1 x ``seq`` tokens with kernels and remat on. The loss must fall; per
    step #12/#13 launch 2 x layers times (forward and remat recompute), #3/#4
    ``layers`` times (the backward's recompute of ys) and #5-#7 ``layers``
    times; every kernel call of one more step, forward and backward, is
    held against its plain version; every parameter, the router included,
    gets a finite nonzero gradient; then the small-input gradient gate."""
    import dataclasses
    import gc

    import torch
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.core.upcycle import upcycle_params
    from repro_torch.data.pipeline import make_train_iter
    from repro_torch.kernels import ops
    from repro_torch.models.model import loss_fn, model_decl
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.params import init_from_decls
    from repro_torch.train.callbacks import LoggingCallback
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  memory allocated at the start of the phase: {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    base = moe_train_config(layers)
    cfg = base.replace(moe=dataclasses.replace(base.moe, fused_dispatch=True))
    dense_cfg = get_config("llama3-8b").replace(num_layers=layers)
    dev = torch.device("cuda")
    with torch.no_grad():
        params = upcycle_params(dense_cfg, cfg, init_from_decls(model_decl(dense_cfg), seed, dev), seed)
    gc.collect()
    tcfg = TrainConfig(global_batch=1, seq_len=seq, lr=3e-4, lr_min=3e-6, warmup_steps=1,
                       total_steps=steps + 2, seed=seed, log_every=1)
    state = TrainState(0, params, adamw_init(params), torch.Generator(device=dev))
    trainer = Trainer(cfg, tcfg, state=state, data_iter=make_train_iter(cfg.vocab_size, seq, 1, tcfg.blend_ratio,
                                                                        seed), use_kernel=True)
    print(f"  config {cfg.name}: {layers} layers at full width, upcycled from a dense llama3-8b drawn from seed "
          f"{seed}, dropless sorted with fused dispatch; remat {cfg.remat}; batch 1 x {seq}")
    log = LoggingCallback(log=lambda m: print("  " + m), log_every=1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer.run(steps, callbacks=[log])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    steady_ms, tflops = hist[-1]["ms_per_step_steady"], hist[-1]["model_tflops_per_sec"]
    per_step = {k: v / steps for k, v in launches.items() if v}
    print(f"  losses {[round(r['loss'], 4) for r in hist]}")
    print(f"  steady {steady_ms:.3f} ms/step (steps 2-{steps}), {seq / steady_ms * 1e3:.1f} tok/s, model "
          f"{tflops:.2f} TFLOP/s (3x convention), MFU {100 * tflops / PEAK_BF16_TFLOPS:.2f}% of "
          f"{PEAK_BF16_TFLOPS:.0f} TFLOP/s")
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB); phase 6 (unfused) in this run: "
          + (f"{phase6_peak} bytes ({phase6_peak / 1e9:.2f} GB)" if phase6_peak else "not run"))
    print(f"  kernel launches per step: {per_step}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit(f"the fused-dispatch loss did not fall over {steps} steps")
    expect = {"grouped_gate_up_fused": 2 * layers, "grouped_down_fused": 2 * layers, "flash_fwd": 2 * layers,
              **{k: layers for k in ("grouped_gate_up", "grouped_down", "grouped_bwd_dh", "grouped_bwd_dx",
                                     "grouped_bwd_wgrad", "flash_bwd_dq", "flash_bwd_dkv")}}
    if {k: v for k, v in launches.items() if v} != {k: n * steps for k, n in expect.items()}:
        raise SystemExit(f"launches per step {per_step}, expected {expect}")
    busy = profile_train_step(trainer)
    report: list = []
    named = named_leaves(trainer.params)
    batch = trainer._to_device(next(trainer.data_iter))
    with checked_kernels(report):
        loss, _ = loss_fn(cfg, trainer.params, batch, trainer.state.gen, use_kernel=True)
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    torch.cuda.synchronize()
    report_checked(report, ("grouped_gate_up_fused", "grouped_down_fused", "grouped_gemm", "flash_fwd",
                            "grouped_bwd_dh", "grouped_bwd_dx", "grouped_bwd_wgrad", "flash_bwd_dq",
                            "flash_bwd_dkv"), "fused training")
    bad = [n for (n, _), g in zip(named, grads)
           if g is None or not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0]
    routers = [n for n, _ in named if "router" in n]
    print(f"  gradients: {len(named) - len(bad)}/{len(named)} parameters with a finite, nonzero gradient "
          f"(routers {routers})")
    if bad or not routers:
        raise SystemExit(f"parameters without a gradient: {bad}")
    del grads, loss, trainer, state, params
    gc.collect()
    torch.cuda.empty_cache()
    grad_err = small_grad_check(seed, fused=True)
    return launches, dict(losses=[r["loss"] for r in hist], ms_per_step=steady_ms, tokens_per_s=seq / steady_ms * 1e3,
                          model_tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS, peak_bytes=peak,
                          launches_per_step=per_step, device_busy_share=busy, small_grad_rel_err=grad_err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9", help="comma list of phases to run")
    ap.add_argument("--digest", metavar="SRC", help="only print digests() of the port under SRC (a tree's src "
                                                      "directory) and exit: run it on two trees to compare outputs")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.digest).resolve() if args.digest else ROOT / "src"))
    if args.digest:
        print(json.dumps({"digests": digests(args.seed), "src": args.digest}))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    card = card_line()
    print(f"[1] card: {card}; {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[1] built {sorted(secs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s "
          f"(per nvcc: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {name}: {line.strip()}")

    kernels = {}
    if 2 in phases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        print("[2] kernels vs plain versions at llama3-e8t2 widths")
        # decode: 4 tokens x top-2; prefill: one 300-token prompt x top-2,
        # skewed, with an empty expert and groups that are not multiples of 128
        dec = check_grouped(gen, (3, 0, 2, 1, 0, 1, 1, 0), "decode")
        check_grouped(gen, (200, 0, 131, 77, 64, 50, 40, 38), "prefill")
        dec_q8 = check_grouped(gen, (3, 0, 2, 1, 0, 1, 1, 0), "decode", q8=True)
        check_grouped(gen, (200, 0, 131, 77, 64, 50, 40, 38), "prefill", q8=True)
        torch.cuda.empty_cache()
        # padded, CF 4: decode (4 tokens, C 4), one 300-token prompt (C 300);
        # training at CF 1 (2048 tokens, C 512)
        pad_dec = check_expert(gen, 4, "decode")
        check_expert(gen, 300, "prefill")
        check_expert(gen, 512, "train")
        check_expert(gen, 100, "partial")  # one 128-row block, 36 rows past its first 64
        torch.cuda.empty_cache()
        # the int8-weight padded kernels at the same shapes (C 4 and 300
        # end inside a 64-row block, 512 on its edge)
        pad_dec_q8 = check_expert_q8(gen, 4, "decode")
        check_expert_q8(gen, 300, "prefill")
        check_expert_q8(gen, 512, "train")
        torch.cuda.empty_cache()
        for row in dec + dec_q8 + pad_dec + pad_dec_q8:
            kernels[row["name"]] = row
        check_flash(gen, 16)
        check_flash(gen, 340)
        kernels["flash_fwd"] = check_flash(gen, 512)
        check_flash(gen, 512, window=128)
        for q8 in (False, True):
            kernels["paged_attention_q8" if q8 else "paged_attention"] = check_paged(gen, q8)
            check_paged(gen, q8, window=128)
        torch.cuda.empty_cache()

    launches, stats = {}, {}
    if 3 in phases:
        print("[3] serve llama3-e8t2 (ring cache, sorted dispatcher, kernels on)")
        launches, stats = serve(args.seed)
    if 4 in phases:
        from repro_torch.launch.serve import main as serve_main

        sorted_ = ["--dispatcher", "sorted"]
        for extra in (sorted_, sorted_ + ["--cache-mode", "paged", "--prefix-cache", "--quant-kv", "int8",
                                          "--requests", "6", "--prompt-len", "40"],
                      sorted_ + ["--quant-weights", "int8"], [], ["--quant-weights", "int8"], ["--fused-dispatch"],
                      ["--fused-dispatch", "--cache-mode", "paged", "--quant-weights", "int8"]):
            argv = ["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "4", "--use-kernel", *extra]
            print(f"[4] python -m repro_torch.launch.serve {' '.join(argv)}")
            out = serve_main(argv)
            n = 6 if "--prefix-cache" in extra else 2
            if sorted(out) != list(range(n)) or not all(len(v) == 4 for v in out.values()):
                raise SystemExit(f"serving CLI returned {out}")
    paged_launches = {}
    if 5 in phases:
        print("[5] serve llama3-e8t2 (paged KV, prefix cache, sorted dispatcher, kernels on)")
        paged_launches, stats["paged"] = serve_paged(args.seed)
        launches = {**launches, "paged_attention": paged_launches["none"]["paged_attention"],
                    "paged_attention_q8": paged_launches["int8"]["paged_attention_q8"]}

    train_launches, train_stats = {}, {}
    if 6 in phases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + 6)
        print("[6] train llama3-e8t2 (upcycled, 2 layers, kernels on): backward kernels vs plain versions")
        # 2048 tokens x top-2, skewed, an empty expert, sizes not multiples of 128
        for row in check_grouped_bwd(gen, (1100, 0, 517, 803, 64, 700, 431, 481), "train"):
            kernels[row["name"]] = row
        rows6 = check_flash_bwd(gen, 2048)
        check_flash_bwd(gen, 1024, window=256)
        check_flash_bwd(gen, 1000)  # ragged: no tile size divides it
        check_flash_bwd(gen, 512, d=64)
        check_flash_bwd(gen, 1024, KV=4)  # G 8: the widest cluster of the dk/dv reduction
        for row in rows6:
            kernels[row["name"]] = row
        torch.cuda.empty_cache()
        print("[6] train llama3-e8t2 (upcycled from a dense llama3-8b drawn from the seed)")
        train_launches, train_stats = train(args.seed)

    padded_launches, padded_stats, padded_train_launches, int8_launches, int8_fused_launches = {}, {}, {}, {}, {}
    int8_padded_launches = {}
    if 7 in phases:
        print("[7] padded dispatch (allgather): (a) ring serve of llama3-e8t2 at CF 4, kernels on")
        padded_launches, padded_stats["serve"] = serve_padded(args.seed)
        print("[7] (b) train llama3-e8t2 (2 layers) through allgather at CF 1.0, kernels on")
        padded_train_launches, padded_stats["train"] = train_padded(args.seed)
    if 8 in phases:
        print("[8] serve llama3-e8t2 at all 32 layers with int8 expert weights (ring cache, kernels on): sorted, "
              "fused (8b), the paper config's alltoall -> allgather fallback (8c)")
        int8_launches, int8_fused_launches, int8_padded_launches, stats["int8_full_depth"] = \
            serve_int8_full_depth(args.seed)
    fused_launches, fused_train_launches, fused_stats = {}, {}, {}
    if 9 in phases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + 9)
        print("[9] fused dispatch: (a) kernels #12-#15 vs plain versions at llama3-e8t2 widths")
        for q8 in (False, True):
            dec = check_fused(gen, (3, 0, 2, 1, 0, 1, 1, 0), 4, "decode", q8=q8)
            check_fused(gen, (200, 0, 131, 77, 64, 50, 40, 38), 300, "prefill", q8=q8)
            for row in dec:
                kernels[row["name"]] = row
        check_fused(gen, (1100, 0, 517, 803, 64, 700, 431, 481), 2048, "train")
        torch.cuda.empty_cache()
        print("[9] (b) ring serve of llama3-e8t2 (4 layers) with fused dispatch, kernels on")
        fused_launches, fused_stats["serve"] = serve_fused(args.seed)
        print("[9] (c) train llama3-e8t2 (upcycled, 2 layers) with fused dispatch, kernels on")
        fused_train_launches, fused_stats["train"] = train_fused(args.seed, phase6_peak=train_stats.get("peak_bytes"))

    sources = {
        "grouped_gate_up": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:335"),
        "grouped_down": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:355"),
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu", "src/repro/kernels/flash_attention.py:222"),
        "grouped_bwd_dh": ("src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu", "src/repro/kernels/expert_gemm.py:489"),
        "grouped_bwd_dx": ("src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu", "src/repro/kernels/expert_gemm.py:521"),
        "grouped_bwd_wgrad": ("src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu",
                              "src/repro/kernels/expert_gemm.py:540"),
        "flash_bwd_dq": ("src/repro_torch/kernels/csrc/flash_bwd.cu", "src/repro/kernels/flash_attention.py:286"),
        "flash_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_bwd.cu", "src/repro/kernels/flash_attention.py:306"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:126"),
        "paged_attention_q8": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:265"),
        "expert_gate_up": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:177"),
        "expert_down": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:194"),
        "expert_gate_up_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:701"),
        "expert_down_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:720"),
        "grouped_gate_up_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                               "src/repro/kernels/expert_gemm.py:827"),
        "grouped_down_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:851"),
        "grouped_gate_up_fused": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                                  "src/repro/kernels/expert_gemm.py:1088"),
        "grouped_down_fused": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                               "src/repro/kernels/expert_gemm.py:1112"),
        "grouped_gate_up_fused_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                                     "src/repro/kernels/expert_gemm.py:1251"),
        "grouped_down_fused_q8": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                                  "src/repro/kernels/expert_gemm.py:1280"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        k = kernels.get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": next((d[name] for d in (launches, train_launches, padded_launches, int8_launches,
                                                fused_launches, int8_fused_launches, int8_padded_launches)
                              if d.get(name)), 0),
            "max_abs_err": k.get("max_abs_err"),
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
            "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"), "library": k.get("library"),
            "shape": k.get("shape"),
        })
    print(json.dumps({"launches_by_path": {"ring": {k: v for k, v in launches.items()
                                                    if k in ("grouped_gate_up", "grouped_down", "flash_fwd")},
                                           **{f"paged_{q}": v for q, v in paged_launches.items()},
                                           "train": {k: v for k, v in train_launches.items() if v},
                                           **{name: {k: v for k, v in d.items() if v} for name, d in (
                                               ("padded_ring", padded_launches),
                                               ("padded_train", padded_train_launches),
                                               ("int8_full_depth", int8_launches),
                                               ("fused_ring", fused_launches),
                                               ("fused_train", fused_train_launches),
                                               ("fused_int8_full_depth", int8_fused_launches),
                                               ("padded_int8_full_depth", int8_padded_launches))}}}))
    print(json.dumps({"serve": stats}))
    print(json.dumps({"train": train_stats}))
    print(json.dumps({"padded": padded_stats}))
    print(json.dumps({"fused": fused_stats}))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
