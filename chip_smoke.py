#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py            # all phases, one card

Phases (each failure exits non-zero; nothing is swallowed):

1. card and build — prints the card's name and power limit, builds every
   CUDA kernel of the serving path from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel) and prints the
   build seconds and each kernel's registers / shared memory / spills;
2. kernels vs plain versions — calls each kernel's wrapper on the card at
   the llama3-e8t2 shapes the serving path gives it and holds the result
   against its plain PyTorch version (``kernels/ref.py``):
   bf16 outputs within 2e-2 x max|plain|, the flash lse within 1e-3; prints
   kernel, plain and library times (CUDA events) beside the bound;
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
4. the serving CLI, in process (smoke config, kernels on).

The last two lines are the card's ``nvidia-smi`` name and power limit and
the result JSON; the line before them lists the kernels. Imports nothing of
JAX or of the JAX package.
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
GG_TOL, FA_TOL, LSE_TOL, LOGIT_TOL = 2e-2, 2e-2, 1e-3, 2e-2


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
    err = float((out.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# phase 2: grouped GEMM kernels
# ---------------------------------------------------------------------------


def check_grouped(gen, group_sizes, label: str, D=4096, F=14336):
    import torch
    from repro_torch.core.dispatch import aligned_rows
    from repro_torch.kernels import expert_gemm as eg
    from repro_torch.kernels.ref import grouped_down_ref, grouped_gate_up_ref

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

    h = eg.gate_up_cuda(xs, w["w_gate"], w["w_up"], tg, tr)
    h_ref = grouped_gate_up_ref(xs, w["w_gate"], w["w_up"], gs, eg.ROW_TILE)
    y = eg.down_cuda(h_ref, w["w_down"], tg, tr)
    y_ref = grouped_down_ref(h_ref, w["w_down"], gs, eg.ROW_TILE)
    torch.cuda.synchronize()
    rows = []
    touched = sum(1 for g in gs_host if g)
    for name, out, ref, k_in, n_out, flops_per_row, fn, plain in (
        ("grouped_gate_up", h, h_ref, D, F, 4 * D * F,
         lambda: eg.gate_up_cuda(xs, w["w_gate"], w["w_up"], tg, tr),
         lambda: grouped_gate_up_ref(xs, w["w_gate"], w["w_up"], gs, eg.ROW_TILE)),
        ("grouped_down", y, y_ref, F, D, 2 * F * D,
         lambda: eg.down_cuda(h_ref, w["w_down"], tg, tr),
         lambda: grouped_down_ref(h_ref, w["w_down"], gs, eg.ROW_TILE)),
    ):
        err, rel = rel_err(out[valid], ref[valid])
        pad_zero = bool((out[~valid] == 0).all())
        ok = rel <= GG_TOL and pad_zero and bool(torch.isfinite(out.float()).all())
        n_w = 2 if name == "grouped_gate_up" else 1
        nbytes = N * k_in * 2 + touched * n_w * k_in * n_out * 2 + N_pad * n_out * 2
        b_ms, b_by = bound(nbytes, N * flops_per_row)
        row = dict(name=name, max_abs_err=err, rel_err=rel, ok=ok, pad_rows_zero=pad_zero,
                   ms=time_ms(fn), plain_ms=time_ms(plain, reps=3, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   shape=f"{label}: N={N} N_pad={N_pad} D={D} F={F} E={E} groups={gs_host}")
        if name == "grouped_down":
            row["library_ms"] = grouped_mm_ms(h_ref[valid].contiguous(), w["w_down"], gs)
        rows.append(row)
        print(f"  {name} [{label}] err {err:.4g} (rel {rel:.3g}, tol {GG_TOL}) pad-zero {pad_zero} "
              f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"library {row['library_ms']} ms bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise SystemExit(f"{name} [{label}] disagrees with its plain version")
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
# phase 3: serve
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the model's two kernel call sites (``ops.grouped_gemm``,
    ``ops.flash_attention``) to the kernels' plain versions for the block:
    the same path and arithmetic as the kernel run, without the kernels."""
    from repro_torch.kernels import ops, ref

    saved = ops.grouped_gemm, ops.flash_attention
    ops.grouped_gemm = ref.grouped_gemm_ref
    ops.flash_attention = lambda q, k, v, causal=True, window=None, scale=None: ref.flash_attention_ref(
        q, k, v, causal, window, scale)
    try:
        yield
    finally:
        ops.grouped_gemm, ops.flash_attention = saved


@contextlib.contextmanager
def checked_kernels(report: list):
    """Inside the block every kernel call of the model also runs its plain
    version on the same inputs and appends (kernel, input shape, max|diff| /
    max|plain|) to ``report``; the kernel's output is what the model uses."""
    from repro_torch.kernels import ops, ref

    gg, fa = ops.grouped_gemm, ops.flash_attention

    def grouped(xs, w_gate, w_up, w_down, group_sizes, row_block=128):
        y = gg(xs, w_gate, w_up, w_down, group_sizes, row_block)
        r = ref.grouped_gemm_ref(xs, w_gate, w_up, w_down, group_sizes, row_block)
        report.append(("grouped_gemm", tuple(xs.shape), rel_err(y, r)[1]))
        return y

    def flash(q, k, v, causal=True, window=None, scale=None):
        y = fa(q, k, v, causal, window, scale)
        report.append(("flash_fwd", tuple(q.shape), rel_err(y, ref.flash_attention_ref(q, k, v, causal, window, scale))[1]))
        return y

    ops.grouped_gemm, ops.flash_attention = grouped, flash
    try:
        yield
    finally:
        ops.grouped_gemm, ops.flash_attention = gg, fa


def serve(seed: int, layers: int = 4, requests: int = 8, max_new: int = 32, max_batch: int = 4):
    import numpy as np
    import torch
    from repro_torch.config import get_config, with_dispatcher
    from repro_torch.kernels import ops
    from repro_torch.models.model import model_decl
    from repro_torch.params import init_from_decls
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = with_dispatcher(get_config("llama3-e8t2").replace(num_layers=layers), "sorted")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"d_ff {cfg.d_ff}, experts {cfg.moe.num_experts} top-{cfg.moe.top_k}, vocab {cfg.vocab_size} "
          f"(padded {cfg.padded_vocab}); cut: num_layers 32 -> {layers}")
    t0 = time.perf_counter()
    params = init_from_decls(model_decl(cfg), seed, "cuda")
    torch.cuda.synchronize()
    print(f"  weights drawn on the card from seed {seed} in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 301, size=requests)
    lens[0] = 300  # the longest prompt sets max_seq, so its bucket is the ragged cap
    prompts = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32) for L in lens]
    max_seq = int(lens.max()) + max_new + 8  # as launch/serve.py sets it

    def run(use_kernel: bool, which=None, new=max_new):
        eng = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                            use_kernel=use_kernel, device="cuda")
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=new)
                for i in (which if which is not None else range(len(prompts)))]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t

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
    if not all(n > 0 for n in launches.values()):
        raise SystemExit(f"a kernel of the serving path was never launched: {launches}")

    # every kernel call of a prefill (at the 340 and 32 buckets) and of the
    # decode steps, held against its plain version on the same inputs
    report: list = []
    with checked_kernels(report):
        run(True, [0, 5], 3)
    for name in ("grouped_gemm", "flash_fwd"):
        calls = [r for r in report if r[0] == name]
        w = max(r[2] for r in calls)
        print(f"  in the serving path: {len(calls)} {name} calls vs their plain versions on the same "
              f"inputs, worst max|diff|/max|plain| {w:.4g} (tol {GG_TOL}); shapes "
              f"{sorted({r[1] for r in calls})}")
        if w > GG_TOL:
            raise SystemExit(f"{name} disagrees with its plain version inside the serving path")

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


def profile_window(run) -> None:
    """torch.profiler over a short serve (prompts 0 and 5, 8 new tokens):
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = run(True, [0, 5], 8)
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"  profile (2 requests, 8 new tokens): wall {1e3 * wall:.3f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} calls  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="1,2,3,4", help="comma list of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
        for row in dec:
            kernels[row["name"]] = row
        check_flash(gen, 16)
        check_flash(gen, 340)
        kernels["flash_fwd"] = check_flash(gen, 512)
        check_flash(gen, 512, window=128)
        torch.cuda.empty_cache()

    launches, stats = {}, {}
    if 3 in phases:
        print("[3] serve llama3-e8t2 (ring cache, sorted dispatcher, kernels on)")
        launches, stats = serve(args.seed)
    if 4 in phases:
        print("[4] python -m repro_torch.launch.serve --arch llama3-e8t2 --smoke --requests 2 "
              "--max-new 4 --dispatcher sorted --use-kernel")
        from repro_torch.launch.serve import main as serve_main

        out = serve_main(["--arch", "llama3-e8t2", "--smoke", "--requests", "2", "--max-new", "4",
                          "--dispatcher", "sorted", "--use-kernel"])
        if sorted(out) != [0, 1] or not all(len(v) == 4 for v in out.values()):
            raise SystemExit(f"serving CLI returned {out}")

    sources = {
        "grouped_gate_up": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:335"),
        "grouped_down": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/expert_gemm.py:355"),
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu", "src/repro/kernels/flash_attention.py:222"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        k = kernels.get(name, {})
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name), "max_abs_err": k.get("max_abs_err"),
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
            "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"), "shape": k.get("shape"),
        })
    print(json.dumps({"serve": stats}))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
