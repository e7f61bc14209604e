"""Serving launcher: batched greedy decoding with the ServingEngine (ring
cache or page pool), on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --requests 2 --max-new 4 --dispatcher sorted --use-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --dispatcher sorted --use-kernel --cache-mode paged \\
      --prefix-cache --quant-kv int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --dispatcher sorted --use-kernel --quant-weights int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --use-kernel --fused-dispatch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --dispatcher allgather --quant-weights int8 --use-kernel --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --dispatcher sorted --use-kernel --cache-mode paged --speculate 3 \\
      --autotune --device cpu

With no ``--dispatcher`` the config's choice stands: llama3-e8t2's
``alltoall`` has no expert-parallel plan on one card, so it falls back to
``allgather`` (capacity factor 4) with a warning, or raises under
``REPRO_STRICT_DISPATCH``, as the JAX launcher does on one device; with
``--quant-weights int8 --use-kernel`` that padded path runs the int8
expert kernels #8/#9. With
``--quant-weights int8`` the expert weights are drawn straight into int8
with their scales (``init_from_decls(..., quant_weights="int8")``), so no
bf16 expert tree is ever held. ``--fused-dispatch`` (needs ``--use-kernel``,
implies ``--dispatcher sorted``) runs the sorted dispatcher's gather and
combine inside the grouped-GEMM kernels.

``--speculate K`` (paged mode) drafts K tokens a step and verifies them in
one chunk (``serving/speculative.py``). For an MoE ``--arch`` the drafter
is its dense parent and the served params are upcycled from it (the
paper's function-preserving pair); ``--draft-arch`` draws an independent
drafter from ``--seed + 1``; otherwise the model drafts for itself.
``--autotune`` sets ``REPRO_AUTOTUNE=1`` before any kernel wrapper runs, so
each expert-GEMM call site picks among its kernels' compiled tiles
(``kernels/autotune.py``).

Every decoder ``--arch`` of ``repro_torch.config.ARCH_IDS`` serves, e.g.
``--arch qwen3-moe-30b-a3b --smoke --dispatcher sorted --use-kernel
--device cpu`` (top-k capped at 2 by ``--smoke``); a vlm (llava-next-34b)
serves its text path; minicpm3-4b (MLA), mamba2-2.7b (SSM) and jamba
(hybrid, MoE) serve on the ring cache (``--cache-mode paged`` raises for
them, as in the JAX package). seamless-m4t-medium (encdec) raises
``ValueError``: the JAX engine cannot serve it either. Expert-choice
routing and noisy gating have no flag, as in the JAX launcher: they are
``MoEConfig`` fields.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.config import get_config, smoke_config
from repro_torch.models.model import model_decl
from repro_torch.params import init_from_decls, resolve_device
from repro_torch.resilience import ShedError
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.speculative import SpeculativeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dispatcher", default=None,
                    choices=["allgather", "alltoall", "a2a_overlap", "sorted"],
                    help="MoE token dispatcher (default: the config's choice; alltoall "
                         "and a2a_overlap fall back to allgather without an EP plan)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the hand-written CUDA kernels (grouped expert "
                         "GEMM, flash-attention prefill, paged-attention decode)")
    ap.add_argument("--cache-mode", default="ring", choices=["ring", "paged"],
                    help="KV cache backend: dense ring buffer or block-table page pool")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: ring-capacity parity)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per chunked-prefill step")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="evict requests older than this many engine steps "
                         "(0 = no deadlines; paged mode only)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed submits past this queue depth with a typed "
                         "ShedError (0 = unbounded)")
    ap.add_argument("--shed-watermark", type=int, default=0,
                    help="shed submits when free KV pages minus backlog dip "
                         "below this reserve (0 = off; paged mode only)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the page pool: requests "
                         "sharing a prompt stem reuse its KV pages (paged "
                         "mode only; the demo prompts share a stem so the "
                         "cache actually hits)")
    ap.add_argument("--quant-weights", default="none", choices=["none", "int8"],
                    help="int8 expert FFN weights with bf16 per-output-channel scales "
                         "(the int8 grouped kernels with --dispatcher sorted --use-kernel)")
    ap.add_argument("--quant-kv", default="none", choices=["none", "int8"],
                    help="int8 KV pages with a per-token scale sidecar "
                         "(requires --cache-mode paged)")
    ap.add_argument("--fused-dispatch", action="store_true",
                    help="dispatch-in-kernel MoE: the sorted dispatcher's gather and combine "
                         "run inside the grouped-GEMM kernels (requires --use-kernel; implies "
                         "--dispatcher sorted)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per step on a dense drafter, verify them "
                         "in one chunk (paged mode only). For an MoE --arch the drafter is its dense "
                         "parent and the served params are upcycled from it; otherwise the model "
                         "drafts for itself unless --draft-arch says otherwise")
    ap.add_argument("--draft-arch", default=None,
                    help="drafter architecture for --speculate (must share the vocab; drawn "
                         "independently from --seed + 1, so expect low acceptance)")
    ap.add_argument("--autotune", action="store_true",
                    help="tile autotuner over the kernels' compiled tiles (sets REPRO_AUTOTUNE=1; "
                         "winners persist in $XDG_CACHE_HOME/repro_torch_autotune.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.autotune:
        os.environ["REPRO_AUTOTUNE"] = "1"  # before any kernel wrapper runs
    if (args.speculate or args.prefix_cache) and args.cache_mode != "paged":
        ap.error("--speculate/--prefix-cache require --cache-mode paged")
    if args.quant_kv != "none" and args.cache_mode != "paged":
        ap.error("--quant-kv requires --cache-mode paged (the scale sidecar "
                 "lives in the page pool)")
    if args.fused_dispatch:
        if not args.use_kernel:
            ap.error("--fused-dispatch requires --use-kernel (the fusion lives in the "
                     "grouped-GEMM kernels)")
        if args.dispatcher not in (None, "sorted"):
            ap.error("--fused-dispatch requires --dispatcher sorted")
        args.dispatcher = "sorted"

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.family == "vlm":
        # the serving demo drives the text path (as the JAX launcher does);
        # an image prefix goes through prefill_forward's batch["embeds"]
        cfg = cfg.replace(num_prefix_embeds=0, family="dense")
    common = dict(
        max_batch=args.max_batch, max_seq=args.prompt_len + args.max_new + 8,
        dispatcher=args.dispatcher, use_kernel=args.use_kernel,
        cache_mode=args.cache_mode, page_size=args.page_size, num_pages=args.num_pages,
        prefill_chunk=args.prefill_chunk, deadline_steps=args.deadline_steps or None,
        max_queue=args.max_queue or None, shed_watermark=args.shed_watermark or None,
        prefix_cache=args.prefix_cache, quant_weights=args.quant_weights, quant_kv=args.quant_kv,
        fused_dispatch=args.fused_dispatch, device=device,
    )
    if args.speculate and args.draft_arch is None and cfg.moe is not None:
        # the paper's pairing: the served params upcycled from the dense
        # parent, which drafts (function-preserving init: acceptance ~1)
        dense_cfg = cfg.replace(name=f"{cfg.name}-parent", family="dense", moe=None)
        dense_params = init_from_decls(model_decl(dense_cfg), args.seed, device)
        engine = SpeculativeEngine.from_upcycle(dense_cfg, cfg, dense_params, seed=args.seed,
                                                draft_k=args.speculate, **common)
    else:
        params = init_from_decls(model_decl(cfg), args.seed, device, quant_weights=args.quant_weights)
        if not args.speculate:
            engine = ServingEngine(cfg, params, **common)
        elif args.draft_arch is not None:
            dcfg = get_config(args.draft_arch)
            if args.smoke:
                dcfg = smoke_config(dcfg)
            dparams = init_from_decls(model_decl(dcfg), args.seed + 1, device)
            engine = SpeculativeEngine(cfg, params, dcfg, dparams, draft_k=args.speculate, **common)
        else:
            engine = SpeculativeEngine(cfg, params, cfg, params, draft_k=args.speculate, **common)
    rng = np.random.default_rng(args.seed)

    def _prompt():
        return rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)

    stem = _prompt()[: args.prompt_len // 2]  # shared head for --prefix-cache
    reqs = [
        Request(rid=i,
                prompt=(np.concatenate([stem, _prompt()[len(stem):]])
                        if args.prefix_cache else _prompt()),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    accepted, shed = [], 0
    for r in reqs:
        try:
            engine.submit(r)
            accepted.append(r)
        except ShedError as e:
            shed += 1
            print(f"  SHED: {e}")
    outputs = {r.rid: r.output for r in accepted}
    steps = 0
    while steps < 10_000 and engine.has_work:
        engine.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    print(f"served {len(accepted)} requests ({shed} shed), {total_tokens} "
          f"tokens in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, "
          f"batch={args.max_batch}, cache={args.cache_mode}, device={device})")
    if args.fused_dispatch:
        print("  fused dispatch: gather and combine inside the grouped-GEMM kernels")
    if args.quant_weights != "none" or args.quant_kv != "none":
        print(f"  quant: weights={args.quant_weights}, kv={args.quant_kv} "
              f"(int8 payloads, fp32 accumulate, scales in sidecars)")
    h = engine.health()
    expired = [r.rid for r in accepted if r.status == "deadline"]
    if expired:
        print(f"  deadline-evicted requests: {expired}")
    print(f"  health: shed {h['shed_count']}, deadline evictions "
          f"{h['deadline_evictions']}, queued {h['queued_requests']}, "
          f"resident {h['resident_requests']}")
    kv = engine.kv_stats()
    print(f"  kv peak {kv['kv_bytes_peak']/1e6:.2f} MB"
          + (f", page util {kv['page_utilization']:.2f}, "
             f"peak pages {kv['peak_used_pages']}/{kv['num_pages']}"
             if args.cache_mode == "paged" else ""))
    if args.prefix_cache:
        p = kv["prefix"]
        print(f"  prefix cache: {p['hits']}/{p['lookups']} hits, "
              f"{p['hit_tokens']} prompt tokens served from cache, "
              f"{p['cow_clones']} COW clones, "
              f"{p['resident_pages']} pages resident")
    if args.speculate:
        s = kv["speculation"]
        print(f"  speculation: k={s['draft_k']}, acceptance {s['acceptance_rate']:.2%} "
              f"({s['accepted_tokens']}/{s['drafted_tokens']} drafts over {s['spec_steps']} verify steps)")
    if args.autotune:
        from repro_torch.kernels import autotune

        print(f"  autotune: {autotune.stats()} (cache {autotune.cache_path()})")
    for rid, out in sorted(outputs.items())[:4]:
        print(f"  req {rid}: {out[:12]}{'...' if len(out) > 12 else ''}")
    return outputs


if __name__ == "__main__":
    main()
