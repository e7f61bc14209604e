"""Serving launcher: batched greedy decoding with the ring-cache
ServingEngine, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-e8t2 \\
      --smoke --requests 2 --max-new 4 --dispatcher sorted --use-kernel
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_config, smoke_config
from repro_torch.models.model import model_decl
from repro_torch.params import init_from_decls, resolve_device
from repro_torch.resilience import ShedError
from repro_torch.serving.engine import Request, ServingEngine


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
                    help="MoE token dispatcher (only 'sorted' is ported so far)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the hand-written CUDA kernels (grouped expert "
                         "GEMM, flash-attention prefill)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed submits past this queue depth with a typed "
                         "ShedError (0 = unbounded)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_from_decls(model_decl(cfg), args.seed, device)
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch,
        max_seq=args.prompt_len + args.max_new + 8,
        dispatcher=args.dispatcher, use_kernel=args.use_kernel,
        max_queue=args.max_queue or None, device=device,
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
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
          f"batch={args.max_batch}, cache=ring, device={device})")
    h = engine.health()
    print(f"  health: shed {h['shed_count']}, deadline evictions "
          f"{h['deadline_evictions']}, queued {h['queued_requests']}, "
          f"resident {h['resident_requests']}")
    print(f"  kv peak {engine.kv_stats()['kv_bytes_peak']/1e6:.2f} MB")
    for rid, out in sorted(outputs.items())[:4]:
        print(f"  req {rid}: {out[:12]}{'...' if len(out) > 12 else ''}")
    return outputs


if __name__ == "__main__":
    main()
