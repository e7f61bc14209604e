"""Training launcher (port of ``repro.launch.train``), on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --upcycle 4 --top-k 2 --cf -1 --dispatcher sorted --use-kernel \\
      --steps 6 --batch 2 --seq 64 --device cpu
  # a dense run that saves its params, then an upcycled run from them that
  # checkpoints every 2 steps, continued to 6 steps with --resume:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --steps 4 --save-ckpt /tmp/dense --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --upcycle 4 --top-k 2 --cf -1 --from-ckpt /tmp/dense --steps 4 \\
      --ckpt-every 2 --save-ckpt /tmp/run --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --upcycle 4 --top-k 2 --cf -1 --from-ckpt /tmp/dense --steps 6 \\
      --ckpt-every 2 --save-ckpt /tmp/run --device cpu --resume

``--smoke`` selects the reduced config; ``--upcycle N`` converts the dense
config to an N-expert MoE, from the dense params checkpoint
``--from-ckpt`` (online upcycling) or initialised fresh from ``--seed``;
the family is kept as the JAX launcher keeps it (a dense config becomes
``moe``; a vlm keeps its ``embeds`` stub, an encdec its encoder and
``frames``), and an FFN-free config (mamba2-2.7b) refuses. Every
``--arch`` trains, e.g. ``--arch jamba-1.5-large-398b --smoke`` or
``--arch seamless-m4t-medium --smoke`` (its batches carry ``frames``
(B, seq, d_model), as the JAX launcher's do).
At the default ``--cf 4.0`` it trains through the padded ``allgather``
dispatcher (capacity-factor token dropping, the paper's recipe); ``--cf
-1`` is dropless through ``sorted``.
``--quant-weights int8`` reports the held-out CE of an int8-expert copy of
the trained model beside the bf16 one. ``--fused-dispatch`` (needs
``--use-kernel``, implies ``--dispatcher sorted``) trains through the
fused dispatch-in-kernel path.

Checkpoints, as in the JAX launcher: ``--ckpt-every`` writes full
TrainState checkpoints (params, AdamW state, generator, data-stream
snapshot) into step directories of the checkpoint dir (``--save-ckpt``,
default ``/tmp/repro_ckpt``) through the async manager (``--blocking-ckpt``
turns the overlap off, ``--ckpt-keep`` sets the retention); ``--resume``
restores the latest one and continues to ``--steps`` total, before any
upcycling, so an upcycled run restarts from its MoE state (the manifest's
provenance block records the recipe). ``--save-ckpt`` also writes the
flat params checkpoint at the end. ``--supervise`` arms the anomaly
supervisor, which rolls back to the last good checkpoint after
``--rollback-after`` consecutive skipped steps. ``--autotune`` sets
``REPRO_AUTOTUNE=1`` before any kernel wrapper runs, so each forward
expert-GEMM call site picks among its kernels' compiled tiles
(``kernels/autotune.py``); the backward kernels keep their fixed tiles, as
the JAX package tunes forward call sites only.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.config import MoEConfig, TrainConfig, get_config, smoke_config
from repro_torch.core.quant import quantize_params
from repro_torch.data.pipeline import make_train_iter, stub_inputs
from repro_torch.train.callbacks import AnomalySupervisor, CheckpointCallback, LoggingCallback
from repro_torch.train.trainer import Trainer


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--upcycle", type=int, default=0, help="num experts")
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--cf", type=float, default=4.0, help="<=0 => dropless")
    ap.add_argument("--router", default="mixtral", choices=["mixtral", "st"])
    ap.add_argument("--dispatcher", default=None, choices=["allgather", "alltoall", "sorted"],
                    help="MoE token dispatcher (default: sorted when dropless, else allgather)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the hand-written CUDA kernels forward and backward")
    ap.add_argument("--fused-dispatch", action="store_true",
                    help="sorted dispatcher with the gather and combine inside the grouped-GEMM "
                         "kernels (requires --use-kernel; implies --dispatcher sorted)")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="per-step wall-clock watchdog in seconds (0 = off); a slower step raises HangError")
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--from-ckpt", default=None, help="dense params checkpoint to upcycle (with --upcycle)")
    ap.add_argument("--save-ckpt", default=None,
                    help="checkpoint dir: full-state step checkpoints, and the flat params checkpoint at the end")
    ap.add_argument("--ckpt-every", type=int, default=0, help="full-state checkpoint period (0 = off)")
    ap.add_argument("--ckpt-keep", type=int, default=3, help="keep-last-k retention for full-state checkpoints")
    ap.add_argument("--blocking-ckpt", action="store_true", help="disable the async double-buffered save path")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest full-state checkpoint from the checkpoint dir and continue to --steps")
    ap.add_argument("--supervise", action="store_true",
                    help="arm the anomaly supervisor: skip NaN/spike steps, roll back to the last good checkpoint "
                         "after --rollback-after consecutive bad steps")
    ap.add_argument("--rollback-after", type=int, default=3, help="consecutive anomalous steps before rollback")
    ap.add_argument("--autotune", action="store_true",
                    help="tile autotuner over the kernels' compiled tiles (sets REPRO_AUTOTUNE=1; winners "
                         "persist in $XDG_CACHE_HOME/repro_torch_autotune.json)")
    ap.add_argument("--quant-weights", default="none", choices=["none", "int8"],
                    help="after training, report the held-out CE with int8 expert weights")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.autotune:
        os.environ["REPRO_AUTOTUNE"] = "1"  # before any kernel wrapper runs
    if args.fused_dispatch:
        if not args.use_kernel:
            raise SystemExit("--fused-dispatch requires --use-kernel (the fusion lives in the grouped-GEMM kernels)")
        if args.dispatcher not in (None, "sorted"):
            raise SystemExit("--fused-dispatch requires --dispatcher sorted")
        args.dispatcher = "sorted"
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    ckpt_dir = args.save_ckpt or "/tmp/repro_ckpt"
    provenance, dense_cfg = {}, None
    if args.upcycle:
        from repro_torch.core.upcycle import upcycle_config

        cf = args.cf if args.cf > 0 else None
        moe = MoEConfig(num_experts=args.upcycle, top_k=args.top_k, capacity_factor=cf,
                        router_type=args.router,
                        dispatcher=args.dispatcher or ("sorted" if cf is None else "allgather"),
                        fused_dispatch=args.fused_dispatch)
        dense_cfg, cfg = cfg, upcycle_config(cfg, moe)
    tcfg = TrainConfig(
        global_batch=args.batch, seq_len=args.seq, lr=args.lr, lr_min=args.lr / 100,
        warmup_steps=min(100, args.steps // 10 + 1), total_steps=args.steps, seed=args.seed,
        ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
    )

    # resume first: an upcycled run restarts from its latest MoE TrainState,
    # not by upcycling the dense source again
    state, data_state = None, None
    if args.resume:
        from repro_torch.checkpoint.manager import latest_step
        from repro_torch.train.state import restore_train_state

        latest = latest_step(ckpt_dir)
        if latest is not None:
            state, manifest = restore_train_state(ckpt_dir, cfg, device=args.device)
            data_state = manifest["meta"].get("data_state")
            provenance = manifest["meta"].get("provenance", {})
            print(f"resumed step {state.step} from {ckpt_dir}" + (" (upcycled run)" if provenance.get("upcycled") else ""))
        else:
            print(f"--resume: no full-state checkpoint under {ckpt_dir}; starting fresh")
    params = None
    if state is None and args.upcycle and args.from_ckpt:
        from repro_torch.checkpoint.ckpt import upcycle_on_load
        from repro_torch.core.upcycle import upcycle_provenance

        params, _ = upcycle_on_load(args.from_ckpt, dense_cfg, cfg, seed=args.seed, device=args.device)
        provenance = upcycle_provenance(dense_cfg, cfg, args.from_ckpt)
        print(f"upcycled {dense_cfg.name} -> {cfg.name} from {args.from_ckpt}")

    it = make_train_iter(cfg.vocab_size, args.seq, args.batch, tcfg.blend_ratio, args.seed,
                         stub_inputs(cfg, args.batch, args.seq))
    if data_state is not None:
        it.restore(data_state)
    t, a = cfg.param_counts()
    print(f"training {cfg.name}: {t/1e6:.1f}M total / {a/1e6:.1f}M active params")
    callbacks = [LoggingCallback(log_every=tcfg.log_every)]
    ckpt_cb = None
    if args.ckpt_every:
        ckpt_cb = CheckpointCallback(
            ckpt_dir, every=args.ckpt_every, keep_last=args.ckpt_keep, async_save=not args.blocking_ckpt,
            extra_meta={"arch": args.arch, "seed": args.seed, **({"provenance": provenance} if provenance else {})},
        )
        callbacks.append(ckpt_cb)
    if args.supervise:
        # after the checkpoint callback: a rollback joins the in-flight write first
        callbacks.append(AnomalySupervisor(ckpt=ckpt_cb, rollback_after=args.rollback_after))
    tr = Trainer(cfg, tcfg, params=params, state=state, data_iter=it, use_kernel=args.use_kernel,
                 dispatcher=args.dispatcher, callbacks=callbacks, step_timeout_s=args.step_timeout or None,
                 device=args.device)
    remaining = max(0, args.steps - tr.state.step)
    if remaining:
        tr.run(remaining)
    else:
        print(f"checkpoint already at step {tr.state.step} >= --steps {args.steps}; nothing to run")
    if args.save_ckpt:
        from repro_torch.checkpoint.ckpt import save_checkpoint

        save_checkpoint(args.save_ckpt, tr.params, step=args.steps)
        print(f"saved checkpoint to {args.save_ckpt}")
    ce = tr.eval_loss(batches=4)
    print(f"final held-out CE: {ce:.4f}")
    if args.quant_weights == "int8":
        if cfg.moe is None:
            print("--quant-weights int8: dense config has no expert FFNs; nothing to quantize")
        else:
            # serving-style check: evaluate a quantised copy of the experts;
            # the TrainState keeps its bf16 params
            trained = tr.state.params
            tr.state.params = quantize_params(trained)
            qce = tr.eval_loss(batches=4)
            tr.state.params = trained
            print(f"int8-expert held-out CE: {qce:.4f} (delta {qce - ce:+.4f} vs bf16)")
    if args.autotune:
        from repro_torch.kernels import autotune

        print(f"autotune: {autotune.stats()} (cache {autotune.cache_path()})")
    return tr


if __name__ == "__main__":
    main()
