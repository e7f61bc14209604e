"""Training launcher (port of ``repro.launch.train``), on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --upcycle 4 --top-k 2 --cf -1 --dispatcher sorted --use-kernel \\
      --steps 6 --batch 2 --seq 64 --device cpu

``--smoke`` selects the reduced config; ``--upcycle N`` converts the dense
config to an N-expert MoE, initialised fresh from ``--seed`` (as the JAX
launcher does without ``--from-ckpt``). At the default ``--cf 4.0`` it
trains through the padded ``allgather`` dispatcher (capacity-factor token
dropping, the paper's recipe); ``--cf -1`` is dropless through ``sorted``.
``--quant-weights int8`` reports the held-out CE of an int8-expert copy of
the trained model beside the bf16 one. ``--fused-dispatch`` (needs
``--use-kernel``, implies ``--dispatcher sorted``) trains through the
fused dispatch-in-kernel path. Flags of the JAX launcher whose
subsystems are not ported yet raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse

from repro_torch.config import MoEConfig, TrainConfig, get_config, smoke_config
from repro_torch.core.quant import quantize_params
from repro_torch.data.pipeline import make_train_iter
from repro_torch.train.callbacks import LoggingCallback
from repro_torch.train.trainer import Trainer

_CKPT = "ROADMAP queue 1 item 7, checkpointing"
# flag -> (value that means "not asked for", the ROADMAP item that ports it)
_NOT_PORTED = {
    "from_ckpt": (None, _CKPT),
    "save_ckpt": (None, _CKPT),
    "ckpt_every": (0, _CKPT),
    "ckpt_keep": (3, _CKPT),
    "blocking_ckpt": (False, _CKPT),
    "resume": (False, _CKPT),
    "supervise": (False, _CKPT + " (the supervisor's rollback)"),
    "rollback_after": (3, _CKPT + " (the supervisor's rollback)"),
    "autotune": (False, "none: the CUDA kernels have fixed tiles"),
}


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
    # flags of the JAX launcher whose subsystems are not ported yet
    ap.add_argument("--from-ckpt", default=None)
    ap.add_argument("--save-ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--blocking-ckpt", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--rollback-after", type=int, default=3)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--quant-weights", default="none", choices=["none", "int8"],
                    help="after training, report the held-out CE with int8 expert weights")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(f"--{name.replace('_', '-')} is not ported yet ({item})")
    if args.fused_dispatch:
        if not args.use_kernel:
            raise SystemExit("--fused-dispatch requires --use-kernel (the fusion lives in the grouped-GEMM kernels)")
        if args.dispatcher not in (None, "sorted"):
            raise SystemExit("--fused-dispatch requires --dispatcher sorted")
        args.dispatcher = "sorted"
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.upcycle:
        from repro_torch.core.upcycle import upcycle_config

        cf = args.cf if args.cf > 0 else None
        moe = MoEConfig(num_experts=args.upcycle, top_k=args.top_k, capacity_factor=cf,
                        router_type=args.router,
                        dispatcher=args.dispatcher or ("sorted" if cf is None else "allgather"),
                        fused_dispatch=args.fused_dispatch)
        cfg = upcycle_config(cfg, moe)
    tcfg = TrainConfig(
        global_batch=args.batch, seq_len=args.seq, lr=args.lr, lr_min=args.lr / 100,
        warmup_steps=min(100, args.steps // 10 + 1), total_steps=args.steps, seed=args.seed,
    )
    it = make_train_iter(cfg.vocab_size, args.seq, args.batch, tcfg.blend_ratio, args.seed)
    t, a = cfg.param_counts()
    print(f"training {cfg.name}: {t/1e6:.1f}M total / {a/1e6:.1f}M active params")
    tr = Trainer(cfg, tcfg, data_iter=it, use_kernel=args.use_kernel, dispatcher=args.dispatcher,
                 step_timeout_s=args.step_timeout or None, device=args.device)
    tr.run(args.steps, callbacks=[LoggingCallback(log_every=tcfg.log_every)])
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
    return tr


if __name__ == "__main__":
    main()
