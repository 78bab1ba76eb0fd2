"""Training entry point (counterpart of ``repro/launch/train.py``): config →
random base weights → DoRA adapter init → synthetic data pipeline with
prefetch → AdamW over the adapters → checkpoint/auto-resume → preemption
and heartbeat hooks.

Runs on the card unless the CPU is asked for explicitly::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --steps 3 --batch 2 --seq 2048 --rank 384 --alpha 192 \\
        --loss-tokens 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-7b \\
        --steps 3 --batch 2 --seq 2048 --rank 384 --alpha 192 \\
        --loss-tokens 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
        --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --steps 3 --batch 2 --seq 2048 --rank 384 --alpha 192 \\
        --loss-tokens 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
        --smoke --device cpu --steps 2

The flags, the schedule and the log lines are the reference's, plus
``--device``. Weights are random, drawn from ``--seed`` on the training
device; batches are the reference pipeline's for ``--data-seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import (CheckpointConfig, Heartbeat,
                                    PreemptionHandler, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.config import DoRAConfig
from repro_torch.data import DataConfig, make_train_iterator, prefetch
from repro_torch.launch import serve
from repro_torch.launch.steps import StepConfig, make_train_step
from repro_torch.optim import OptimizerConfig, adamw_init


def build_state(mcfg, dcfg: DoRAConfig, seed: int = 0, device=None):
    """Random params, DoRA-initialized adapters and zero AdamW state, on
    ``device``: the card when it is None (``"cpu"`` must be asked for)."""
    params, adapters = serve.build_state(mcfg, dcfg, seed,
                                         serve.resolve_device(device))
    return params, adapters, adamw_init(adapters)


def train(args) -> dict:
    dev = serve.resolve_device(args.device)
    mcfg = get_config(args.arch, smoke=args.smoke)
    dcfg = DoRAConfig(rank=args.rank, alpha=args.alpha,
                      mode=args.dora_mode, norm_impl=args.norm_impl)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                           total_steps=args.steps,
                           clip_norm=args.clip_norm)
    scfg = StepConfig(dora=dcfg, optim=ocfg, loss_tokens=args.loss_tokens,
                      grad_accum=args.grad_accum)

    params, adapters, opt_state = build_state(mcfg, dcfg, args.seed, dev)

    ckpt = CheckpointConfig(args.ckpt_dir, every_steps=args.ckpt_every,
                            keep=args.ckpt_keep)
    start_step = 0
    if args.resume:
        restored, step = restore_checkpoint(
            ckpt, {"adapters": adapters, "opt": opt_state})
        if restored is not None:
            adapters, opt_state = restored["adapters"], restored["opt"]
            start_step = step
            print(f"resumed from step {start_step}")

    dcfg_data = DataConfig(vocab_size=mcfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.data_seed)
    it = prefetch(make_train_iterator(dcfg_data, start_step=start_step),
                  depth=2)
    step_fn = make_train_step(mcfg, scfg, batch=args.batch, seq=args.seq)

    hb = Heartbeat(args.heartbeat_dir, 0) if args.heartbeat_dir else None
    losses = []
    t_start = time.monotonic()
    with PreemptionHandler() as pre:
        for step in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(it).items()}
            adapters, opt_state, metrics = step_fn(
                params, adapters, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if hb:
                hb.beat(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            want_ckpt = ((step + 1) % args.ckpt_every == 0
                         or step == args.steps - 1)
            if pre.preempted:
                print(f"preemption signal at step {step}: saving + exiting")
                want_ckpt = True
            if want_ckpt and args.ckpt_dir:
                save_checkpoint(ckpt, step + 1,
                                {"adapters": adapters, "opt": opt_state},
                                mesh_meta={"model": 1})
            if pre.preempted:
                break
    dt = time.monotonic() - t_start
    steps_done = len(losses)
    print(f"done: {steps_done} steps in {dt:.1f}s "
          f"({dt / max(steps_done, 1):.2f} s/step); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": steps_done, "wall_s": dt}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=32.0)
    ap.add_argument("--dora-mode", default="auto",
                    choices=["auto", "eager", "fused"])
    ap.add_argument("--norm-impl", default="factored",
                    choices=["factored", "dense_ba", "peft_eye"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--loss-tokens", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=1234)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--heartbeat-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    train(ap.parse_args(argv))


if __name__ == "__main__":
    main()
