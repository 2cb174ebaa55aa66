"""Training launcher (the port of ``repro/launch/train.py``).

One process, one device: builds the model (random parameters from seed 0),
AdamW and the train step, resumes from the newest checkpoint under
``--ckpt`` when there is one, and runs the deterministic data stream
(``training.data.make_batch``) from that step, printing the reference's
step lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --steps 20 --batch 8 --seq 128

Every ``--arch`` trains: dense, MoE, hymba, xlstm and whisper, whose
batches carry the stubbed frontend's ``enc_embeds`` (llava's ``embeds``);
those float inputs are cast to the model's dtype.  ``--device`` defaults
to the card (``cuda``); ``--device cpu`` runs on the CPU.  ``--dp``,
``--tp``, ``--pods`` and ``--devices`` exist for the reference's command
lines; anything but one device raises, as multi-rank training (a device
mesh over ``torch.distributed``) is later work.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments", default="float32")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    for flag in ("dp", "tp", "pods", "devices"):
        if getattr(args, flag) != 1:
            raise SystemExit(
                f"--{flag} {getattr(args, flag)}: the port trains on one "
                f"device; multi-rank training (a device mesh over "
                f"torch.distributed) is later work")

    import torch
    from ..configs import get_config
    from ..core.device import resolve_device
    from ..training.checkpoint import CheckpointManager
    from ..training.data import make_batch
    from ..training.optimizer import OptConfig
    from ..models.config import torch_dtype
    from ..training.train_loop import (TrainConfig, TrainState, batch_to,
                                       make_train_step)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_config()
    cfg = cfg.scaled(dtype="float32" if args.smoke else cfg.dtype,
                     remat="block")
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"devices=1", flush=True)

    ocfg = OptConfig(moments_dtype=args.moments, warmup_steps=10,
                     decay_steps=max(args.steps, 100))
    tcfg = TrainConfig(microbatches=args.microbatches)
    st = TrainState.create(cfg, ocfg,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    step_fn = make_train_step(cfg, ocfg, tcfg, donate=True)

    mgr = CheckpointManager(args.ckpt, every=args.ckpt_every) if args.ckpt \
        else None
    start = 0
    if mgr:
        s, tree, extra = mgr.restore_latest(
            {"params": st.params, "opt": st.opt_state})
        if s is not None:
            st.params, st.opt_state = tree["params"], tree["opt"]
            start = int(extra["step"])
            print(f"resumed at step {start}", flush=True)

    dt = torch_dtype(cfg.dtype)
    t0 = time.time()
    for i in range(start, args.steps):
        b = batch_to(make_batch(cfg, args.batch, args.seq, step=i), dev,
                     dt)
        st.params, st.opt_state, m = step_fn(st.params, st.opt_state, b)
        if mgr:
            mgr.maybe_save(i + 1, {"params": st.params, "opt": st.opt_state},
                           extra={"step": i + 1})
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)", flush=True)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
