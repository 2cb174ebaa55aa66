"""Training launcher (the port of ``repro/launch/train.py``).

Builds the model (random parameters from seed 0), AdamW and the train
step, resumes from the newest checkpoint under ``--ckpt`` when there is
one, and runs the deterministic data stream (``training.data.make_batch``)
from that step, printing the reference's step lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --steps 20 --batch 8 --seq 128

On a device mesh, one process a rank under ``torchrun``:

  PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \\
      -m repro_torch.launch.train --dp 2 --tp 2 --device cpu --smoke

``--dp`` / ``--tp`` (and ``--pods``) shape a (data, model) (or (pod, data,
model)) mesh over the world that ``torchrun`` gives (NCCL on the card,
gloo on the CPU); a product other than the world size raises.  The
parameters are made whole from the seed on every rank, then placed by the
spec rules (``param_specs`` / ``shardings``: FSDP / ZeRO-3 over ``data``,
tensor parallel over ``model``) and the optimizer state by ``_opt_specs``;
the step runs on DTensors (``make_train_step(param_shardings=)``), and
checkpoints save whole leaves and restore into the mesh's layout, so a run
resumes at another mesh shape.  Every ``--arch`` trains on a mesh (MoE
with its experts over ``model``; hymba's scan and xlstm's cells on each
rank's batch rows and heads: ``models.meshed``).  Without ``torchrun``
and with all three at 1 it is the one-device path.  Either way whisper's
batches carry the stubbed frontend's ``enc_embeds`` and llava's
``embeds``; float inputs are cast to the model's dtype.  ``--device`` defaults to the card
(``cuda``); ``--device cpu`` runs on the CPU.  ``--devices`` exists for
the reference's command lines (virtual host devices); anything but 1
raises: ranks come from ``torchrun``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def sharded_state(cfg, ocfg, mesh, dev, generator=None):
    """(params, opt_state, param shardings, opt shardings) on ``mesh``:
    each parameter leaf made whole from the seeded generator (seed 0
    without one), then placed; the moments in the parameters' layout."""
    import torch
    from ..models import transformer as T
    from ..models.sharding import param_specs, place, shardings
    from ..training.optimizer import init_opt_state
    from .cells import _opt_specs
    from .mesh import mesh_sizes
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=gen, device=dev)
    pspecs = param_specs(params, cfg, mesh_sizes(mesh))
    psh = shardings(mesh, pspecs)
    osh = shardings(mesh, _opt_specs(pspecs, ocfg.moments_dtype))
    params = place(params, psh)
    opt = place(init_opt_state(params, ocfg), osh)
    return params, opt, psh, osh


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
    if args.devices != 1:
        raise SystemExit(f"--devices {args.devices}: the port's ranks are "
                         f"processes; launch them with torchrun "
                         f"(python -m torch.distributed.run)")

    import torch
    import torch.distributed as dist
    from ..configs import get_config
    from ..core.device import resolve_device
    from ..models.config import torch_dtype
    from ..training.checkpoint import CheckpointManager
    from ..training.data import make_batch
    from ..training.optimizer import OptConfig
    from ..training.train_loop import (TrainConfig, TrainState, batch_to,
                                       make_train_step)
    from .mesh import make_mesh

    if args.pods > 1:
        shape, axes = (args.pods, args.dp, args.tp), ("pod", "data", "model")
    else:
        shape, axes = (args.dp, args.tp), ("data", "model")
    n, world = 1, int(os.environ.get("WORLD_SIZE", "1"))
    for s in shape:
        n *= s
    if n != world:
        raise SystemExit(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks and the "
            f"world has {world}: launch one process a rank with torchrun "
            f"(python -m torch.distributed.run --nproc_per_node {n} -m "
            f"repro_torch.launch.train ...)")
    on_mesh = "WORLD_SIZE" in os.environ
    dev = torch.device(args.device)
    owned = False
    if on_mesh:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            owned = True
    dev = resolve_device(dev)
    rank0 = not on_mesh or dist.get_rank() == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_config()
    cfg = cfg.scaled(dtype="float32" if args.smoke else cfg.dtype,
                     remat="block")
    ocfg = OptConfig(moments_dtype=args.moments, warmup_steps=10,
                     decay_steps=max(args.steps, 100))
    tcfg = TrainConfig(microbatches=args.microbatches)
    try:
        if on_mesh:
            mesh = make_mesh(shape, axes, device_type=dev.type)
            say(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
                f"devices={dist.get_world_size()} mesh="
                f"{'x'.join(map(str, shape))}")
            params, opt, psh, osh = sharded_state(cfg, ocfg, mesh, dev)
            step_fn = make_train_step(cfg, ocfg, tcfg, donate=True,
                                      param_shardings=psh)
            shards = {"params": psh, "opt": osh}
        else:
            say(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
                f"devices=1")
            st = TrainState.create(cfg, ocfg,
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(0), device=dev)
            params, opt = st.params, st.opt_state
            step_fn = make_train_step(cfg, ocfg, tcfg, donate=True)
            shards = None

        mgr = CheckpointManager(args.ckpt, every=args.ckpt_every) \
            if args.ckpt else None
        start = 0
        if mgr:
            s, tree, extra = mgr.restore_latest(
                {"params": params, "opt": opt}, shardings=shards)
            if s is not None:
                params, opt = tree["params"], tree["opt"]
                start = int(extra["step"])
                say(f"resumed at step {start}")

        dt = torch_dtype(cfg.dtype)
        t0 = time.time()
        for i in range(start, args.steps):
            b = batch_to(make_batch(cfg, args.batch, args.seq, step=i), dev,
                         dt)
            params, opt, m = step_fn(params, opt, b)
            if mgr:
                mgr.maybe_save(i + 1, {"params": params, "opt": opt},
                               extra={"step": i + 1})
            if i % 5 == 0 or i == args.steps - 1:
                say(f"step {i:4d} loss={float(m['loss']):.4f} "
                    f"lr={float(m['lr']):.2e} "
                    f"({(time.time()-t0)/(i-start+1):.2f}s/step)")
        say("done")
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
