"""End-to-end training driver on the PyTorch port: train an LM of any
architecture family for a few hundred steps with checkpoint / resume and
the deterministic data stream (the port's counterpart of
``examples/train_lm.py``).

Defaults are sized for a short demo (~20M parameters, 60 steps).  On the
card, the full run:

  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

Any architecture works through --arch, reduced to the preset's size while
keeping its family (MoE stays MoE, hymba keeps its SSM heads, xlstm its
pairs, whisper its encoder).  ``--device cpu`` runs on the CPU;
``--resume`` continues from the newest checkpoint under ``--ckpt``.
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models.config import torch_dtype
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import make_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, TrainState,
                                             batch_to, make_train_step)

PRESETS = {
    # name: (d_model, layers, heads, kv, d_ff, vocab)  ~param count
    "tiny": (64, 2, 4, 2, 128, 512),
    "20m": (256, 4, 4, 2, 1024, 32000),
    "100m": (640, 10, 10, 5, 2560, 32000),
}


def preset_config(arch: str, preset: str, dtype: str):
    """``arch``'s config at the preset's size, as ``examples/train_lm.py``
    sizes it, with remat per block."""
    d, L, H, Hkv, F, V = PRESETS[preset]
    base = get_config(arch)
    return base.scaled(
        d_model=d, n_layers=L, n_heads=H, n_kv_heads=Hkv, head_dim=d // H,
        d_ff=F if base.d_ff else 0, vocab=V,
        moe_experts=8 if base.is_moe else 0,
        moe_topk=2 if base.is_moe else 0,
        moe_dff=F // 4 if base.is_moe else 0, moe_shared_ff=0,
        ssm_heads=H if base.ssm_heads else 0,
        enc_layers=2 if base.enc_layers else 0,
        attn_window=min(base.attn_window, 64) if base.attn_window else None,
        dtype=dtype, remat="block")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ckpt", default="checkpoints/torch_train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset, args.dtype)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    ocfg = OptConfig(lr=args.lr, warmup_steps=20, decay_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches)
    st = TrainState.create(cfg, ocfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    step_fn = make_train_step(cfg, ocfg, tcfg, donate=True)

    mgr = CheckpointManager(args.ckpt, keep=2, every=args.ckpt_every)
    start = 0
    if args.resume:
        s, tree, extra = mgr.restore_latest(
            {"params": st.params, "opt": st.opt_state})
        if s is not None:
            st.params, st.opt_state = tree["params"], tree["opt"]
            start = int(extra["step"])
            print(f"resumed from step {start}")

    dt = torch_dtype(cfg.dtype)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = batch_to(make_batch(cfg, args.batch, args.seq, step=i % 16),
                         dev, dt)
        st.params, st.opt_state, m = step_fn(st.params, st.opt_state, batch)
        mgr.maybe_save(i + 1, {"params": st.params, "opt": st.opt_state},
                       extra={"step": i + 1})
        if i % 10 == 0 or i == args.steps - 1:
            secs = time.time() - t0
            tok_s = (i - start + 1) * args.batch * args.seq / max(secs, 1e-9)
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} tok/s={tok_s:,.0f}")
    print("done.")


if __name__ == "__main__":
    main()
