"""Serving demo on the port: continuous-batched generation through the
SF-backed engine (the port of ``examples/serve_lm.py``).

The qwen3-4b smoke config with random weights from seed 0; on the card
(the default) every prefill's attention runs the flash kernel, ``--device
cpu`` runs its plain version.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("qwen3-4b").smoke_config().scaled(dtype="float32",
                                                       remat="none")
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    eng = ServeEngine(cfg, params, batch=4, s_max=96, device=dev)
    prompts = [[1 + i, 7, 3, 2] for i in range(9)]
    reqs = [Request(i, p, max_new=12) for i, p in enumerate(prompts)]
    t0 = time.time()
    eng.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt={r.tokens} -> {r.out}")
    print(f"... {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, batch=4 slots, continuous batching, "
          f"{dev.type})")


if __name__ == "__main__":
    main()
