"""Language-model training steps: the driver of the cells whose configuration
is a transformer with top-k experts and whose traffic is a stream of seeded
batches, one new batch a step, trained by AdamW.

Traffic parameters (the cell file's ``traffic``):
  ``batch``, ``seq_len``  sequences a step and their length;
  ``zipf_s``              the exponent of the token ids' Zipf law;
  ``first_steps``         steps of set-up, which the check follows;
  ``mfu_steps``           untraced steps the traced run times for
                          ``train_mfu``;
  ``trace_steps``         steps in the traced window.

The program is entered as its users enter it: the weights (made by the
benchmark from the seed, ``lm_init``) and zero AdamW moments in a
``training.TrainState``, and ``training.make_train_step`` with the
parameters and moments donated, called once a step.  Set-up drives that
state through the first steps and reads, from the state itself, each
step's loss, the first gradient of every leaf (from the first moment after
one step and the step's gradient norm, which fixes the clip: its norm, and
its entries at positions drawn from the seed, which give its direction)
and every leaf's change after the first steps; the check runs the plain
float32 reference through the same batches from the same weights and
compares.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from sfbench import counts, trace
from sfbench.lm_init import (Batches, draw_slice, flat_leaves, leaf_specs,
                             lm_dims, make_params, probe_index, slices)
from sfbench.reference import moe_lm


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sumsq(t: torch.Tensor) -> float:
    """Sum of squares in float64, a slice at a time."""
    parts = [t] if t.dim() < 3 else list(t.reshape(-1, *t.shape[-2:]))
    return sum(float(torch.sum(p.double() ** 2)) for p in parts)


def gap(got: float, want: float, base: float) -> float:
    """The gap between two norms over the larger of the reference's and
    ``base`` (the median leaf's)."""
    return abs(got - want) / max(abs(want), base, 1e-30)


class Cell:
    def __init__(self, conf: dict, workload: dict, seed: int, device):
        self.conf, self.wl, self.seed, self.dev = conf, workload, seed, device
        self.traffic = workload["traffic"]
        self.m = lm_dims(conf)
        self.B = int(self.traffic["batch"])
        self.S = int(self.traffic["seq_len"])
        self.losses = []

    def _program(self):
        from repro_torch.models.config import ModelConfig
        from repro_torch.training.optimizer import OptConfig
        from repro_torch.training.train_loop import TrainConfig
        m, c = self.m, self.conf
        cfg = ModelConfig(
            name=c["name"], family="moe", n_layers=m["n_layers"],
            d_model=m["d_model"], n_heads=m["n_heads"],
            n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=0,
            vocab=m["vocab"], rope_theta=m["rope_theta"],
            norm_eps=m["norm_eps"], moe_experts=m["moe_experts"],
            moe_topk=m["moe_topk"], moe_dff=m["moe_dff"],
            moe_capacity=m["moe_capacity"], dtype=c["param_dtype"],
            remat=c["remat"])
        return cfg, OptConfig(**c["optimizer"]), TrainConfig(**c["loss"])

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from repro_torch.training.optimizer import init_opt_state
        from repro_torch.training.train_loop import (TrainState,
                                                     make_train_step)
        cfg, ocfg, tcfg = self._program()
        params = make_params(self.conf, self.seed, self.dev)
        self.state = TrainState(params, init_opt_state(params, ocfg), 0)
        self.step_fn = make_train_step(cfg, ocfg, tcfg, donate=True)
        self.batches = Batches(self.traffic, self.m["vocab"], self.seed,
                               self.dev)
        self.first = {"losses": []}
        b1, clip = self.conf["optimizer"]["b1"], \
            self.conf["optimizer"]["grad_clip"]
        for i in range(1, int(self.traffic["first_steps"]) + 1):
            met = self.step()
            self.first["losses"].append(float(met["loss"]))
            if i == 1:
                gnorm = float(met["grad_norm"])
                c1 = min(clip / max(gnorm, 1e-12), 1.0) if clip else 1.0
                mom = flat_leaves(self.state.opt_state["m"])
                probe = probe_index(self.conf, self.seed, self.dev)
                self.first["grad_norm"] = gnorm
                self.first["first_grad_norm"] = {
                    n: math.sqrt(_sumsq(t)) / ((1 - b1) * c1)
                    for n, t in mom.items()}
                self.first["first_grad_probe"] = {
                    n: t.reshape(-1)[probe[n]].float()
                    for n, t in mom.items()}
        self.first["change_norm"] = self._change_norms()
        _sync(self.dev)
        self.losses = []

    def step(self) -> dict:
        st = self.state
        st.step += 1
        st.params, st.opt_state, met = self.step_fn(
            st.params, st.opt_state, self.batches.at(st.step))
        self.losses.append(met["loss"])
        return met

    def _change_norms(self) -> dict:
        """Each leaf's distance from its initial weights, which are drawn
        again slice by slice."""
        now = flat_leaves(self.state.params)
        out = {}
        for name, shape, std, dt in leaf_specs(self.conf):
            s = 0.0
            for idx in slices(shape):
                p0 = draw_slice(name, shape, std, dt, idx, self.seed,
                                self.dev)
                s += float(torch.sum((now[name][idx].double()
                                      - p0.double()) ** 2))
            out[name] = math.sqrt(s)
        return out

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        wall = time.perf_counter() - t0
        return {"attempted": n, "failed": self._failed(),
                "metrics": {"train_tokens_per_s": n * self.B * self.S
                            / wall}}

    def _failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def traced(self, path) -> dict:
        k = int(self.traffic["mfu_steps"])
        t = int(self.traffic["trace_steps"])
        _sync(self.dev)
        t0 = time.perf_counter()
        for _ in range(k):
            self.step()
        _sync(self.dev)
        mfu_s = time.perf_counter() - t0
        out = trace.profiled(lambda: [self.step() for _ in range(t)], path,
                             self.dev.type == "cuda")
        return {**out, "attempted": k + t, "failed": self._failed(),
                "program": {"steps": t, "mfu_steps": k, "mfu_seconds": mfu_s,
                            "flops_per_step": counts.train_flops_per_token(
                                self.m, self.S) * self.B * self.S,
                            "flash_flops_per_step":
                                counts.flash_flops_per_step(self.m, self.B,
                                                            self.S)},
                "config": self.conf, "traffic": self.traffic}

    # ----------------------------------------------------------------- check
    def info(self) -> dict:
        from repro_torch.kernels import tuning
        from repro_torch.models import moe
        plans = moe.plan_cache()
        return {"sf_backends": {"moe dispatch": "DynPlan, runtime index",
                                "plan_cache_hits": plans.hits,
                                "plan_cache_misses": plans.misses},
                "tuner_winners": {repr(k): v for k, v in
                                  tuning.winners().items()}}

    def release(self) -> None:
        del self.state, self.step_fn
        self.losses = [float(x) for x in self.losses]
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm=moe_lm.f32_mm, store=None, fault=None) -> dict:
        """The plain reference's readings over the first steps' batches
        from the same weights; computed through ``mm`` and storing its
        weights through ``store``, with ``fault`` (``"half"``: half of
        each batch left out; ``"shift"``: the labels shifted back by one
        token) planted in its batches, it stands in the program's place
        as a control or a fault."""
        moe_lm.no_tf32()
        P0 = flat_leaves(make_params(self.conf, self.seed, self.dev))
        batches = []
        for i in range(1, int(self.traffic["first_steps"]) + 1):
            b = dict(self.batches.at(i))
            if fault == "half":
                B, S = b["tokens"].shape
                keep = (slice(0, B // 2), slice(None)) if B > 1 \
                    else (slice(None), slice(0, S // 2))
                b = {k: v[keep] for k, v in b.items()}
            elif fault == "shift":
                b["labels"] = b["tokens"].clone()
            batches.append(b)
        return moe_lm.train(P0, batches, self.m, self.conf["loss"],
                            self.conf["optimizer"], mm, store,
                            probe_index(self.conf, self.seed, self.dev))

    def check(self, ref: dict = None) -> dict:
        ref = ref or self.reference()
        return compare(self.first, ref, self.wl["check"],
                       finite=all(math.isfinite(x) for x in self.losses))


def _unit(v: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(v)
    return v / n if n > 0 else v * 0


def direction_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The distance between the unit vectors along ``got`` and ``want``
    (a zero vector for a zero one): 0 for the same direction, about the
    angle between them for a small one, 1 where one of them is zero."""
    return float(torch.linalg.vector_norm(_unit(got.double())
                                          - _unit(want.double())))


def readings(got: dict, ref: dict) -> dict:
    """The numbers a run can compare: the relative gap of each step's
    loss; the gap of each leaf's first gradient norm and of its change
    over the first steps (each over the larger of the reference's norm of
    that leaf and of the median leaf), with the worst leaf's and the
    median leaf's gradient gap; and the gap of each leaf's first gradient
    direction at the probed positions, the worst leaf's and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out."""
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 ref["losses"])]
    g_ref, c_ref = ref["first_grad_norm"], ref["change_norm"]
    g_med = statistics.median(g_ref.values())
    c_med = statistics.median(c_ref.values())
    counted = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]
    grad = {n: gap(got["first_grad_norm"][n], g_ref[n], g_med)
            for n in counted}
    change = {n: gap(got["change_norm"][n], c_ref[n], c_med)
              for n in counted}
    gdir = {n: direction_gap(got["first_grad_probe"][n],
                             ref["first_grad_probe"][n]) for n in counted}
    return {"loss": steps[0], "loss_by_step": steps,
            "grad": max(grad.values()),
            "grad_median": statistics.median(grad.values()),
            "grad_dir": max(gdir.values()),
            "grad_dir_median": statistics.median(gdir.values()),
            "change": max(change.values()), "grad_by_leaf": grad,
            "grad_dir_by_leaf": gdir, "change_by_leaf": change,
            "left_out": sorted(set(g_ref) - set(counted))}


def compare(got: dict, ref: dict, limits: dict, finite: bool = True) -> dict:
    """Each number the cell's ``check`` names beside its limit; the rest
    of the readings as detail."""
    r = readings(got, ref)
    out = {k: {"value": r[k], "limit": lim, "ok": r[k] <= lim}
           for k, lim in limits.items()}
    out["finite"] = {"value": int(finite), "limit": 1, "ok": finite}
    out["_detail"] = {k: r[k] for k in ("loss", "loss_by_step",
                                        "grad_by_leaf", "grad_dir_by_leaf",
                                        "change_by_leaf", "left_out")}
    return out


# stand-ins for the program in ``controls``: (matrix product, rounding of
# the weights the program keeps in bfloat16, fault in the batches)
STAND_INS = {
    # the control: one precision down, the weights stored in float8 and
    # every product's operands rounded to float8
    "control_fp8": (moe_lm.fp8_mm, moe_lm.round_fp8, None),
    # the step a later change could take alone: the products in float8
    "control_fp8_products": (moe_lm.fp8_mm, None, None),
    # a witness: the reference emulating the configuration's bfloat16
    "emulated_bf16": (moe_lm.bf16_mm, moe_lm.round_bf16, None),
    "fault_half_batch": (moe_lm.f32_mm, None, "half"),
    "fault_label_shift": (moe_lm.f32_mm, None, "shift"),
}


def controls(name: str, wl: dict, conf: dict, seeds, n_controls: int, dev,
             emit) -> None:
    """The readings a training cell's limits are set from (``controls.py``):
    the program's on every seed, and on the first ``n_controls`` seeds
    each stand-in's (a state left unchanged reads 1 by the measure and
    needs no run)."""
    for s in seeds:
        t0 = time.perf_counter()
        cell = Cell(conf, wl, s, dev)
        cell.setup()
        t1 = time.perf_counter()
        cell.release()
        ref = cell.reference()
        emit(kind="program", workload=name, seed=s, setup_s=t1 - t0,
             losses=cell.first["losses"], ref_losses=ref["losses"],
             **readings(cell.first, ref))
        if s in seeds[:n_controls]:
            low = [n for n, _, _, dt in leaf_specs(conf)
                   if dt == torch.bfloat16]
            for label, (mm, rnd, fault) in STAND_INS.items():
                got = cell.reference(mm, {n: rnd for n in low} if rnd
                                     else None, fault)
                emit(kind=label, workload=name, seed=s,
                     losses=got["losses"], **readings(got, ref))
                del got
                _free(dev)
        del cell, ref
        _free(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
