"""Continuous-batching serving engine with bucketed prefill and SLO metrics
(the port of ``repro/serving/engine.py``).

``ServeEngine`` owns one fixed-size decode batch of slots.  Requests queue;
whenever a slot frees (EOS or length), the next request is prefilled into it
(prefill writes its KV into that slot's cache rows) while the other slots
keep decoding — continuous batching, not static batching.  All active slots
step together through one decode program per token.

Prefill runs every layer's attention through the hand-written flash
kernel; the per-slot-position decode stays in plain torch, as the reference
leaves it outside any kernel.  A MoE config's feed-forward dispatches
through ``DynPlan`` on the hand-written gathers, in prefill and decode
alike; its capacity ties a token's output to the other tokens of its
routing group (at decode: every slot, idle ones feeding token 0 at their
stale positions, as in the reference).  Prompt lengths are bucketed to
the next power of two (right-padded; causal masking keeps real positions
numerically unaffected, and decode overwrites each pad KV row before its
mask exposes it).  The prepared programs are cached in a :class:`repro_torch.core.PlanCache`
keyed ``("prefill", bucket)`` / ``("decode", batch)``; with no jit the cached
program is the prepared closure, and the cache's hit/miss counters keep the
reference's meaning.

Per-request service metrics follow the serving literature: TTFT (submit →
first token), TPOT (mean inter-token time after the first), and SLO
attainment against configurable targets — aggregated by :meth:`metrics`.
See :mod:`repro_torch.serving.loadgen` for the open-loop load generator.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import sflog
from ..core.device import resolve_device
from ..core.dynplan import PlanCache
from ..models import transformer as T
from ..models.config import ModelConfig
from ..models.layers import rmsnorm, rope

__all__ = ["Request", "ServeEngine", "next_pow2"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the prefill length bucket)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]
    max_new: int = 32
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # service timeline (engine clock seconds; -1 = not yet)
    t_submit: float = -1.0
    t_first: float = -1.0
    t_last: float = -1.0

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (s), once it exists."""
        if self.t_first < 0 or self.t_submit < 0:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first (s)."""
        if self.t_first < 0 or self.t_last < 0 or len(self.out) < 2:
            return None
        return (self.t_last - self.t_first) / (len(self.out) - 1)


class ServeEngine:
    """Serve ``cfg`` with ``params`` (as ``models.transformer.init_params``
    or ``convert.params_from_arrays`` make them) on ``device`` — the
    current CUDA device unless ``device="cpu"``; params elsewhere raise.
    Non-greedy sampling draws from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int = 8,
                 s_max: int = 512, eos_id: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0, seed: int = 0,
                 bucket_prompts: Optional[bool] = None,
                 ttft_slo: Optional[float] = None,
                 tpot_slo: Optional[float] = None,
                 clock=time.perf_counter, device=None):
        T.require_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device} but "
                             f"the engine runs on {self.device}; move them "
                             f"there explicitly")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.s_max = s_max
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if bucket_prompts is None:
            bucket_prompts = cfg.block_kind == "transformer"
        self.bucket_prompts = bucket_prompts
        self.ttft_slo = ttft_slo
        self.tpot_slo = tpot_slo
        self.clock = clock

        self.cache = T.init_cache(cfg, batch, s_max, device=self.device)
        # slot-local decode positions (host side); the decode below masks
        # each row at its own position
        self.positions = np.zeros(batch, dtype=np.int64)
        self.active: List[Optional[Request]] = [None] * batch
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.t_start: Optional[float] = None
        # service tallies live in the sflog registry (per-engine counters)
        self._c_steps = sflog.counter("serve.decode_steps", unique=True)
        self._c_tokens = sflog.counter("serve.tokens_generated", unique=True)
        self._c_ttft_n = sflog.counter("serve.ttft_slo_total", unique=True)
        self._c_ttft_ok = sflog.counter("serve.ttft_slo_ok", unique=True)
        self._c_tpot_n = sflog.counter("serve.tpot_slo_total", unique=True)
        self._c_tpot_ok = sflog.counter("serve.tpot_slo_ok", unique=True)

        # prepared-program cache: ("prefill", bucket) / ("decode", batch)
        self.programs = PlanCache("serve-programs")

    @property
    def steps(self) -> int:
        return self._c_steps.value

    @steps.setter
    def steps(self, v: int) -> None:
        self._c_steps.value = int(v)

    # -------------------------------------------------------------- prefill
    def _bucket(self, plen: int) -> int:
        if not self.bucket_prompts:
            return plen
        return min(next_pow2(plen), self.s_max)

    def _prefill_fn(self, bucket: int):
        cfg = self.cfg

        def build():
            def fn(params, tokens, last_pos):
                return T.prefill(params, cfg, tokens=tokens,
                                 s_max=self.s_max, last_pos=last_pos)
            return fn
        return self.programs.get_or_build(("prefill", bucket), build)

    def _decode_fn(self):
        return self.programs.get_or_build(
            ("decode", self.batch), lambda: partial(self._decode_impl,
                                                    self.cfg))

    @staticmethod
    def _decode_impl(cfg, params, tokens, cache, positions):
        """Per-slot-position decode: like ``decode_step`` but each batch row
        has its own position.  tokens, positions: (B,) int64 tensors.  The
        cache's K/V tensors are updated in place.

        GQA heads are grouped per KV head instead of repeating the cache;
        both contractions run in float32, as in the reference."""
        x = params["embed"][tokens[:, None]]
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        rep = H // Hkv
        rows = torch.arange(B, device=x.device)
        kpos = torch.arange(cache["k"].shape[2], device=x.device)
        mask = kpos[None] <= positions[:, None]
        if cfg.attn_window:
            mask &= kpos[None] > positions[:, None] - cfg.attn_window
        mask = mask[:, None, None, :]                 # (B, 1, 1, s_max)
        blocks = params["blocks"]
        for i in range(cfg.n_layers):
            bp = T.layer(blocks, i)
            ck, cv = cache["k"][i], cache["v"][i]
            h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
            q = (h @ bp["wq"]).reshape(B, H, hd)
            k = (h @ bp["wk"]).reshape(B, Hkv, hd)
            v = (h @ bp["wv"]).reshape(B, Hkv, hd)
            if cfg.qk_norm:
                q = rmsnorm(q, bp["q_norm"], cfg.norm_eps)
                k = rmsnorm(k, bp["k_norm"], cfg.norm_eps)
            # per-row rope at each row's position, then the cache write
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            ck[rows, positions] = k.to(ck.dtype)
            cv[rows, positions] = v.to(cv.dtype)
            qg = q.float().reshape(B, Hkv, rep, hd)
            s = torch.einsum("bkrd,bskd->bkrs", qg, ck.float()) * \
                (1.0 / math.sqrt(hd))
            pr = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
            attn = torch.einsum("bkrs,bskd->bkrd", pr, cv.float())
            x = x + attn.to(x.dtype).reshape(B, 1, H * hd) @ bp["wo"]
            h2 = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if cfg.is_moe or cfg.d_ff:
                # MoE: one routing group of all B slots, idle ones included
                # (token 0 at their stale positions), as in the reference
                x = x + T.feed_forward(h2, bp, cfg)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (x @ head)[:, 0], cache

    # ------------------------------------------------------------- plumbing
    def submit(self, req: Request):
        if req.t_submit < 0:
            req.t_submit = self.clock()
        self.queue.append(req)

    def _admit(self):
        """Prefill queued requests into free slots.  A slot's rows of the
        engine cache are overwritten in place (``copy_``) with the
        request's prefilled cache."""
        for slot in range(self.batch):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                plen = len(req.tokens)
                bucket = self._bucket(plen)
                toks = np.zeros((1, bucket), np.int64)
                toks[0, :plen] = req.tokens
                t0 = sflog.op_begin() if sflog.enabled() else None
                logits, cache1 = self._prefill_fn(bucket)(
                    self.params, torch.as_tensor(toks, device=self.device),
                    [plen - 1])
                if t0 is not None:
                    sflog.op_end("ServePrefill", t0, logits,
                                 tags={"bucket": bucket, "rid": req.rid})
                for name in ("k", "v"):
                    self.cache[name][:, slot].copy_(cache1[name][:, 0])
                first = int(self._sample(logits)[0])
                req.out.append(first)
                self._c_tokens.add(1)
                req.t_first = req.t_last = self.clock()
                self.positions[slot] = plen
                self.active[slot] = req

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu().numpy()

    def step(self) -> int:
        """Admit + one decode step for all active slots.  Returns #pending
        (active slots + queued requests)."""
        if self.t_start is None:
            self.t_start = self.clock()
        self._admit()
        if not any(r is not None for r in self.active):
            return len(self.queue)
        last = np.zeros(self.batch, np.int64)
        for s, r in enumerate(self.active):
            if r is not None:
                last[s] = r.out[-1] if r.out else r.tokens[-1]
        t0 = sflog.op_begin() if sflog.enabled() else None
        logits, self.cache = self._decode_fn()(
            self.params, torch.as_tensor(last, device=self.device),
            self.cache, torch.as_tensor(self.positions, device=self.device))
        if t0 is not None:
            sflog.op_end("ServeDecode", t0, logits,
                         tags={"batch": self.batch})
        nxt = self._sample(logits)
        self._c_steps.add(1)
        now = self.clock()
        n_active = 0
        for s, r in enumerate(self.active):
            if r is None:
                continue
            tok = int(nxt[s])
            r.out.append(tok)
            self._c_tokens.add(1)
            r.t_last = now
            self.positions[s] += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(r.out) >= r.max_new or \
                    self.positions[s] >= self.s_max - 1:
                r.done = True
                self._finish_tallies(r)
                self.finished.append(r)
                self.active[s] = None
            else:
                n_active += 1
        return n_active + len(self.queue)

    def run(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return requests

    # -------------------------------------------------------------- metrics
    def _finish_tallies(self, r: Request) -> None:
        """Registry-side SLO tallies, bumped once per finished request."""
        if self.ttft_slo is not None and r.ttft is not None:
            self._c_ttft_n.add(1)
            if r.ttft <= self.ttft_slo:
                self._c_ttft_ok.add(1)
        if self.tpot_slo is not None and r.tpot is not None:
            self._c_tpot_n.add(1)
            if r.tpot <= self.tpot_slo:
                self._c_tpot_ok.add(1)

    def metrics(self) -> Dict:
        """Aggregate service metrics over finished requests: tokens/sec,
        TTFT/TPOT p50/p99, SLO attainment, program-cache stats."""
        done = self.finished

        def pct(vals, q):
            return float(np.percentile(vals, q)) if vals else None

        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        gen = sum(len(r.out) for r in done) + \
            sum(len(r.out) for r in self.active if r is not None)
        t_end = max([self.t_start or 0.0] +
                    [r.t_last for r in done if r.t_last >= 0])
        elapsed = max(t_end - self.t_start, 1e-9) if self.t_start is not None \
            else None
        out = {
            "requests_finished": len(done),
            "decode_steps": self.steps,
            "tokens_generated": gen,
            "tokens_per_sec": (gen / elapsed) if elapsed else None,
            "ttft_p50_s": pct(ttfts, 50), "ttft_p99_s": pct(ttfts, 99),
            "tpot_p50_s": pct(tpots, 50), "tpot_p99_s": pct(tpots, 99),
            "program_cache": self.programs.stats(),
            "prefill_buckets": sorted(k[1] for k in self.programs.keys()
                                      if k[0] == "prefill"),
        }
        if self.ttft_slo is not None and ttfts:
            out["ttft_slo_s"] = self.ttft_slo
            out["ttft_slo_attainment"] = float(
                np.mean([t <= self.ttft_slo for t in ttfts]))
        if self.tpot_slo is not None and tpots:
            out["tpot_slo_s"] = self.tpot_slo
            out["tpot_slo_attainment"] = float(
                np.mean([t <= self.tpot_slo for t in tpots]))
        return out
