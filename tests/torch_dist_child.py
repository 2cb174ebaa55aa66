"""One rank of a gloo process group for ``tests/test_torch_distributed.py``.

The parent writes the star forests (rank graphs as numpy arrays) and the
global payloads to one ``.npz``; every rank runs the same ops through the
per-rank ``DistSF`` API and through ``SFComm(backend="dist")``, under the
SF's own lowering and under ``"general"``, and writes its results to
``rank<r>.npz``.  This module imports only numpy at the top, and torch and
``repro_torch`` in the child (never JAX or the reference package).

:func:`mesh_main` is one rank of ``tests/test_torch_mesh.py``'s sharded
training step on a device mesh (DTensor placements over the gloo group).
"""

import os
import traceback
from datetime import timedelta

import numpy as np

# payload name -> (unit, dtype); the parent makes the data
PAYLOADS = {"i32x3": ((3,), "int32"), "f32x2x2": ((2, 2), "float32"),
            "bool": ((), "bool"), "u16x2": ((2,), "uint16")}
OPS = ("replace", "sum", "prod", "max", "min")
LOWERINGS = ("auto", "general")
# the star forests of each world size (names of the parent's builders)
WORLDS = {2: ("general_r2s0", "general_r2s1", "allgather_r2", "permute_r2",
              "local_only", "strided"),
          4: ("general0", "general1", "allgather", "permute", "composed",
              "composed_inverse", "embedded")}
COLLECTIVES = ("all_to_all_single", "all_gather_into_tensor",
               "reduce_scatter_tensor", "batch_isend_irecv")


def ops_for(dtype: str):
    """The ops a payload takes (a sum or product into bool raises)."""
    return ("replace", "max", "min") if dtype == "bool" else OPS


def key(*parts) -> str:
    return "|".join(str(p) for p in parts)


def graph_arrays(sf) -> dict:
    """The rank graphs of a reference or port StarForest, as arrays."""
    out = {}
    for r in range(sf.nranks):
        g = sf.graph(r)
        out[key("graph", r)] = np.array([g.nroots, g.nleafspace], np.int64)
        out[key("local", r)] = np.asarray(g.local, np.int64)
        out[key("remote", r)] = np.stack(
            [np.asarray(g.remote_rank, np.int64),
             np.asarray(g.remote_offset, np.int64)], 1).reshape(-1, 2)
    return out


def _star_forest(data, name: str, world: int):
    from repro_torch.core import RankGraph, StarForest
    graphs = []
    for r in range(world):
        nroots, nleafspace = data[key(name, "graph", r)]
        remote = data[key(name, "remote", r)]
        graphs.append(RankGraph(nroots=int(nroots),
                                nleafspace=int(nleafspace),
                                local=data[key(name, "local", r)],
                                remote_rank=remote[:, 0].copy(),
                                remote_offset=remote[:, 1].copy()))
    return StarForest.from_rank_graphs(graphs)


class _Counting:
    """Counts the collective calls made through ``torch.distributed``."""

    def __init__(self, dist):
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        for name in COLLECTIVES:
            setattr(dist, name, self._wrap(name, getattr(dist, name)))

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            self.counts[name] += 1
            return fn(*args, **kwargs)
        return run

    def during(self, fn) -> np.ndarray:
        before = dict(self.counts)
        fn()
        return np.array([self.counts[c] - before[c] for c in COLLECTIVES])


def _run(rank: int, world: int, data, out: dict) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import DistSF, SFComm
    counting = _Counting(dist)
    cpu = torch.device("cpu")

    def tensor(name, payload, side):
        return torch.from_numpy(data[key(name, payload, side)].copy())

    for name in WORLDS[world]:
        sf = _star_forest(data, name, world)
        ro, lo = sf.root_offsets(), sf.leaf_offsets()
        for low in LOWERINGS:
            comm = SFComm(sf, backend="dist", device=cpu, lowering=low)
            sfo = comm.backend.dist
            out[key(name, low, "lowering")] = np.array([sfo.lowering])
            pads = {"root": sfo.plan.root_pad, "leaf": sfo.plan.leaf_pad}

            def shard(t, off, side):
                """This rank's rows of a global tensor, zero-padded."""
                s = t.new_zeros((pads[side],) + tuple(t.shape[1:]))
                s[: off[rank + 1] - off[rank]] = t[off[rank]: off[rank + 1]]
                return s
            for pl, (unit, dtype) in PAYLOADS.items():
                root, leaf = tensor(name, pl, "root"), tensor(name, pl, "leaf")
                rs, ls = shard(root, ro, "root"), shard(leaf, lo, "leaf")
                nr, nl = int(ro[rank + 1] - ro[rank]), \
                    int(lo[rank + 1] - lo[rank])
                for op in ops_for(dtype):
                    res = {
                        "comm": (comm.bcast(root, leaf, op),
                                 comm.reduce(leaf, root, op)),
                        "comm_split": (
                            comm.bcast_begin(root, op).end(leaf),
                            comm.reduce_end(comm.reduce_begin(leaf, op),
                                            root)),
                        "sf": (sfo.bcast_end(sfo.bcast_begin(rs, op),
                                             ls)[:nl],
                               sfo.reduce_end(sfo.reduce_begin(ls, op),
                                              rs)[:nr])}
                    for api, (b, r) in res.items():
                        out[key(name, low, api, "bcast", pl, op)] = b.numpy()
                        out[key(name, low, api, "reduce", pl, op)] = r.numpy()
            ri, li = tensor(name, "fetch", "root"), tensor(name, "fetch",
                                                           "leaf")
            for k, v in zip(("root", "leaf"), comm.fetch_and_op(ri, li)):
                out[key(name, low, "comm", "fetch", k)] = v.numpy()
            fr, fl = sfo.fetch_and_op(shard(ri, ro, "root"),
                                      shard(li, lo, "leaf"))
            out[key(name, low, "sf", "fetch", "root")] = fr[:nr].numpy()
            out[key(name, low, "sf", "fetch", "leaf")] = \
                fl[:lo[rank + 1] - lo[rank]].numpy()
            # the leaf-dtype fold: int8 leaves summed into int32 roots
            out[key(name, low, "comm", "mixed")] = comm.reduce(
                tensor(name, "mixed", "leaf"),
                tensor(name, "mixed", "root")).numpy()
        # the collectives each lowering issues (DistSF alone)
        sfo = DistSF(sf, device=cpu)
        rs = sfo.pad_root_stack([tensor(name, "f32x2x2", "root")[
            ro[rank]: ro[rank + 1]]])[0]
        ls = sfo.pad_leaf_stack([tensor(name, "f32x2x2", "leaf")[
            lo[rank]: lo[rank + 1]]])[0]
        for op in ("replace", "sum"):
            out[key(name, "calls", "bcast", op)] = counting.during(
                lambda: sfo.bcast(rs, ls, op))
            out[key(name, "calls", "reduce", op)] = counting.during(
                lambda: sfo.reduce(ls, rs, op))
        out[key(name, "calls", "fetch")] = counting.during(
            lambda: sfo.fetch_and_op(rs[:, 0, 0].contiguous(),
                                     ls[:, 0, 0].contiguous()))
        # the split: compute placed between begin and end, sync_mode, and
        # the plain path, all against the fused op's bits
        fused = (sfo.bcast(rs, ls, "sum"), sfo.reduce(ls, rs, "sum"))
        pb, pr = sfo.bcast_begin(rs, "sum"), sfo.reduce_begin(ls, "sum")
        x = torch.randn(256, 256, generator=torch.Generator().manual_seed(1))
        out[key(name, "between")] = (x @ x).sum().numpy()
        split = (sfo.bcast_end(pb, ls), sfo.reduce_end(pr, rs))
        sync = DistSF(sf, device=cpu, sync_mode=True)
        plain = DistSF(sf, device=cpu, use_kernels=False)
        for tag, (b, r) in (("fused", fused), ("split", split),
                            ("sync", (sync.bcast(rs, ls, "sum"),
                                      sync.reduce(ls, rs, "sum"))),
                            ("plain", (plain.bcast(rs, ls, "sum"),
                                       plain.reduce(ls, rs, "sum")))):
            out[key(name, "variant", tag, "bcast")] = b.numpy()
            out[key(name, "variant", tag, "reduce")] = r.numpy()
    if world == 4:
        _consumers(rank, data, out, cpu)


def _consumers(rank: int, data, out: dict, cpu) -> None:
    """grow_overlap on "dist" against "global"; bcast_multi / reduce_multi
    on "dist" (a pinned unit: the sibling backend) against per-field
    ops."""
    import torch
    from repro_torch.core import SFComm, UnitSpec
    from repro_torch.meshdist.plex import (HexMesh, distribute, grow_overlap,
                                           initial_distribution)
    for backend in ("dist", "global"):
        dm = distribute(initial_distribution(HexMesh(4, 4, 2), 4, "rand",
                                             seed=3), device=cpu)
        ov = grow_overlap(dm, levels=2, backend=backend, device=cpu)
        for q in range(4):
            out[key("overlap", backend, "cells", q)] = ov.cells[q]
            out[key("overlap", backend, "level", q)] = ov.level[q]
    sf = _star_forest(data, "general0", 4)
    comm = SFComm(sf, backend="dist", device=cpu,
                  unit=UnitSpec((3,), np.float32))
    gen = torch.Generator().manual_seed(5)
    roots = [torch.randn(sf.nroots_total, 3, generator=gen) for _ in range(3)]
    leaves = [torch.randn(sf.nleafspace_total, 3, generator=gen)
              for _ in range(3)]
    for i, (m, s) in enumerate(zip(comm.bcast_multi(roots, leaves),
                                   [comm.bcast(r, l) for r, l in
                                    zip(roots, leaves)])):
        out[key("multi", "bcast", i)] = np.stack([m.numpy(), s.numpy()])
    for i, (m, s) in enumerate(zip(
            comm.reduce_multi(leaves, roots, "sum"),
            [comm.reduce(l, r, "sum") for r, l in zip(roots, leaves)])):
        out[key("multi", "reduce", i)] = np.stack([m.numpy(), s.numpy()])


def main(rank: int, world: int, store: str, in_path: str,
         out_dir: str) -> None:
    """Join the gloo group through the ``file://`` store, run every case,
    write ``rank<r>.npz`` (a traceback to ``rank<r>.err`` on failure)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        try:
            out = {}
            with np.load(in_path) as data:
                _run(rank, world, data, out)
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------------- meshes
# the sharded step's meshes of each world size, and the smoke config it
# trains (float32, so that the ranks' sums differ from world 1's only in
# their order)
MESHES = {4: ((2, 2), (4, 1), (1, 4))}
MESH_STEPS = 2
MESH_BATCH = (4, 16)
# prefill then decode steps on each mesh: (batch, prompt, s_max, steps);
# on (1, 4) the smoke config's 2 KV heads do not divide over ``model``, so
# the cache shards its sequence
SERVE = (4, 12, 16, 3)


def mesh_config():
    from repro_torch.configs import get_config
    return get_config("qwen3-4b").smoke_config().scaled(dtype="float32")


def mesh_batches(cfg) -> list:
    from repro_torch.training.data import make_batch
    return [make_batch(cfg, *MESH_BATCH, step=i) for i in range(MESH_STEPS)]


def _mesh_run(rank: int, world: int, ckpt_in: str, out_dir: str,
              out: dict) -> None:
    """Per mesh: ``MESH_STEPS`` sharded steps from init_params's seed-0
    parameters (loss and every parameter whole), the world-1 checkpoint
    restored into the mesh's layout, the (2, 2) state saved for world 1 to
    restore; then every other family on the (2, 2) and (1, 4) meshes
    (:func:`_family_on_mesh`)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import sharded_state
    from repro_torch.training.checkpoint import (latest_step,
                                                 load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step
    cpu = torch.device("cpu")
    cfg = mesh_config()
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    names = None
    for shape in MESHES[world]:
        tag = "x".join(map(str, shape))
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        params, opt, psh, osh = sharded_state(cfg, ocfg, mesh, cpu)
        out[key(tag, "placements", "wq")] = np.array(
            str(params["blocks"]["wq"].placements))
        step = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
        for i, b in enumerate(mesh_batches(cfg)):
            params, opt, m = step(params, opt, b)
            out[key(tag, "loss", i)] = m["loss"].numpy()
        flat = {}
        _named(params, "", flat)
        names = sorted(flat)
        for n in names:
            out[key(tag, "param", n)] = flat[n].full_tensor().numpy()
        _serve_on_mesh(cfg, params, mesh, tag, out)
        # the world-1 checkpoint, restored into this mesh's layout
        s = latest_step(ckpt_in)
        tree, _ = load_checkpoint(ckpt_in, s, {"params": params, "opt": opt},
                                  shardings={"params": psh, "opt": osh})
        got = {}
        _named(tree["params"], "", got)
        out[key(tag, "restored_placements_equal")] = np.array(all(
            tuple(got[n].placements) == tuple(flat[n].placements)
            for n in names))
        for n in names:
            out[key(tag, "restored", n)] = got[n].full_tensor().numpy()
        if shape == (2, 2):
            save_checkpoint(os.path.join(out_dir, "ckpt_mesh"), 7,
                            {"params": params, "opt": opt},
                            extra={"step": 7})
    for shape in FAMILY_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch in FAMILIES:
            _family_on_mesh(arch, mesh, out)
    out["names"] = np.array(names)


# the other families' smoke configs on these meshes: phi3.5-moe (4
# experts over model), hymba (2 SSM heads: over model = 2, gathered on
# model = 4), xlstm (4 heads), whisper (the encoder over FAMILY_ENC frames)
FAMILIES = ("phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-350m",
            "whisper-base")
FAMILY_MESHES = ((2, 2), (1, 4))
FAMILY_ENC = 24
# the MoE layer alone on the mesh, from numpy inputs: (batch, tokens)
MOE_LAYER_X = (4, 8)


def family_config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).smoke_config().scaled(dtype="float32")


def family_batches(cfg) -> list:
    from repro_torch.training.data import make_batch
    return [make_batch(cfg, *MESH_BATCH, step=i, enc_len=FAMILY_ENC)
            for i in range(MESH_STEPS)]


def family_enc(cfg):
    """whisper's frame embeddings (B, FAMILY_ENC, D) for the serving run,
    from a seed; None for the other families."""
    if not cfg.enc_layers:
        return None
    rng = np.random.default_rng(4)
    return (rng.standard_normal((SERVE[0], FAMILY_ENC, cfg.d_model))
            * 0.02).astype(np.float32)


def moe_layer_inputs(cfg) -> dict:
    """One MoE layer's parameters (a stack of one) and its input x, from a
    seed, as numpy arrays under the reference's names."""
    rng = np.random.default_rng(5)
    D, E, F = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    f32 = np.float32
    return {"x": (rng.standard_normal(MOE_LAYER_X + (D,)) * 0.5).astype(f32),
            "router": (rng.standard_normal((1, D, E)) / np.sqrt(D))
            .astype(f32),
            "w_in": (rng.standard_normal((1, E, D, F)) / np.sqrt(D))
            .astype(f32),
            "w_gate": (rng.standard_normal((1, E, D, F)) / np.sqrt(D))
            .astype(f32),
            "w_out": (rng.standard_normal((1, E, F, D)) / np.sqrt(F))
            .astype(f32)}


def family_serve(cfg, params, tokens, enc, run=lambda f: f(),
                 put=lambda t: t):
    """Prefill (s_max ``SERVE[2]``) and greedy decode steps of ``cfg``:
    the logits of each, as numpy.  ``run`` wraps each call (a mesh made
    ambient) and ``put`` places each input (a DTensor batch layout)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.meshed import whole
    kw = {} if enc is None else {"enc_embeds": put(torch.as_tensor(enc))}
    logits, cache = run(lambda: T.prefill(
        params, cfg, tokens=put(torch.as_tensor(tokens)), s_max=SERVE[2],
        **kw))
    outs = [whole(logits).numpy()]
    for _ in range(1, SERVE[3]):
        nxt = whole(logits).argmax(-1)
        logits, cache = run(lambda: T.decode_step(params, cfg, put(nxt),
                                                  cache))
        outs.append(whole(logits).numpy())
    return outs, cache


def _family_on_mesh(arch: str, mesh, out: dict) -> None:
    """``arch``'s smoke config on ``mesh``: prefill and greedy decode from
    the seed-0 parameters, then ``MESH_STEPS`` sharded steps through the
    launcher's path (loss and every parameter whole); for MoE also its
    layer alone from numpy inputs, both dispatch modes."""
    import torch
    from repro_torch.launch.cells import _on_mesh
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.launch.train import sharded_state
    from repro_torch.models import moe as M
    from repro_torch.models.sharding import (NamedSharding, batch_spec,
                                             param_specs, place, shardings)
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step
    cpu = torch.device("cpu")
    tag = "x".join(map(str, mesh.shape))
    cfg = family_config(arch)
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    params, opt, psh, _ = sharded_state(cfg, ocfg, mesh, cpu)
    bs = NamedSharding(mesh, batch_spec(mesh_sizes(mesh)))
    serve, cache = family_serve(
        cfg, params, serve_tokens(cfg), family_enc(cfg),
        run=lambda f: _on_mesh(mesh, f), put=bs.distribute)
    for i, lg in enumerate(serve):
        out[key(tag, arch, "serve", i)] = lg
    for n, t in cache.items():
        if n != "pos" and not isinstance(t, dict):
            out[key(tag, arch, "cache", n)] = np.array(str(t.placements))
    step = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
    for i, b in enumerate(family_batches(cfg)):
        params, opt, m = step(params, opt, b)
        out[key(tag, arch, "loss", i)] = m["loss"].numpy()
    flat = {}
    _named(params, "", flat)
    for n, t in flat.items():
        out[key(tag, arch, "param", n)] = t.full_tensor().numpy()
    if cfg.is_moe:
        a = moe_layer_inputs(cfg)
        stack = {n: torch.as_tensor(v) for n, v in a.items() if n != "x"}
        stack = place({"blocks": stack}, shardings(mesh, param_specs(
            {"blocks": stack}, cfg, mesh_sizes(mesh))))["blocks"]
        lp = {n: v[0] for n, v in stack.items()}
        x = bs.distribute(torch.as_tensor(a["x"]))
        for mode in ("sf", "dense"):
            y, aux = _on_mesh(mesh, lambda: M.moe_layer(x, lp, cfg,
                                                        dispatch=mode))
            out[key(tag, arch, "moe_layer", mode)] = y.full_tensor().numpy()
            out[key(tag, arch, "moe_aux", mode)] = \
                aux.full_tensor().numpy()


def serve_tokens(cfg):
    """The prompt (B, S) of :func:`_serve_on_mesh`, from a seed."""
    B, S = SERVE[0], SERVE[1]
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, S))


def _serve_on_mesh(cfg, params, mesh, tag: str, out: dict) -> None:
    """Prefill and greedy decode steps on the mesh (the parameters after
    the steps), every logit row whole, and the cache's layout."""
    import torch
    from repro_torch.launch.cells import _on_mesh
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import NamedSharding, batch_spec
    bs = NamedSharding(mesh, batch_spec(mesh_sizes(mesh)))
    toks = torch.as_tensor(serve_tokens(cfg))
    logits, cache = _on_mesh(mesh, lambda: T.prefill(
        params, cfg, tokens=bs.distribute(toks), s_max=SERVE[2]))
    out[key(tag, "serve", 0)] = logits.full_tensor().numpy()
    out[key(tag, "cache_placements")] = np.array(str(cache["k"].placements))
    nxt = logits.full_tensor().argmax(-1)
    for i in range(1, SERVE[3]):
        logits, cache = _on_mesh(mesh, lambda: T.decode_step(
            params, cfg, bs.distribute(nxt), cache))
        out[key(tag, "serve", i)] = logits.full_tensor().numpy()
        nxt = logits.full_tensor().argmax(-1)


def _named(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _named(tree[k], f"{prefix}/{k}" if prefix else k, out)
    else:
        out[prefix] = tree


def mesh_main(rank: int, world: int, store: str, ckpt_in: str,
              out_dir: str) -> None:
    """One rank of the sharded-step case: join the gloo group, run
    :func:`_mesh_run`, write ``mesh_rank<r>.npz`` (a traceback to
    ``mesh_rank<r>.err`` on failure)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
        try:
            out = {}
            _mesh_run(rank, world, ckpt_in, out_dir, out)
            np.savez(os.path.join(out_dir, f"mesh_rank{rank}.npz"), **out)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"mesh_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
