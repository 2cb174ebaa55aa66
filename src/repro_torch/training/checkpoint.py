"""Checkpoint/restart in the reference's on-disk format (the port of
``repro/training/checkpoint.py``).

Format: one directory per step containing

  manifest.json   — leaf names, shapes, dtypes, step and the caller's extra
                    state (``{"step", "leaves", "extra"}``)
  <leaf-path>.bin — raw little-endian bytes per leaf; bfloat16 leaves as
                    their raw 16 bits

A checkpoint that either package writes loads in the other bit for bit.
Leaves are whole tensors, so a checkpoint is independent of any device
count or mesh: a DTensor leaf (training on a device mesh) is gathered
whole and written by rank 0 alone, and ``load_checkpoint(...,
shardings=)`` places each leaf in a layout on restore, so a checkpoint
saved at world 1 restores under a (2, 2) mesh and the reverse (the
elastic restore).
Atomicity: writes go to ``<dir>.tmp``, then a rename — a crash mid-write
never corrupts the latest complete checkpoint.  ``latest_step`` scans for
the newest complete manifest.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.meshed import is_dtensor, whole

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]

# a torch dtype -> (the manifest's dtype name, the numpy dtype of its bits)
_FORMATS = {torch.bfloat16: ("bfloat16", np.uint16)}


def _flatten(tree, prefix="", out=None):
    out = out if out is not None else {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}/{i}")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix]


def _host_bytes(leaf) -> Tuple[np.ndarray, str]:
    """(a little-endian numpy array of the leaf's bits, its dtype name)."""
    leaf = whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _FORMATS:
            name, bits = _FORMATS[t.dtype]
            return t.view(torch.int16).numpy().view(bits), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    return arr.astype(arr.dtype.newbyteorder("<")), name


def _from_bytes(raw: bytes, meta: Dict, device) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint16)
        t = torch.from_numpy(bits.reshape(meta["shape"]).copy()) \
            .view(torch.bfloat16)
    else:
        dt = np.dtype(meta["dtype"]).newbyteorder("<")
        arr = np.frombuffer(raw, dtype=dt).astype(dt.newbyteorder("="))
        t = torch.from_numpy(arr.reshape(meta["shape"]).copy())
    return t.to(device)


def save_checkpoint(path: str, step: int, tree: Dict,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` (nested dicts / lists of tensors or arrays)
    atomically under ``path/step_XXXXXXXX``."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    flat = _flatten(tree)
    sharded = any(is_dtensor(v) for v in flat.values())
    writer = not sharded or torch.distributed.get_rank() == 0
    if writer:
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in flat.items():
        arr, dtype = _host_bytes(leaf)      # a collective for a DTensor
        if not writer:
            continue
        fn = name.replace("/", "__") + ".bin"
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(arr.tobytes())
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if sharded:
        torch.distributed.barrier()     # every rank sees the new step
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(path, d, "manifest.json")):
            steps.append(int(d[len("step_"):]))
    return max(steps) if steps else None


def load_checkpoint(path: str, step: int, template: Dict, *,
                    device=None, shardings=None) -> Tuple[Dict, Dict]:
    """Load into the structure of ``template``.  Each leaf goes to
    ``device`` when given, else to the device of the template's leaf of
    the same name (the CPU where that is no tensor).  ``shardings`` (a
    ``models.sharding.NamedSharding`` tree mirroring ``template``, the
    reference's argument) places each whole leaf on its mesh
    (``models.sharding.place``).  Returns (tree, the saved ``extra``)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _flatten(template)
    out = {}
    for name, meta in manifest["leaves"].items():
        with open(os.path.join(d, meta["file"]), "rb") as f:
            raw = f.read()
        like = flat_t.get(name)
        if is_dtensor(like):
            like = like.to_local()
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out[name] = _from_bytes(raw, meta, dev)
    tree = _unflatten_into(template, out)
    if shardings is not None:
        from ..models.sharding import place
        tree = place(tree, shardings)
    return tree, manifest["extra"]


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; orchestrates save/restore."""

    def __init__(self, path: str, keep: int = 3, every: int = 100):
        self.path = path
        self.keep = keep
        self.every = every
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, tree: Dict, extra=None) -> Optional[str]:
        if step % self.every:
            return None
        out = save_checkpoint(self.path, step, tree, extra)
        self._gc()
        return out

    def _gc(self):
        steps = sorted(
            int(d[len("step_"):]) for d in os.listdir(self.path)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template, *, device=None, shardings=None):
        s = latest_step(self.path)
        if s is None:
            return None, None, None
        tree, extra = load_checkpoint(self.path, s, template, device=device,
                                      shardings=shardings)
        return s, tree, extra
