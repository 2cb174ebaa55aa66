"""Device meshes (the port of ``repro/launch/mesh.py``).

Single pod:  (16, 16)      axes (data, model)        = 256 ranks
Multi-pod:   (2, 16, 16)   axes (pod, data, model)   = 512 ranks

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions over the live default process group: NCCL on the card (one H100
gives world 1), gloo on the CPU, or the ``fake`` group of the dry run
(``launch/dryrun.py``), which stands in for 256 or 512 ranks in one
process.  Building a mesh never initialises a process group: the caller (a
``torchrun`` rank, a test, the dry run's child) has done that.

:func:`use_mesh` makes a mesh ambient for ``models.sharding.constrain``,
as the reference's ``use_mesh`` sets GSPMD's.  The reference's
``make_mesh_compat`` and ``normalize_cost_analysis`` paper over jax
versions and have no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

__all__ = ["make_mesh", "make_production_mesh", "make_small_mesh",
           "use_mesh", "current_mesh", "mesh_sizes", "HW"]

_AMBIENT = []          # the stack of meshes made ambient by use_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world size must be the product of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torchrun, or init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_small_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cuda"):
    """A reduced mesh (tests: gloo ranks or a small fake group)."""
    return make_mesh(shape, axes, device_type=device_type)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order: the ``Mesh`` mapping that
    ``models.sharding``'s spec rules read."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Within the block ``mesh`` is ambient (``None``: no mesh)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[object]:
    """The innermost ambient mesh, or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


class HW:
    """NVIDIA H100 80GB HBM3 at a 700.00 W power limit (the SXM part's data
    sheet, dense rates): the roofline's constants."""
    PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores, per card
    HBM_BW = 3.35e12                # bytes/s per card
    LINK_BW = 450e9                 # NVLink, bytes/s each way per card

    @staticmethod
    def hbm_bytes() -> float:
        """The card's memory as ``torch.cuda`` reports it, or 80e9 where
        there is no card."""
        import torch
        if torch.cuda.is_available():
            return float(torch.cuda.get_device_properties(0).total_memory)
        return 80e9
