"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Each kernel module (``sf_pack``, ``sf_unpack``, ``spmv_ell``,
``flash_attention``) holds the wrappers of one ``csrc/*.cu`` source, their
plain PyTorch versions and the launch counters; ``ops`` routes the SF hot
path onto them and carries the models' ``flash_attention`` (with its
autograd Function when a gradient is asked for); ``ref``
keeps the reference's oracle names; ``_build`` compiles and loads the
sources.
The kernel modules are imported as modules (``from repro_torch.kernels
import sf_pack``); nothing is compiled until a CUDA tensor reaches a
wrapper.
"""

from . import flash_attention, ops, ref, sf_pack, sf_unpack, spmv_ell

__all__ = ["flash_attention", "ops", "ref", "sf_pack", "sf_unpack",
           "spmv_ell"]
