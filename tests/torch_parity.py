"""Helpers for the ``test_torch_*`` parity suites: carry reference objects
(``repro``, JAX) across to the port (``repro_torch``) as numpy arrays, the
only currency the two packages share."""

import numpy as np
import torch

from repro_torch.convert import parcsr_from_arrays, star_forest_from_arrays

CPU = torch.device("cpu")


def port_sf(ref_sf):
    """The port's StarForest with the reference SF's rank graphs."""
    return star_forest_from_arrays(ref_sf.nranks, [
        {"nroots": g.nroots, "nleafspace": g.nleafspace, "local": g.local,
         "remote_rank": g.remote_rank, "remote_offset": g.remote_offset}
        for g in (ref_sf.graph(r) for r in range(ref_sf.nranks))])


def _block(c):
    return (c.shape, c.indptr, c.indices, c.data)


def port_parcsr(ref, dtype=np.float32):
    """The port's ParCSR (on the CPU) with the reference ParCSR's blocks."""
    return parcsr_from_arrays(ref.nranks, ref.row_offsets, ref.col_offsets,
                              [_block(c) for c in ref.diag],
                              [_block(c) for c in ref.offd],
                              list(ref.garray), dtype=dtype, device="cpu")


def t(a):
    """numpy -> CPU tensor (copy, so the reference's array stays its own)."""
    return torch.as_tensor(np.array(a))


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)
