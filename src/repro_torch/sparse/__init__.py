"""repro_torch.sparse — local CSR/ELL blocks and the SF-distributed
``ParCSR`` matrix (paper §4.1): split-phase SpMV, SpMM/PtAP, and
stash-based parallel assembly (paper §6.4)."""

from .csr import LocalCSR, csr_from_coo, csr_transpose, spgemm
from .parmat import MatAssembler, ParCSR, Sparsity, assemble_coo

__all__ = [
    "LocalCSR",
    "MatAssembler",
    "ParCSR",
    "Sparsity",
    "assemble_coo",
    "csr_from_coo",
    "csr_transpose",
    "spgemm",
]
