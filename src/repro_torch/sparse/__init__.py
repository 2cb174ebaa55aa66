"""repro_torch.sparse — local CSR/ELL blocks and the SF-distributed
``ParCSR`` matrix (paper §4.1)."""

from .csr import LocalCSR, csr_from_coo, csr_transpose
from .parmat import ParCSR

__all__ = ["LocalCSR", "csr_from_coo", "csr_transpose", "ParCSR"]
