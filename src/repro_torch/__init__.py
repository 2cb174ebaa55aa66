"""repro_torch — the PetscSF star-forest layer in PyTorch with hand-written
CUDA kernels for Hopper, ported from the JAX package ``repro``.

Layout mirrors the reference: ``core/`` (graph, plans, backends, the
``SFComm`` facade), ``kernels/`` (CUDA kernels, their plain versions and
wrappers), ``sparse/`` (``ParCSR`` and its SF-driven SpMV), ``solvers/``
(CG).  ``convert`` reads reference state handed over as numpy arrays.
Entry points run on the current CUDA device unless ``device="cpu"`` is
passed.  This package imports torch and numpy, never jax or ``repro``.
"""
