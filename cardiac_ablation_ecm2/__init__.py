"""Array-first finite element framework on JAX (MFEM-capability rebuild).

A from-scratch JAX/XLA re-design of the capabilities of
``lmolin3/Cardiac-Ablation-ECM2`` (= MFEM 4.9.1-dev): element-batched meshes,
matrix-free partial-assembly operators as batched matmuls, matrix-free
Krylov solvers, SDIRK/IMEX time integration, and mesh-partition sharding with
halo exchange between devices — aimed at cardiac RF-ablation simulation (Pennes bioheat + RF
Laplace).  See SURVEY.md for the blueprint and reference citations.
"""

__version__ = "0.1.0"

from . import fem, linalg, mesh, models, ops, parallel, utils  # noqa: F401
