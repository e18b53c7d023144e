"""Maxwell cavity eigenvalues (HypreAME analog, linalg/hypre.hpp:2295):
LOBPCG + algebraic gradient projection on ND spaces."""

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fespace import FESpace
from cardiac_ablation_ecm2.fem.fe_vector_ho import NDSpaceHO
from cardiac_ablation_ecm2.linalg.maxwell_eigen import maxwell_eigenvalues
from cardiac_ablation_ecm2.mesh.mesh import (
    make_cartesian_2d,
    make_cartesian_3d,
)

PI2 = np.pi ** 2


def test_2d_cavity_modes():
    """[0,1]² PEC cavity: λ = π²(m²+n²); lowest = π², π², 2π² — and no
    spurious (gradient) near-zero modes."""
    mesh = make_cartesian_2d(4, 4)
    nd = NDSpaceHO(mesh, 2)
    h1 = FESpace(mesh, 2)
    res = maxwell_eigenvalues(nd, h1, k=3, iters=60)
    lam = res.eigenvalues
    exact = np.array([1.0, 1.0, 2.0]) * PI2
    assert np.all(lam > 1.0), lam           # gradients projected out
    assert np.allclose(lam, exact, rtol=2e-3), (lam, exact)


def test_3d_cavity_lowest_mode():
    """[0,1]³ PEC cavity: lowest Maxwell eigenvalue 2π², multiplicity 3."""
    mesh = make_cartesian_3d(3, 3, 3)
    nd = NDSpaceHO(mesh, 1)
    h1 = FESpace(mesh, 1)
    res = maxwell_eigenvalues(nd, h1, k=3, iters=50)
    lam = res.eigenvalues
    assert np.all(lam > 1.0), lam
    # ND order-1 on a 3³ mesh converges from above with ~9% discretization
    # error (O(h²)); the sharp checks are multiplicity and no zero modes
    assert np.allclose(lam, 2 * PI2, rtol=0.12), lam
    # multiplicity 3: the three values agree with each other tightly
    assert lam.max() - lam.min() < 0.02 * lam.mean(), lam


def test_anisotropic_pencil_matches_dense():
    """ex32p: (curl E, curl F) = λ(σE, F) with full matrix σ — the σ-
    weighted projector removes gradients and the spectrum matches a dense
    generalized eigensolve on the PEC-restricted pencil."""
    from scipy.linalg import eigh

    from cardiac_ablation_ecm2.ops.vecfe import build_nd_operator

    sig = np.array([[2.0, 0.4], [0.4, 1.0]])
    mesh = make_cartesian_2d(4, 4)
    nd = NDSpaceHO(mesh, 2)
    h1 = FESpace(mesh, 2)
    res = maxwell_eigenvalues(nd, h1, k=3, iters=80, sigma=sig)
    A = build_nd_operator(nd, curlcurl_coeff=1.0, mass_coeff=None,
                          nq1d=4).assemble_matrix().toarray()
    M = build_nd_operator(nd, mass_coeff=sig, curlcurl_coeff=None,
                          nq1d=4).assemble_matrix().toarray()
    ess = nd.essential_dofs(sorted(set(mesh.bdr_attributes.tolist())))
    keep = np.setdiff1d(np.arange(nd.ndof), ess)
    lam = eigh(A[np.ix_(keep, keep)], M[np.ix_(keep, keep)],
               eigvals_only=True)
    lam_nz = lam[lam > 1e-8][:3]
    assert np.allclose(res.eigenvalues, lam_nz, rtol=1e-4)
