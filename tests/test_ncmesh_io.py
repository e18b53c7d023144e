""""MFEM NC mesh v1.0" reader (mesh/ncmesh.cpp Print/Load; dispatch
mesh/mesh.cpp:4964): leaf counts/volumes validated against libmfem."""

import jax.numpy as jnp
import numpy as np
import pytest

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import geom_factors_for
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh

DATA = "/root/reference/data"

# goldens from libmfem (tools/mfem_probe.cpp)
GOLDEN = {
    "amr-quad": (28, 16, 41, 1.0),
    "fichera-amr": (522, 300, 871, 7.0),
    "amr-hex": (120, 96, 223, 1.0),
    "beam-quad-amr": (17, 25, 32, 8.0),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_ncmesh_leaf_stats(name):
    ne, nbe, nv, vol = GOLDEN[name]
    m = read_mfem_mesh(f"{DATA}/{name}.mesh")     # header dispatch
    assert (m.ne, m.nbe, m.nv) == (ne, nbe, nv)
    gf = geom_factors_for(FESpace(m, 1))
    assert abs(float(jnp.sum(gf.wdet)) - vol) < 1e-10
    assert float(jnp.min(gf.det)) > 0


def test_ncmesh_solve_amr_quad():
    """Conforming NC solve end-to-end on the loaded iso-refined quad mesh."""
    from cardiac_ablation_ecm2.fem.ncfespace import NCFESpace
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.mesh.ncmesh import make_nc
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf

    m = read_mfem_mesh(f"{DATA}/amr-quad.mesh")
    nc = make_nc(m)
    assert nc.n_hanging > 0                        # genuinely nonconforming
    sp = NCFESpace(nc, 2)
    fes = sp.fes
    A_L = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = jnp.asarray(sp.essential_dofs())
    bL = domain_lf(fes, lambda x: np.ones(np.asarray(x).shape[:-1]))

    def AC(x):
        z = x.at[ess].set(0.0)
        y = sp.restrict_t(A_L.mult(sp.prolongate(z)))
        return y.at[ess].set(x[ess])

    b = sp.restrict_t(bL).at[ess].set(0.0)
    x, info = cg(AC, b, rel_tol=1e-10, max_iter=2000)
    assert bool(info.converged)
    u = sp.prolongate(x)
    assert float(jnp.max(u)) > 0
