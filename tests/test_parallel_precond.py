"""Sharded preconditioning beyond Jacobi (VERDICT r1 item 4): Chebyshev
under shard_map must (a) agree with the serial solve to 1e-8 and (b) reduce
CG iteration counts vs Jacobi.  Reference: OperatorChebyshevSmoother
(linalg/solvers.hpp:502) used in parallel contexts."""

import jax.numpy as jnp
import numpy as np

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.linalg import ode
from cardiac_ablation_ecm2.mesh import make_cartesian_3d
from cardiac_ablation_ecm2.models import bioheat as sbio
from cardiac_ablation_ecm2.models import poisson as spoisson
from cardiac_ablation_ecm2.parallel import bioheat as pbio
from cardiac_ablation_ecm2.parallel import poisson as ppoisson


def test_sharded_poisson_chebyshev():
    mesh = make_cartesian_3d(6, 6, 6)
    res = spoisson.solve(mesh, order=2, rel_tol=1e-12)
    it = {}
    for prec in ("jacobi", "chebyshev"):
        solver = ppoisson.setup(mesh, order=2, ndev=8, rel_tol=1e-12,
                                precond=prec)
        u, iters, _ = solver.solve()
        assert np.abs(u - np.asarray(res.u)).max() < 1e-9
        it[prec] = iters
    assert it["chebyshev"] < it["jacobi"], it


def test_sharded_bioheat_chebyshev_matches_serial():
    L = 0.02
    mesh = make_cartesian_3d(4, 4, 2, L, L, L)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 5e5 * jnp.exp(-r2 / (L / 4) ** 2)

    fes = FESpace(mesh, 2)
    op = sbio.BioheatOperator(
        fes=fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, q_met=src,
        ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-10,
    )
    solver = ode.select("sdirk33")
    T, t = jnp.full(fes.ndof, 37.0), 0.0
    for _ in range(2):
        T, t = solver.step(op, T, t, 0.5)

    sim = pbio.setup(
        mesh, order=2, ndev=8, q_src=src, ess_bdr=[1, 2, 3, 4, 5, 6],
        solver="sdirk33", rel_tol=1e-10, max_iter=300, precond="chebyshev",
    )
    Tl, tt = sim.T0, 0.0
    for _ in range(2):
        Tl, tt = sim.step(Tl, tt, 0.5)
    Tg = sim.gather(Tl)[: fes.ndof]
    assert np.abs(Tg - np.asarray(T)).max() < 1e-8


def test_sharded_poisson_pmg_vcycle():
    """p-MG V-cycle under shard_map (VERDICT r1 item 4 'with a V-cycle'):
    must agree with serial and beat Chebyshev's iteration count."""
    mesh = make_cartesian_3d(6, 6, 6)
    res = spoisson.solve(mesh, order=2, rel_tol=1e-12)
    it = {}
    for prec in ("chebyshev", "pmg"):
        solver = ppoisson.setup(mesh, order=2, ndev=8, rel_tol=1e-12,
                                precond=prec)
        u, iters, _ = solver.solve()
        assert np.abs(u - np.asarray(res.u)).max() < 1e-9
        it[prec] = iters
    assert it["pmg"] < it["chebyshev"], it


def test_sharded_poisson_pmg_three_level_order4():
    mesh = make_cartesian_3d(3, 3, 3)
    res = spoisson.solve(mesh, order=4, rel_tol=1e-12)
    solver = ppoisson.setup(mesh, order=4, ndev=8, rel_tol=1e-12,
                            precond="pmg", pmg_orders=[1, 2])
    u, iters, _ = solver.solve()
    assert np.abs(u - np.asarray(res.u)).max() < 1e-9
    jac = ppoisson.setup(mesh, order=4, ndev=8, rel_tol=1e-12)
    _, jit_iters, _ = jac.solve()
    assert iters < jit_iters


def test_sharded_bioheat_pmg_matches_serial():
    L = 0.02
    mesh = make_cartesian_3d(4, 4, 4, L, L, L)

    def src(x):
        r2 = sum((x[..., i] - L / 2) ** 2 for i in range(3))
        return 5e5 * jnp.exp(-r2 / (L / 4) ** 2)

    fes = FESpace(mesh, 2)
    op = sbio.BioheatOperator(
        fes=fes, rho_c=3.6e6, k=0.54, w_cb=2e4, T_a=37.0, q_met=src,
        ess_bdr=[1, 2, 3, 4, 5, 6], rel_tol=1e-10,
    )
    solver = ode.select("sdirk33")
    T, t = jnp.full(fes.ndof, 37.0), 0.0
    for _ in range(2):
        T, t = solver.step(op, T, t, 0.5)

    sim = pbio.setup(
        mesh, order=2, ndev=8, q_src=src, ess_bdr=[1, 2, 3, 4, 5, 6],
        solver="sdirk33", rel_tol=1e-10, max_iter=300, precond="pmg",
    )
    Tl, tt = sim.T0, 0.0
    for _ in range(2):
        Tl, tt = sim.step(Tl, tt, 0.5)
    Tg = sim.gather(Tl)[: fes.ndof]
    assert np.abs(Tg - np.asarray(T)).max() < 1e-8


def test_sharded_poisson_lor_vcycle():
    """Device LOR-MG under shard_map (VERDICT r2 missing #1): batched LOR
    assembly feeding the in-shard V-cycle; correct solution + iteration
    counts competitive with p-MG.  Reference: fem/lor/lor_batched.hpp:34."""
    mesh = make_cartesian_3d(6, 6, 6)
    res = spoisson.solve(mesh, order=3, rel_tol=1e-12)
    it = {}
    for prec in ("jacobi", "lor"):
        solver = ppoisson.setup(mesh, order=3, ndev=8, rel_tol=1e-12,
                                precond=prec)
        u, iters, _ = solver.solve()
        assert np.abs(u - np.asarray(res.u)).max() < 1e-9
        it[prec] = iters
    # at this small mesh Jacobi hasn't hit its h-growth yet; LOR-MG must
    # still clearly win (the h-robustness itself is asserted serially in
    # test_lor_device.py on a refinement sweep)
    assert it["lor"] < 0.8 * it["jacobi"], it


def test_sharded_lor_matches_serial_lor_mg():
    """Serial make_lor_multigrid and the in-shard LOR V-cycle precondition
    the same system to the same iteration count (same math, 8 devices)."""
    from cardiac_ablation_ecm2.linalg.solvers import cg
    from cardiac_ablation_ecm2.ops import BilinearForm
    from cardiac_ablation_ecm2.ops.linearform import domain_lf
    from cardiac_ablation_ecm2.ops.lor_device import make_lor_multigrid

    mesh = make_cartesian_3d(5, 5, 5)
    fes = FESpace(mesh, 2)
    A = BilinearForm(fes).add_domain_integrator("diffusion").assemble()
    ess = fes.essential_dofs(None)
    mask = jnp.zeros(fes.ndof_scalar).at[jnp.asarray(ess)].set(1.0)

    def Aop(x):
        z = x * (1 - mask)
        return A.mult(z) * (1 - mask) + x * mask

    b = domain_lf(fes, lambda x: jnp.ones(x.shape[:-1])) * (1 - mask)
    mg = make_lor_multigrid(fes, 1.0, ess_bdr=None)
    Mmg = mg.preconditioner()
    x_s, info = cg(Aop, b, M=lambda r: Mmg(r * (1 - mask)) * (1 - mask)
                   + r * mask, rel_tol=1e-12, max_iter=500)

    solver = ppoisson.setup(mesh, order=2, ndev=8, rel_tol=1e-12,
                            precond="lor")
    u, iters, _ = solver.solve()
    assert np.abs(u - np.asarray(x_s)).max() < 1e-9
    # same preconditioner family: iteration counts within a few of each other
    assert abs(iters - int(info.iterations)) <= 5, (iters, int(info.iterations))
