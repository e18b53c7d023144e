"""Cut-cell quadrature on implicit domains (ex38 / fem/intrules_cut.hpp).

Reproduces ex38's analytic checks: circle/ellipse/sphere/ellipsoid level
sets, surface and volume integrals against closed forms."""

import numpy as np

from cardiac_ablation_ecm2.fem.cutcells import (cut_surface_rule,
                                                    cut_volume_rule,
                                                    integrate)
from cardiac_ablation_ecm2.mesh import (Mesh, make_cartesian_2d,
                                            make_cartesian_3d)


def _centered(mesh, size):
    V = mesh.vertices - size / 2.0
    return Mesh(geom=mesh.geom, vertices=V, elements=mesh.elements,
                attributes=mesh.attributes, boundary=mesh.boundary,
                bdr_attributes=mesh.bdr_attributes)


def test_surface2d_circle():
    """ex38 -i surface2d: φ = 1 − x² − y², ∫_{φ=0} (3x² − y²) dS = 2π."""
    mesh = _centered(make_cartesian_2d(8, 8, 4.0, 4.0), 4.0)
    pts, wts = cut_surface_rule(mesh, lambda x: 1.0 - (x[..., 0] ** 2 +
                                                       x[..., 1] ** 2),
                                order=6)
    perim = integrate(pts, wts, lambda x: np.ones(x.shape[:-1]))
    assert abs(perim - 2 * np.pi) < 1e-6, perim
    val = integrate(pts, wts,
                    lambda x: 3 * x[..., 0] ** 2 - x[..., 1] ** 2)
    assert abs(val - 2 * np.pi) < 1e-5, val


def test_volumetric2d_ellipse():
    """ex38 -i volumetric2d: φ = 1 − (x/1.5)² − (y/.75)²;
    area = 9π/8, perimeter = 7.26633616541076."""
    phi = lambda x: 1.0 - ((x[..., 0] / 1.5) ** 2 + (x[..., 1] / .75) ** 2)
    mesh = _centered(make_cartesian_2d(10, 10, 4.0, 4.0), 4.0)
    pts, wts = cut_volume_rule(mesh, phi, order=6)
    area = integrate(pts, wts, lambda x: np.ones(x.shape[:-1]))
    assert abs(area - 9 * np.pi / 8) < 1e-7, area
    spts, swts = cut_surface_rule(mesh, phi, order=6)
    perim = integrate(spts, swts, lambda x: np.ones(x.shape[:-1]))
    assert abs(perim - 7.26633616541076) < 1e-5, perim


def test_surface3d_sphere():
    """ex38 -i surface3d: unit sphere, ∫ (4 − 3x² + 2y² − z²) dS = 40π/3."""
    phi = lambda x: 1.0 - (x ** 2).sum(axis=-1)
    mesh = _centered(make_cartesian_3d(5, 5, 5, 3.0, 3.0, 3.0), 3.0)
    pts, wts = cut_surface_rule(mesh, phi, order=5, depth=6)
    sarea = integrate(pts, wts, lambda x: np.ones(x.shape[:-1]))
    assert abs(sarea - 4 * np.pi) < 2e-4 * 4 * np.pi, sarea
    val = integrate(pts, wts, lambda x: 4 - 3 * x[..., 0] ** 2 +
                    2 * x[..., 1] ** 2 - x[..., 2] ** 2)
    # depth-limited quadtree floor: ~5e-5 relative at depth 6
    assert abs(val - 40 * np.pi / 3) < 5e-3, val


def test_volumetric3d_ellipsoid():
    """ex38 -i volumetric3d: (x/1.5)² + (y/.75)² + (z/.5)² < 1;
    volume = 4π/3 · 1.5 · .75 · .5 = 3π/4."""
    phi = lambda x: 1.0 - ((x[..., 0] / 1.5) ** 2 + (x[..., 1] / .75) ** 2 +
                           (x[..., 2] / .5) ** 2)
    mesh = make_cartesian_3d(8, 6, 4, 4.0, 2.0, 1.5)
    V = mesh.vertices.copy()
    V[:, 0] -= 2.0
    V[:, 1] -= 1.0
    V[:, 2] -= 0.75
    mesh = Mesh(geom=mesh.geom, vertices=V, elements=mesh.elements,
                attributes=mesh.attributes, boundary=mesh.boundary,
                bdr_attributes=mesh.bdr_attributes)
    pts, wts = cut_volume_rule(mesh, phi, order=5)
    vol = integrate(pts, wts, lambda x: np.ones(x.shape[:-1]))
    assert abs(vol - 0.75 * np.pi) < 2e-3, vol


def test_volume_rule_converges():
    """Order refinement improves the cut-volume integral (circle area)."""
    phi = lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)
    mesh = _centered(make_cartesian_2d(6, 6, 4.0, 4.0), 4.0)
    errs = []
    for order in (2, 6):
        pts, wts = cut_volume_rule(mesh, phi, order=order)
        area = integrate(pts, wts, lambda x: np.ones(x.shape[:-1]))
        errs.append(abs(area - np.pi))
    assert errs[1] < errs[0] * 0.1, errs


def test_inside_negative_complements():
    """φ<0 and φ>0 volumes sum to the box volume."""
    phi = lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)
    mesh = _centered(make_cartesian_2d(6, 6, 4.0, 4.0), 4.0)
    _, wp = cut_volume_rule(mesh, phi, order=5, inside="positive")
    _, wn = cut_volume_rule(mesh, phi, order=5, inside="negative")
    assert abs(float(wp.sum() + wn.sum()) - 16.0) < 1e-9


def test_cut_linear_form_exact_moments():
    """b_j = ∫_{φ>0} f φ_j reproduces exact integrals of interpolated
    fields: 1·b = area, u_I(g)·b = ∫ g for linear g (the cut linear forms
    of ex38)."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.cutcells import cut_linear_form

    phi = lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)
    mesh = _centered(make_cartesian_2d(8, 8, 4.0, 4.0), 4.0)
    fes = FESpace(mesh, 2)
    pts, wts = cut_volume_rule(mesh, phi, order=6)
    b = cut_linear_form(fes, pts, wts)
    assert abs(float(b.sum()) - np.pi) < 1e-7            # partition of unity
    X = np.asarray(fes.dof_coords)
    g = jnp.asarray(2.0 + 3.0 * X[:, 0] - 1.0 * X[:, 1])  # linear field
    # odd moments over the centered disk vanish: ∫ g = 2·area
    assert abs(float(g @ b) - 2 * np.pi) < 1e-7
    # weighted f: ∫_{φ>0} x² = π/4 for the unit disk
    bx2 = cut_linear_form(fes, pts, wts, fn=lambda x: x[..., 0] ** 2)
    assert abs(float(bx2.sum()) - np.pi / 4) < 1e-7


def test_cut_surface_linear_form():
    """Surface version: Σ_j b_j = perimeter; linear moments vanish."""
    import jax.numpy as jnp

    from cardiac_ablation_ecm2.fem import FESpace
    from cardiac_ablation_ecm2.fem.cutcells import cut_linear_form

    phi = lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)
    mesh = _centered(make_cartesian_2d(8, 8, 4.0, 4.0), 4.0)
    fes = FESpace(mesh, 1)
    pts, wts = cut_surface_rule(mesh, phi, order=6)
    b = cut_linear_form(fes, pts, wts)
    assert abs(float(b.sum()) - 2 * np.pi) < 1e-6
    X = np.asarray(fes.dof_coords)
    g = jnp.asarray(X[:, 0] + X[:, 1])
    assert abs(float(jnp.asarray(g) @ b)) < 1e-6
