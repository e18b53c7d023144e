"""Exodus II / Cubit reader+writer (mesh_readers.cpp:3722 ReadCubit analog):
round-trip of connectivity, coordinates, and side-set boundaries."""

import numpy as np
import pytest
import jax.numpy as jnp

from cardiac_ablation_ecm2.fem import FESpace
from cardiac_ablation_ecm2.fem.build import geom_factors_for
from cardiac_ablation_ecm2.io.exodus import read_exodus, write_exodus
from cardiac_ablation_ecm2.mesh import (
    make_cartesian_2d,
    make_cartesian_2d_tri,
    make_cartesian_3d,
    make_cartesian_3d_tet,
)


def _bset(m):
    return {(tuple(sorted(map(int, r))), int(a))
            for r, a in zip(m.boundary, m.bdr_attributes)}


@pytest.mark.parametrize("maker", [
    make_cartesian_2d, make_cartesian_2d_tri,
    make_cartesian_3d, make_cartesian_3d_tet,
])
def test_exodus_roundtrip(tmp_path, maker):
    m = maker(3, 3) if maker.__name__.endswith("2d") or \
        maker.__name__.endswith("2d_tri") else maker(3, 3, 2)
    path = str(tmp_path / "mesh.e")
    write_exodus(m, path)
    m2 = read_exodus(path)
    assert (m2.ne, m2.nv, m2.geom) == (m.ne, m.nv, m.geom)
    assert np.allclose(m2.vertices, m.vertices)
    assert _bset(m2) == _bset(m)
    gf1 = geom_factors_for(FESpace(m, 1))
    gf2 = geom_factors_for(FESpace(m2, 1))
    assert abs(float(jnp.sum(gf1.wdet)) - float(jnp.sum(gf2.wdet))) < 1e-12


def test_exodus_solve(tmp_path):
    from cardiac_ablation_ecm2.models import poisson

    m = make_cartesian_3d(3, 3, 3)
    path = str(tmp_path / "m.e")
    write_exodus(m, path)
    res = poisson.solve(read_exodus(path), order=2, rel_tol=1e-10)
    assert res.converged
