"""Shared example-driver utilities.

Reference analog: ``OptionsParser`` (``general/optparser.hpp:31``) and the
``-m/-o/-r`` flag conventions every reference example uses; here argparse
with the same spellings, plus mesh loading that accepts reference ``.mesh``
files and ``inline-*`` generators.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def standard_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument(
        "-m", "--mesh", default=None,
        help=".mesh file or inline spec (inline-{quad,tri,hex,tet,pyramid,"
             "wedge}-N; NOTE: inline-wedge lists only the four quad side "
             "walls as boundary — the z=0/z=1 triangular faces are "
             "natural/Neumann until mixed-shape boundary arrays land)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--refine", type=int, default=0,
                    help="uniform refinement levels")
    ap.add_argument("--cpu", action="store_true", help="force CPU platform")
    ap.add_argument("--x64", action="store_true", help="enable float64")
    ap.add_argument("--vtu", default=None, help="write VTU output file")
    return ap


def setup_jax(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    # persistent XLA executable cache: repeat example runs skip recompiles
    # of unchanged steps
    from cardiac_ablation_ecm2.utils.config import enable_compilation_cache

    enable_compilation_cache()


def load_mesh(args, default="inline-quad-8"):
    from cardiac_ablation_ecm2.io.mesh_io import read_mfem_mesh
    from cardiac_ablation_ecm2.mesh import (
        make_cartesian_2d,
        make_cartesian_2d_tri,
        make_cartesian_3d,
        make_cartesian_3d_prism,
        make_cartesian_3d_pyramid,
        make_cartesian_3d_tet,
    )

    spec = args.mesh or default
    if os.path.exists(spec):
        mesh = read_mfem_mesh(spec)
    elif spec.startswith("inline-"):
        parts = spec.split("-")
        kind = parts[1]
        n = int(parts[2]) if len(parts) > 2 else 8
        mesh = {
            "quad": lambda: make_cartesian_2d(n, n),
            "tri": lambda: make_cartesian_2d_tri(n, n),
            "hex": lambda: make_cartesian_3d(n, n, n),
            "tet": lambda: make_cartesian_3d_tet(n, n, n),
            "pyramid": lambda: make_cartesian_3d_pyramid(n, n, n),
            "wedge": lambda: make_cartesian_3d_prism(n, n, n),
        }[kind]()
    else:
        raise SystemExit(f"mesh not found: {spec}")
    if args.refine:
        mesh = mesh.uniform_refinement(args.refine)
    return mesh


def maybe_vtu(args, mesh, fes, u, name="u"):
    if args.vtu:
        from cardiac_ablation_ecm2.io.vtu import vertex_values, write_vtu

        write_vtu(mesh, args.vtu, point_data={name: vertex_values(fes, u)})
        print(f"wrote {args.vtu}")
