"""Checkpoint / restart: the DataCollection subsystem.

Reference analog: ``DataCollection`` (``fem/datacollection.hpp:128``) — a
named field registry with cycle/time metadata and ``Save/Load`` for restart
(``datacollection.hpp:321-376``); the restart pattern of
``miniapps/electromagnetics/joule.cpp:563-575``.

Design: one directory per collection; each ``save(cycle)`` writes
``cycle_NNNNNN.npz`` holding every registered field (device arrays pulled to
host) plus json metadata (time, dt, cycle, field→space info).  A VTU is
optionally emitted per cycle for visualization (ParaViewDataCollection role).
Orbax is deliberately not required — fields are plain dense arrays and npz is
sufficient and dependency-free; swap-in is trivial if sharded async
checkpointing is needed later.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class DataCollection:
    """Named field registry with save/load (fem/datacollection.hpp:128)."""

    path: str
    mesh: object = None
    fes_map: Dict[str, object] = dataclasses.field(default_factory=dict)
    fields: Dict[str, object] = dataclasses.field(default_factory=dict)
    time: float = 0.0
    dt: float = 0.0
    cycle: int = 0

    def register_field(self, name: str, fes, array) -> None:
        """(DataCollection::RegisterField analog)."""
        self.fes_map[name] = fes
        self.fields[name] = array

    def set_time(self, t: float, dt: float = 0.0, cycle: int = 0) -> None:
        self.time, self.dt, self.cycle = float(t), float(dt), int(cycle)

    # ------------------------------------------------------------------
    def _cycle_file(self, cycle: int) -> str:
        return os.path.join(self.path, f"cycle_{cycle:06d}.npz")

    def save(self, write_vtu: bool = False) -> str:
        os.makedirs(self.path, exist_ok=True)
        arrays = {k: np.asarray(v) for k, v in self.fields.items()}
        meta = {
            "time": self.time,
            "dt": self.dt,
            "cycle": self.cycle,
            "fields": {
                k: {
                    "order": getattr(self.fes_map[k], "order", None),
                    "vdim": getattr(self.fes_map[k], "vdim", 1),
                    "shape": list(arrays[k].shape),
                }
                for k in arrays
            },
        }
        fn = self._cycle_file(self.cycle)
        np.savez_compressed(fn, __meta__=json.dumps(meta), **arrays)
        if write_vtu and self.mesh is not None:
            from .vtu import vertex_values, write_vtu as _wv

            pd = {}
            for k, arr in arrays.items():
                fes = self.fes_map[k]
                if hasattr(fes, "gather_map") and arr.ndim == 1 and (
                    len(arr) == fes.ndof_scalar
                ):
                    pd[k] = vertex_values(fes, arr)
            _wv(self.mesh, fn.replace(".npz", ".vtu"), point_data=pd)
        return fn

    def load(self, cycle: int) -> None:
        """Restore fields + metadata from a cycle file (Load analog)."""
        with np.load(self._cycle_file(cycle), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            for k in meta["fields"]:
                self.fields[k] = jnp.asarray(z[k])
        self.time, self.dt, self.cycle = meta["time"], meta["dt"], meta["cycle"]

    def latest_cycle(self) -> Optional[int]:
        if not os.path.isdir(self.path):
            return None
        cycles = [
            int(f[len("cycle_"):-4])
            for f in os.listdir(self.path)
            if f.startswith("cycle_") and f.endswith(".npz")
        ]
        return max(cycles) if cycles else None


def save_gridfunction(path: str, fes, u) -> None:
    """Single-field save (GridFunction::Save analog, fem/gridfunc.cpp)."""
    np.savez_compressed(
        path, u=np.asarray(u), order=fes.order,
        vdim=getattr(fes, "vdim", 1),
    )


def load_gridfunction(path: str):
    with np.load(path) as z:
        return jnp.asarray(z["u"]), int(z["order"]), int(z["vdim"])


# ----------------------------------------------------------------------------
# VisIt DataCollection format (interop with the reference's tooling)
# ----------------------------------------------------------------------------


def save_visit(path: str, name: str, mesh, fields: Dict[str, tuple],
               cycle: int = 0, time: float = 0.0, dt: float = 0.0) -> str:
    """Write a VisIt DataCollection: ``<name>_NNNNNN.mfem_root`` (JSON) +
    ``<name>_NNNNNN/mesh.000000`` (MFEM mesh v1.0) + one MFEM GridFunction
    file per field — loadable by VisIt's MFEM plugin and by the
    reference's ``VisItDataCollection::Load`` / ``convert-dc`` tools
    (fem/datacollection.hpp:426, writer datacollection.cpp:480-660).

    ``fields``: name → (fes, array).  Fields are written EXACTLY at the
    space's order through the ``.gf`` global-dof-ordering reconstruction
    (io/gf_io.py, the GridFunction::Save analog of fem/gridfunc.cpp:4142);
    VisIt renders high-order fields through the ``lod`` tag."""
    from .gf_io import write_gridfunction
    from .mesh_io import write_mfem_mesh

    pad = f"{cycle:06d}"
    ddir = os.path.join(path, f"{name}_{pad}")
    os.makedirs(ddir, exist_ok=True)
    write_mfem_mesh(mesh, os.path.join(ddir, "mesh.000000"))

    fjson = {}
    for fname, (fes, arr) in fields.items():
        vdim = getattr(fes, "vdim", 1)
        with open(os.path.join(ddir, f"{fname}.000000"), "w") as f:
            write_gridfunction(f, fes, np.asarray(arr))
        fjson[fname] = {
            "path": f"{name}_{pad}/{fname}.%06d",
            "tags": {"assoc": "nodes", "comps": str(vdim),
                     "lod": str(max(getattr(fes, "order", 1), 1))},
        }

    root = {
        "dsets": {"main": {
            "cycle": cycle, "time": time, "time_step": dt, "domains": 1,
            "mesh": {"path": f"{name}_{pad}/mesh.%06d",
                     "tags": {"spatial_dim": str(mesh.sdim),
                              "topo_dim": str(mesh.dim),
                              "max_lods": "32"}},
            "fields": fjson,
        }}
    }
    root_path = os.path.join(path, f"{name}_{pad}.mfem_root")
    with open(root_path, "w") as f:
        json.dump(root, f, indent=1)
    return root_path


def load_visit(root_path: str, spaces: Optional[Dict[str, object]] = None):
    """Load a VisIt DataCollection root written by ``save_visit`` (or the
    reference's VisItDataCollection): returns (mesh, fields, meta).

    With ``spaces`` (field name → FESpace built on the same mesh), each
    field is decoded through ``gf_io.read_gridfunction`` into OUR dof
    ordering — exact at any order.  Without, raw MFEM-global-ordered dof
    values are returned (order recorded in ``meta['orders'][name]``)."""
    from .mesh_io import read_mfem_mesh

    with open(root_path) as f:
        main = json.load(f)["dsets"]["main"]
    base = os.path.dirname(root_path)

    def _p(tpl):
        return os.path.join(base, tpl % 0)

    mesh = read_mfem_mesh(open(_p(main["mesh"]["path"])).read())
    fields = {}
    orders = {}
    for fname, spec in main.get("fields", {}).items():
        if spaces is not None and fname in spaces:
            from .gf_io import read_gridfunction

            fields[fname] = read_gridfunction(_p(spec["path"]), spaces[fname])
            orders[fname] = getattr(spaces[fname], "order", 1)
            continue
        with open(_p(spec["path"])) as f:
            lines = f.read().split("\n")
        m = re.search(r"H1_\dD_P(\d+)", lines[1])
        orders[fname] = int(m.group(1)) if m else 1
        i = lines.index("") + 1
        vals = np.array([float(x) for x in lines[i:] if x.strip()])
        comps = int(spec["tags"].get("comps", "1"))
        if comps > 1:
            vals = vals.reshape(comps, -1)     # byNODES (Ordering: 0)
        fields[fname] = vals
    meta = {"cycle": main["cycle"], "time": main["time"],
            "time_step": main.get("time_step", 0.0), "orders": orders}
    return mesh, fields, meta
