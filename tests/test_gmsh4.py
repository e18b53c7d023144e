"""Gmsh MSH 4.1 (ASCII + binary) and 2.2 binary readers: the same tiny
two-triangle square encoded in every format must parse identically to the
2.2 ASCII baseline (reference reader: mesh/mesh_readers.cpp:888-990)."""

import struct

import numpy as np

from cardiac_ablation_ecm2.io.gmsh import read_gmsh

V22_ASCII = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
1 10 "bottom"
2 20 "domain"
$EndPhysicalNames
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
6
1 1 2 10 1 1 2
2 1 2 11 2 2 3
3 1 2 12 3 3 4
4 1 2 13 4 4 1
5 2 2 20 1 1 2 3
6 2 2 20 1 1 3 4
$EndElements
"""

V41_ASCII = """$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
2
1 10 "bottom"
2 20 "domain"
$EndPhysicalNames
$Entities
0 4 1 0
1 0 0 0 1 0 0 1 10 0
2 1 0 0 1 1 0 1 11 0
3 0 1 0 1 1 0 1 12 0
4 0 0 0 0 1 0 1 13 0
1 0 0 0 1 1 0 1 20 4 1 2 3 4
$EndEntities
$Nodes
4 4 1 4
1 1 0 2
1
2
0 0 0
1 0 0
1 2 0 1
3
1 1 0
1 3 0 0
1 4 0 1
4
0 1 0
$EndNodes
$Elements
5 6 1 6
1 1 1 1
1 1 2
1 2 1 1
2 2 3
1 3 1 1
3 3 4
1 4 1 1
4 4 1
2 1 2 2
5 1 2 3
6 1 3 4
$EndElements
"""


def _v41_binary() -> bytes:
    """Hand-assemble the same mesh in MSH 4.1 binary (size_t = 8)."""
    st = "<q"
    out = [b"$MeshFormat\n4.1 1 8\n",
           struct.pack("<i", 1), b"\n$EndMeshFormat\n"]
    out.append(b"$PhysicalNames\n2\n1 10 \"bottom\"\n2 20 \"domain\"\n"
               b"$EndPhysicalNames\n")
    # Entities: 0 points, 4 curves, 1 surface, 0 volumes
    ent = [struct.pack("<4q", 0, 4, 1, 0)]
    for tag, phys in ((1, 10), (2, 11), (3, 12), (4, 13)):
        ent.append(struct.pack("<i", tag))
        ent.append(struct.pack("<6d", 0, 0, 0, 1, 1, 0))
        ent.append(struct.pack(st, 1))
        ent.append(struct.pack("<i", phys))
        ent.append(struct.pack(st, 0))          # no bounding points listed
    ent.append(struct.pack("<i", 1))
    ent.append(struct.pack("<6d", 0, 0, 0, 1, 1, 0))
    ent.append(struct.pack(st, 1))
    ent.append(struct.pack("<i", 20))
    ent.append(struct.pack(st, 4))
    ent.append(struct.pack("<4i", 1, 2, 3, 4))
    out += [b"$Entities\n", b"".join(ent), b"$EndEntities\n"]
    # Nodes: one block, entity (2, 1)
    nd = [struct.pack("<4q", 1, 4, 1, 4),
          struct.pack("<3i", 2, 1, 0), struct.pack(st, 4),
          struct.pack("<4q", 1, 2, 3, 4),
          struct.pack("<3d", 0, 0, 0), struct.pack("<3d", 1, 0, 0),
          struct.pack("<3d", 1, 1, 0), struct.pack("<3d", 0, 1, 0)]
    out += [b"$Nodes\n", b"".join(nd), b"$EndNodes\n"]
    # Elements: 5 blocks (4 boundary curves + 1 surface)
    el = [struct.pack("<4q", 5, 6, 1, 6)]
    for k, (tag, conn) in enumerate(
            (((1), (1, 2)), ((2), (2, 3)), ((3), (3, 4)), ((4), (4, 1)))):
        el.append(struct.pack("<3i", 1, tag, 1))       # dim 1, curve, type 1
        el.append(struct.pack(st, 1))
        el.append(struct.pack("<3q", k + 1, *conn))
    el.append(struct.pack("<3i", 2, 1, 2))             # dim 2, surf, type 2
    el.append(struct.pack(st, 2))
    el.append(struct.pack("<4q", 5, 1, 2, 3))
    el.append(struct.pack("<4q", 6, 1, 3, 4))
    out += [b"$Elements\n", b"".join(el), b"$EndElements\n"]
    return b"".join(out)


def _v22_binary() -> bytes:
    out = [b"$MeshFormat\n2.2 1 8\n",
           struct.pack("<i", 1), b"\n$EndMeshFormat\n"]
    out.append(b"$PhysicalNames\n2\n1 10 \"bottom\"\n2 20 \"domain\"\n"
               b"$EndPhysicalNames\n")
    nd = [b"4\n"]
    for i, (x, y) in enumerate(((0, 0), (1, 0), (1, 1), (0, 1))):
        nd.append(struct.pack("<i3d", i + 1, x, y, 0.0))
    out += [b"$Nodes\n", b"".join(nd), b"$EndNodes\n"]
    el = [b"6\n"]
    el.append(struct.pack("<3i", 1, 4, 2))             # type 1 (seg), 4, 2 tags
    for k, (phys, conn) in enumerate(
            ((10, (1, 2)), (11, (2, 3)), (12, (3, 4)), (13, (4, 1)))):
        el.append(struct.pack("<5i", k + 1, phys, k + 1, *conn))
    el.append(struct.pack("<3i", 2, 2, 2))             # type 2 (tri), 2, 2 tags
    el.append(struct.pack("<6i", 5, 20, 1, 1, 2, 3))
    el.append(struct.pack("<6i", 6, 20, 1, 1, 3, 4))
    out += [b"$Elements\n", b"".join(el), b"$EndElements\n"]
    return b"".join(out)


def _check(mesh, names, battrs):
    assert mesh.ne == 2
    assert mesh.nv == 4
    np.testing.assert_array_equal(mesh.attributes, [20, 20])
    np.testing.assert_array_equal(np.sort(mesh.bdr_attributes), battrs)
    assert names.get("bottom") == [10]
    assert names.get("domain") == [20]
    np.testing.assert_allclose(
        mesh.vertices, [[0, 0], [1, 0], [1, 1], [0, 1]])


def test_msh22_ascii_baseline():
    mesh, names = read_gmsh(V22_ASCII)
    _check(mesh, names, [10, 11, 12, 13])


def test_msh41_ascii():
    mesh, names = read_gmsh(V41_ASCII)
    _check(mesh, names, [10, 11, 12, 13])
    base, _ = read_gmsh(V22_ASCII)
    np.testing.assert_array_equal(mesh.elements, base.elements)
    np.testing.assert_array_equal(mesh.boundary, base.boundary)


def test_msh41_binary():
    mesh, names = read_gmsh(_v41_binary())
    _check(mesh, names, [10, 11, 12, 13])
    base, _ = read_gmsh(V22_ASCII)
    np.testing.assert_array_equal(mesh.elements, base.elements)


def test_msh22_binary():
    mesh, names = read_gmsh(_v22_binary())
    _check(mesh, names, [10, 11, 12, 13])
    base, _ = read_gmsh(V22_ASCII)
    np.testing.assert_array_equal(mesh.elements, base.elements)
