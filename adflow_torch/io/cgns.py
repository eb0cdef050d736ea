"""CGNS reader/writer (HDF5 and legacy ADF flavors) for structured meshes.

Reference analogue: the parallel CGNS reader
(`ADflow: src/partitioning/readCGNSGrid.F90`, 3,265 LoC) and the CGNS
volume/surface writers (`src/output/writeCGNSGrid.F90`,
`writeCGNSVolume.F90`). The reference links the CGNS mid-level library; here
the CGNS/HDF5 file mapping (every ADF node = HDF5 group with 'name'/'label'/
'type' attributes and a ' data' dataset, Fortran-ordered) is implemented
directly on h5py, which keeps mesh I/O off the device hot path entirely.

Supported on read: structured 3-D zones, GridCoordinates, ZoneBC with
PointRange + FamilyName, 1-to-1 GridConnectivity (Transform + PointRange /
PointRangeDonor), FlowSolution_t (cell-centered, for restart).
Supported on write: the same, so files round-trip; solutions are written as
CellCenter FlowSolution nodes (restart parity:
`src/initFlow/variableReading.F90:73-1233`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from adflow_torch.core.mesh import (
    B2BConnection, BCSubface, BCType, Block, Face, MultiBlockMesh)

# ---------------------------------------------------------------------------
# CGNS BC-type names <-> our BCType
# (reference mapping: readCGNSGrid.F90 BC translation + overrides via
#  family names; constants.F90:257-282)
# ---------------------------------------------------------------------------
_CGNS_TO_BC = {
    "BCWallViscous": BCType.NS_WALL_ADIABATIC,
    "BCWallViscousHeatFlux": BCType.NS_WALL_ADIABATIC,
    "BCWallViscousIsothermal": BCType.NS_WALL_ISOTHERMAL,
    "BCWall": BCType.NS_WALL_ADIABATIC,
    "BCWallInviscid": BCType.EULER_WALL,
    "BCSymmetryPlane": BCType.SYMMETRY,
    "BCSymmetryPolar": BCType.SYMMETRY_POLAR,
    "BCFarfield": BCType.FARFIELD,
    "BCInflow": BCType.SUBSONIC_INFLOW,
    "BCInflowSubsonic": BCType.SUBSONIC_INFLOW,
    "BCInflowSupersonic": BCType.SUPERSONIC_INFLOW,
    "BCOutflow": BCType.SUBSONIC_OUTFLOW,
    "BCOutflowSubsonic": BCType.SUBSONIC_OUTFLOW,
    "BCOutflowSupersonic": BCType.SUPERSONIC_OUTFLOW,
    "BCExtrapolate": BCType.EXTRAPOLATE,
    "BCOverset": BCType.OVERSET,
}
_BC_TO_CGNS = {
    BCType.NS_WALL_ADIABATIC: "BCWallViscous",
    BCType.NS_WALL_ISOTHERMAL: "BCWallViscousIsothermal",
    BCType.EULER_WALL: "BCWallInviscid",
    BCType.SYMMETRY: "BCSymmetryPlane",
    BCType.SYMMETRY_POLAR: "BCSymmetryPolar",
    BCType.FARFIELD: "BCFarfield",
    BCType.SUBSONIC_INFLOW: "BCInflowSubsonic",
    BCType.SUPERSONIC_INFLOW: "BCInflowSupersonic",
    BCType.SUBSONIC_OUTFLOW: "BCOutflowSubsonic",
    BCType.SUPERSONIC_OUTFLOW: "BCOutflowSupersonic",
    BCType.EXTRAPOLATE: "BCExtrapolate",
    BCType.OVERSET: "BCOverset",
}


# ---------------------------------------------------------------------------
# Low-level ADF-on-HDF5 node helpers
# ---------------------------------------------------------------------------

def _attr_str(v) -> str:
    if isinstance(v, bytes):
        return v.split(b"\x00")[0].decode("ascii", "replace")
    if isinstance(v, np.ndarray):
        return _attr_str(v.tobytes())
    return str(v)


def _node_label(g) -> str:
    return _attr_str(g.attrs.get("label", b""))


def _node_name(g) -> str:
    return _attr_str(g.attrs.get("name", b""))


def _node_data(g) -> Optional[np.ndarray]:
    if " data" in g:
        return np.asarray(g[" data"])
    return None


def _node_str(g) -> str:
    d = _node_data(g)
    if d is None:
        return ""
    return d.tobytes().split(b"\x00")[0].decode("ascii", "replace")


def _children_by_label(g, label: str):
    out = []
    for key in g:
        if key.startswith(" "):
            continue
        child = g[key]
        if hasattr(child, "attrs") and _node_label(child) == label:
            out.append(child)
    return out


def _write_node(parent, name: str, label: str, dtype_tag: str,
                data: Optional[np.ndarray]):
    """Create one ADF node: HDF5 group + attrs (+ Fortran-ordered ' data')."""
    g = parent.create_group(name)
    g.attrs.create("name", np.bytes_(name.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("label", np.bytes_(label.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("type", np.bytes_(dtype_tag.ljust(3, "\x00")[:3]),
                   dtype="S3")
    g.attrs.create("flags", np.array([1], np.int32))
    if data is not None:
        # CGNS/HDF5 stores Fortran order: reverse axes for the C-order view
        g.create_dataset(" data", data=np.ascontiguousarray(data.T))
    return g


def _write_str_node(parent, name: str, label: str, text: str):
    # the text's bytes as C1 data. The JAX package converts the byte values
    # with astype('|S1'), which keeps the first decimal digit of each
    # ('wall' becomes '1911'): its files lose every BC type and family
    # name, and read back as farfield. Both readers read either file.
    arr = np.frombuffer(text.encode("ascii"), dtype=np.int8)
    g = parent.create_group(name)
    g.attrs.create("name", np.bytes_(name.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("label", np.bytes_(label.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("type", np.bytes_("C1\x00"), dtype="S3")
    g.attrs.create("flags", np.array([1], np.int32))
    g.create_dataset(" data", data=arr)
    return g


_DTYPE_TAG = {np.dtype(np.int32): "I4", np.dtype(np.int64): "I8",
              np.dtype(np.float32): "R4", np.dtype(np.float64): "R8"}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

import contextlib


@contextlib.contextmanager
def _open_cgns(path: str):
    """Yield the root node of a CGNS file in EITHER flavor: HDF5 via h5py
    or legacy ADF via the pure-Python core reader (io/adf.py) — the
    reference reads both through cgnslib (readCGNSGrid.F90)."""
    from adflow_torch.io.adf import is_adf, read_adf_tree
    if not os.path.isfile(path):
        # before the flavour test: without h5py a missing file would
        # otherwise surface as the import's error
        raise FileNotFoundError(f"no CGNS file '{path}'")
    if is_adf(path):
        yield read_adf_tree(path)
    else:
        import h5py
        with h5py.File(path, "r") as f:
            yield f


def read_cgns(path: str) -> MultiBlockMesh:
    """Read a structured multiblock CGNS mesh (HDF5 or ADF flavor) into
    MultiBlockMesh."""
    with _open_cgns(path) as f:
        bases = _children_by_label(f, "CGNSBase_t")
        if not bases:
            raise ValueError(f"{path}: no CGNSBase_t found")
        base = bases[0]
        zones = _children_by_label(base, "Zone_t")
        zones.sort(key=_node_name)
        name_to_idx = {_node_name(z): i for i, z in enumerate(zones)}

        blocks: List[Block] = []
        for z in zones:
            zname = _node_name(z)
            # zone size: file stores (3, idxdim) fortran = h5py (idxdim, 3);
            # row 0 = vertex sizes after transpose back
            zsize = _node_data(z)
            if zsize is None:
                raise ValueError(f"zone {zname}: missing size data")
            zsize = zsize.T if zsize.shape[0] == 3 and zsize.ndim == 2 \
                else zsize
            nverts = zsize.reshape(-1, 3)[:, 0] if zsize.shape == (3, 3) \
                else zsize.reshape(3, -1)[:, 0]
            # robust: vertex dims are the first triple in fortran layout
            flat = np.asarray(_node_data(z)).reshape(-1)
            nv = flat[:3]  # fortran-first triple = vertex sizes
            ni, nj, nk = int(nv[0]) - 1, int(nv[1]) - 1, int(nv[2]) - 1

            gc = _children_by_label(z, "GridCoordinates_t")
            if not gc:
                raise ValueError(f"zone {zname}: no GridCoordinates")
            coords = {}
            for da in _children_by_label(gc[0], "DataArray_t"):
                coords[_node_name(da)] = np.asarray(_node_data(da)).T
            x = np.stack([coords["CoordinateX"], coords["CoordinateY"],
                          coords["CoordinateZ"]], axis=-1).astype(np.float64)
            assert x.shape[:3] == (ni + 1, nj + 1, nk + 1), (
                zname, x.shape, (ni, nj, nk))

            dims = (ni, nj, nk)
            bcs = _read_zone_bcs(z, dims)
            conns = _read_zone_conns(z, dims, name_to_idx)
            blocks.append(Block(name=zname, x=x, bcs=bcs, conns=conns))

    return MultiBlockMesh(blocks, name=os.path.basename(path))


def _as_index_range(d) -> np.ndarray:
    """Normalize a stored IndexRange to (2, 3) [begin; end].

    CGNS stores PointRange as Fortran (IndexDimension, 2) = column begin,
    column end; the h5py/ADF C-transposed view is therefore (2, 3) with
    row 0 = begin. Files from other writers may present (3, 2); transpose
    those. (This replaces an earlier double-transpose that scrambled
    asymmetric ranges — caught by the split-mesh ADF roundtrip test.)"""
    d = np.asarray(d)
    if d.shape == (3, 2):
        d = d.T
    return d.reshape(2, 3)


def _range_to_face(pr: np.ndarray, dims) -> Tuple[Face, tuple]:
    """CGNS PointRange (2,3) [begin;end] 1-based NODE indices -> (Face, rng)
    with rng in 0-based cell index ranges over the two tangential axes
    (ascending axis order), half-open."""
    beg, end = pr[0], pr[1]
    lo = np.minimum(beg, end)
    hi = np.maximum(beg, end)
    face = None
    for ax in range(3):
        if lo[ax] == hi[ax]:
            if lo[ax] == 1:
                face = Face(2 * ax)
            elif lo[ax] == dims[ax] + 1:
                face = Face(2 * ax + 1)
            else:
                continue
            t1, t2 = [a for a in range(3) if a != ax]
            rng = ((int(lo[t1]) - 1, int(hi[t1]) - 1),
                   (int(lo[t2]) - 1, int(hi[t2]) - 1))
            return face, rng
    raise ValueError(f"PointRange {pr} is not a face patch for dims {dims}")


def _read_zone_bcs(z, dims) -> List[BCSubface]:
    bcs: List[BCSubface] = []
    for zbc in _children_by_label(z, "ZoneBC_t"):
        for bc in _children_by_label(zbc, "BC_t"):
            bc_name = _node_str(bc) or "BCFarfield"
            fam = _node_name(bc)
            for famn in _children_by_label(bc, "FamilyName_t"):
                fam = _node_str(famn) or fam
            prs = [c for c in _children_by_label(bc, "IndexRange_t")
                   if _node_name(c) == "PointRange"]
            if not prs:
                continue
            pr = _as_index_range(_node_data(prs[0]))  # (2,3) [begin; end]
            bctype = _CGNS_TO_BC.get(bc_name)
            if bctype is None:
                # FamilySpecified etc.: guess from family name keywords
                lfam = fam.lower()
                if "wall" in lfam:
                    bctype = BCType.NS_WALL_ADIABATIC
                elif "sym" in lfam:
                    bctype = BCType.SYMMETRY
                elif "far" in lfam or "inout" in lfam:
                    bctype = BCType.FARFIELD
                else:
                    bctype = BCType.FARFIELD
            face, rng = _range_to_face(pr, dims)
            full = rng == ((0, dims[[a for a in range(3)
                                     if a != face.axis][0]]),
                           (0, dims[[a for a in range(3)
                                     if a != face.axis][1]]))
            bcs.append(BCSubface(face=face, bc=bctype, family=fam,
                                 rng=None if full else rng))
    return bcs


def _read_zone_conns(z, dims, name_to_idx) -> List[B2BConnection]:
    conns: List[B2BConnection] = []
    for zgc in _children_by_label(z, "ZoneGridConnectivity_t"):
        for c in _children_by_label(zgc, "GridConnectivity1to1_t"):
            donor_name = _node_str(c).strip()
            if donor_name not in name_to_idx:
                continue
            pr = prd = tr = None
            for ch in _children_by_label(c, "IndexRange_t"):
                if _node_name(ch) == "PointRange":
                    pr = _as_index_range(_node_data(ch))
                elif _node_name(ch) == "PointRangeDonor":
                    prd = _as_index_range(_node_data(ch))
            for ch in _children_by_label(c, '"int[IndexDimension]"'):
                tr = np.asarray(_node_data(ch)).reshape(-1)[:3]
            if tr is None and "Transform" in c:
                tr = np.asarray(_node_data(c["Transform"])).reshape(-1)[:3]
            if pr is None or prd is None or tr is None:
                continue
            face, _ = _range_to_face(pr, dims)
            # offsets in CELL coords (see B2BConnection):
            #   s=+1: off = donor_begin - begin
            #   s=-1: off = begin + donor_begin - 3   (1-based node begins)
            b = pr[0].astype(int)
            db_by_q = prd[0].astype(int)
            offset = [0, 0, 0]
            for m in range(3):
                t = int(tr[m])
                q = abs(t) - 1
                if t > 0:
                    offset[m] = int(db_by_q[q] - b[m])
                else:
                    offset[m] = int(b[m] + db_by_q[q] - 3)
            donor_face = _donor_face(prd, tr, face)
            conns.append(B2BConnection(
                face=face, donor_block=name_to_idx[donor_name],
                donor_face=donor_face, transform=tuple(int(t) for t in tr),
                offset=tuple(offset)))
    return conns


def _donor_face(prd, tr, face) -> Face:
    """Donor face: the degenerate axis of the donor range."""
    beg, end = prd[0], prd[1]
    q = abs(int(tr[face.axis])) - 1
    # direction: if donor index at the interface equals 1, low face
    return Face(2 * q + (0 if int(beg[q]) == 1 else 1))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_cgns(mesh: MultiBlockMesh, path: str,
               solutions: Optional[Sequence[Dict[str, np.ndarray]]] = None,
               sol_name: str = "FlowSolution",
               conv_hist: Optional[Dict[str, np.ndarray]] = None,
               flavor: Optional[str] = None) -> None:
    """Write mesh (+ optional per-block cell-centered solutions) as
    CGNS. ``solutions[i]`` maps variable name -> (ni, nj, nk) array.
    ``flavor``: 'hdf5' (through h5py) or 'adf' (io/adf.py, no h5py
    needed); by default HDF5 where h5py imports, else ADF. Both flavours
    hold the same tree and both readers here read either.

    Reference analogue: writeCGNSGrid/writeCGNSVolume
    (`ADflow: src/output/`): grid + cell-centered FlowSolution used
    both for visualization and restart."""
    if flavor is None:
        import importlib.util
        flavor = "hdf5" if importlib.util.find_spec("h5py") else "adf"
    if flavor == "adf":
        from adflow_torch.io.adf import AdfNode, write_adf_tree
        root = AdfNode("ADF MotherNode", "Root Node of ADF File", "MT",
                       (), None)
        _write_cgns_tree(_AdfGroup(root), mesh, solutions, sol_name,
                         conv_hist)
        write_adf_tree(root, path)
        return
    if flavor != "hdf5":
        raise ValueError(f"unknown CGNS flavor '{flavor}'")
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs.create("name", np.bytes_("HDF5 MotherNode".ljust(33, "\x00")),
                       dtype="S33")
        f.attrs.create("label", np.bytes_(
            "Root Node of HDF5 File".ljust(33, "\x00")), dtype="S33")
        f.attrs.create("type", np.bytes_("MT\x00"), dtype="S3")
        f.create_dataset(" format", data=np.frombuffer(
            b"IEEE_LITTLE_32\x00", dtype=np.int8))
        f.create_dataset(" hdf5version", data=np.frombuffer(
            h5py.version.hdf5_version.encode().ljust(33, b"\x00"),
            dtype=np.int8))
        _write_cgns_tree(f, mesh, solutions, sol_name, conv_hist)


def _write_cgns_tree(f, mesh, solutions, sol_name, conv_hist):
    """The CGNS tree below the root node ``f`` (an h5py file or an
    ``_AdfGroup``)."""
    _write_node(f, "CGNSLibraryVersion", "CGNSLibraryVersion_t", "R4",
                np.array([3.40], np.float32))
    base = _write_node(f, "Base", "CGNSBase_t", "I4",
                       np.array([3, 3], np.int32))
    if conv_hist:
        # reference: convergence history written into solution files
        # (monitor convArray -> CGNS ConvergenceHistory_t)
        n_it = max(len(np.asarray(v)) for v in conv_hist.values())
        ch = _write_node(base, "GlobalConvergenceHistory",
                         "ConvergenceHistory_t", "I4",
                         np.array([n_it], np.int32))
        for vname, arr in conv_hist.items():
            _write_node(ch, vname, "DataArray_t", "R8",
                        np.asarray(arr, np.float64))

    for bi, blk in enumerate(mesh.blocks):
        ni, nj, nk = blk.dims
        zsize = np.array([[ni + 1, nj + 1, nk + 1],
                          [ni, nj, nk], [0, 0, 0]], np.int32)
        # stored fortran-order: _write_node transposes the C view
        zone = _write_node(base, blk.name or f"zone{bi}", "Zone_t",
                           "I4", zsize.T)
        _write_str_node(zone, "ZoneType", "ZoneType_t", "Structured")
        gc = _write_node(zone, "GridCoordinates", "GridCoordinates_t",
                         "MT", None)
        for d, cname in enumerate(
                ("CoordinateX", "CoordinateY", "CoordinateZ")):
            _write_node(gc, cname, "DataArray_t", "R8",
                        np.asarray(blk.x[..., d], np.float64))

        if blk.bcs:
            zbc = _write_node(zone, "ZoneBC", "ZoneBC_t", "MT", None)
            for i, sf in enumerate(blk.bcs):
                _write_bc(zbc, f"BC{i + 1}", sf, blk.dims)
        if blk.conns:
            zgc = _write_node(zone, "ZoneGridConnectivity",
                              "ZoneGridConnectivity_t", "MT", None)
            for i, cn in enumerate(blk.conns):
                _write_conn(zgc, f"conn{i + 1}", cn, blk.dims,
                            mesh.blocks)
        if solutions is not None and solutions[bi]:
            sol = _write_str_node(zone, sol_name, "FlowSolution_t", "")
            del sol[" data"]
            sol.attrs.modify("type", np.bytes_("MT\x00"))
            _write_str_node(sol, "GridLocation", "GridLocation_t",
                            "CellCenter")
            for vname, arr in solutions[bi].items():
                arr = np.asarray(arr)
                tag = _DTYPE_TAG.get(arr.dtype, "R8")
                _write_node(sol, vname, "DataArray_t", tag, arr)


class _AdfAttrs:
    """The ``attrs`` of an ``_AdfGroup``: the name, label and type of its
    ADF node."""

    def __init__(self, node):
        self._node = node

    def create(self, key, value, dtype=None):
        text = _attr_str(np.asarray(value).tobytes())
        if key == "label":
            self._node.label = text
        elif key == "type":
            self._node.data_type = text

    modify = create


class _AdfGroup:
    """The part of h5py's group interface that the writer uses, building
    an ``AdfNode`` tree in memory (for ``write_adf_tree``)."""

    def __init__(self, node):
        self.node = node
        self.attrs = _AdfAttrs(node)

    def create_group(self, name: str) -> "_AdfGroup":
        from adflow_torch.io.adf import AdfNode
        return _AdfGroup(self.node.add_child(AdfNode(name, "", "MT", (),
                                                     None)))

    def create_dataset(self, name: str, data):
        # ' data' is the node's array in the same C view as h5py's
        if name == " data":
            self.node._data = np.asarray(data)

    def __delitem__(self, name: str):
        if name == " data":
            self.node._data = None


def _face_point_range(face: Face, rng, dims) -> np.ndarray:
    """(2, 3) [begin; end] 1-based NODE indices for a face patch."""
    ax = face.axis
    t1, t2 = [a for a in range(3) if a != ax]
    if rng is None:
        rng = ((0, dims[t1]), (0, dims[t2]))
    beg = [0, 0, 0]
    end = [0, 0, 0]
    beg[ax] = end[ax] = (dims[ax] + 1) if face.is_high else 1
    beg[t1], end[t1] = rng[0][0] + 1, rng[0][1] + 1
    beg[t2], end[t2] = rng[1][0] + 1, rng[1][1] + 1
    return np.array([beg, end], np.int32)


def _write_bc(zbc, name: str, sf: BCSubface, dims):
    cgns_name = _BC_TO_CGNS.get(sf.bc, "BCFarfield")
    bc = _write_str_node(zbc, name, "BC_t", cgns_name)
    pr = _face_point_range(sf.face, sf.rng, dims)
    _write_node(bc, "PointRange", "IndexRange_t", "I4", pr.T)
    if sf.family:
        _write_str_node(bc, "FamilyName", "FamilyName_t", sf.family)


def _write_conn(zgc, name: str, cn: B2BConnection, dims, blocks):
    donor = blocks[cn.donor_block]
    c = _write_str_node(zgc, name, "GridConnectivity1to1_t",
                        donor.name or f"zone{cn.donor_block}")
    pr = _face_point_range(cn.face, None, dims)
    _write_node(c, "PointRange", "IndexRange_t", "I4", pr.T)
    # donor begin/end from the inverse of the cell-offset convention
    dbeg = [0, 0, 0]
    dend = [0, 0, 0]
    beg, end = pr[0].astype(int), pr[1].astype(int)
    for m in range(3):
        t = cn.transform[m]
        q = abs(t) - 1
        if t > 0:
            dbeg[q] = beg[m] + cn.offset[m]
            dend[q] = end[m] + cn.offset[m]
        else:
            dbeg[q] = cn.offset[m] - beg[m] + 3
            dend[q] = cn.offset[m] - end[m] + 3
    prd = np.array([dbeg, dend], np.int32)
    _write_node(c, "PointRangeDonor", "IndexRange_t", "I4", prd.T)
    _write_node(c, "Transform", '"int[IndexDimension]"', "I4",
                np.asarray(cn.transform, np.int32))


# ---------------------------------------------------------------------------
# Solution read (restart)
# ---------------------------------------------------------------------------

def read_cgns_solution(path: str, sol_name: Optional[str] = None
                       ) -> List[Dict[str, np.ndarray]]:
    """Per-zone {variable: (ni, nj, nk)} cell-centered solution arrays
    (restart read; reference: variableReading.F90). Both CGNS flavors."""
    out: List[Dict[str, np.ndarray]] = []
    with _open_cgns(path) as f:
        base = _children_by_label(f, "CGNSBase_t")[0]
        zones = _children_by_label(base, "Zone_t")
        zones.sort(key=_node_name)
        for z in zones:
            sols = _children_by_label(z, "FlowSolution_t")
            if sol_name is not None:
                sols = [s for s in sols if _node_name(s) == sol_name]
            d: Dict[str, np.ndarray] = {}
            if sols:
                for da in _children_by_label(sols[0], "DataArray_t"):
                    d[_node_name(da)] = np.asarray(_node_data(da)).T
            out.append(d)
    return out
