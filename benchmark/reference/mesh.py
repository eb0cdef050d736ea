# Frozen copy of adflow_torch/core/mesh.py for the benchmark's reference, its
# imports made local.
"""Structured multiblock mesh containers.

Reference analogue: ``blockType`` + ``flowDoms``
(`ADflow: src/modules/block.F90:1-1096`) hold per-block node
coordinates, metrics, BC subface descriptors and 1-to-1 connectivities. Here
the host-side mesh is plain NumPy + static metadata; the solver assembles
jittable pytrees from it. There is no ``setPointers`` pointer-swap idiom
(`src/modules/blockPointers.F90`) — blocks are explicit function arguments.

Index conventions (0-based):
- A block has ``ni x nj x nk`` cells; nodes array ``x`` has shape
  ``(ni+1, nj+1, nk+1, 3)``.
- Cell-centered solver arrays carry 2 halo layers per side:
  shape ``(ni+4, nj+4, nk+4, ...)``; interior slice is ``[2:-2]``.
  (The reference's ``0:ib`` arrays are the same layout, block.F90:145-210.)
- Face metrics: ``si`` has shape (ni+1, nj, nk, 3) = area vectors of
  constant-i faces pointing toward +i; similarly ``sj``, ``sk``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class BCType(enum.Enum):
    """Physical boundary-condition types.

    Subset of the reference's 24 BC enums
    (`ADflow: src/modules/constants.F90:257-282`).
    """

    FARFIELD = "farfield"
    EULER_WALL = "euler wall"                 # slip wall
    NS_WALL_ADIABATIC = "ns wall adiabatic"   # no-slip adiabatic
    NS_WALL_ISOTHERMAL = "ns wall isothermal"
    SYMMETRY = "symmetry"
    SYMMETRY_POLAR = "symmetry polar"
    SUBSONIC_INFLOW = "subsonic inflow"
    SUBSONIC_OUTFLOW = "subsonic outflow"
    SUPERSONIC_INFLOW = "supersonic inflow"
    SUPERSONIC_OUTFLOW = "supersonic outflow"
    EXTRAPOLATE = "extrapolate"
    OVERSET = "overset"
    B2B_MATCH = "b2b"                         # internal 1-to-1 (not physical)
    # bleed/engine faces (constants.F90:268-269): outflow shares the
    # subsonic-outflow handler (BCRoutines.F90:163-168), inflow uses the
    # subsonic-inflow massFlow treatment (BCRoutines.F90:987)
    MASS_BLEED_INFLOW = "mass bleed inflow"
    MASS_BLEED_OUTFLOW = "mass bleed outflow"
    # external-coupling interfaces (constants.F90:276-281): ALL behaves as
    # supersonic inflow with a prescribed full state (BCData.F90:2282);
    # RHOUVW prescribes density+velocity (mass flow, BCData.F90:2381);
    # TOTAL prescribes total conditions (BCData.F90:2414).
    # Not present: mDot (-13), bcThrust (-14), SlidingInterface (-18),
    # B2BMismatch (-17) — the reference enumerates them but has no
    # BCRoutines handler either (legacy/turbomachinery placeholders).
    DOMAIN_INTERFACE_ALL = "domain interface all"
    DOMAIN_INTERFACE_P = "domain interface p"
    DOMAIN_INTERFACE_RHO = "domain interface rho"
    DOMAIN_INTERFACE_RHOUVW = "domain interface rhouvw"
    DOMAIN_INTERFACE_TOTAL = "domain interface total"


# Wall BCs for force integration / wall distance.
WALL_BCS = (BCType.EULER_WALL, BCType.NS_WALL_ADIABATIC,
            BCType.NS_WALL_ISOTHERMAL)
VISCOUS_WALL_BCS = (BCType.NS_WALL_ADIABATIC, BCType.NS_WALL_ISOTHERMAL)


class Face(enum.IntEnum):
    """Block face identifiers (reference: iMin..kMax, constants.F90)."""

    IMIN = 0
    IMAX = 1
    JMIN = 2
    JMAX = 3
    KMIN = 4
    KMAX = 5

    @property
    def axis(self) -> int:
        return int(self) // 2

    @property
    def is_high(self) -> bool:
        return bool(int(self) % 2)


@dataclasses.dataclass(frozen=True)
class BCSubface:
    """One physical-BC patch on a block face.

    Reference: ``BCDataType`` subface records (block.F90:51-60) + prescribed
    data from CGNS or ``setBCData`` (src/bcdata/BCData.F90:1403).
    ``rng`` is the cell-index range on the face, ((lo1, hi1), (lo2, hi2)),
    half-open, in the two in-face directions ordered by ascending axis id;
    None means the full face.
    """

    face: Face
    bc: BCType
    family: str = "wall"
    rng: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
    # Prescribed data, e.g. {"Pt": ..., "Tt": ...} for subsonic inflow,
    # {"P": ...} for subsonic outflow, {"T": ...} for isothermal walls.
    data: Optional[Dict[str, float]] = None


@dataclasses.dataclass(frozen=True)
class B2BConnection:
    """1-to-1 block-to-block (or periodic self) connectivity.

    Reference: 1-to-1 subface connectivity in blockType (block.F90) built by
    readCGNSGrid; the CGNS ``transform`` triple maps my (i,j,k) axes into the
    donor's axes: transform[d] = +-(axis+1), sign = direction flip.
    ``offset`` is the donor-cell index offset such that my cell index v maps
    to donor index: donor[|t|-1] = sign(t) * v + offset.  Periodic rotations
    (communication.F90:59-80) carried via ``rotation`` (3x3) + ``translation``.
    """

    face: Face
    donor_block: int
    donor_face: Face
    transform: Tuple[int, int, int]
    offset: Tuple[int, int, int]
    rotation: Optional[np.ndarray] = None
    translation: Optional[np.ndarray] = None
    # partial-face window: half-open cell ranges over the face's two
    # tangential axes in SORTED axis order (like BCSubface.rng); None =
    # full face. Produced by block splitting when a donor block is cut
    # (loadBalance.F90:880 splitBlocksLoadBalance donor remapping).
    rng: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None


@dataclasses.dataclass
class Block:
    """One structured block: nodes + static boundary metadata."""

    name: str
    x: np.ndarray  # (ni+1, nj+1, nk+1, 3) float64 nodes
    bcs: List[BCSubface] = dataclasses.field(default_factory=list)
    conns: List[B2BConnection] = dataclasses.field(default_factory=list)

    @property
    def dims(self) -> Tuple[int, int, int]:
        s = self.x.shape
        return (s[0] - 1, s[1] - 1, s[2] - 1)

    @property
    def n_cells(self) -> int:
        ni, nj, nk = self.dims
        return ni * nj * nk

    def validate(self) -> None:
        ni, nj, nk = self.dims
        assert self.x.shape == (ni + 1, nj + 1, nk + 1, 3), self.x.shape
        covered = {f: [] for f in Face}
        for bc in self.bcs:
            covered[bc.face].append(bc)
        for conn in self.conns:
            covered[conn.face].append(conn)
        for f in Face:
            if not covered[f]:
                raise ValueError(
                    f"block '{self.name}': face {f.name} has no BC or "
                    f"connectivity")


@dataclasses.dataclass
class MultiBlockMesh:
    """The whole mesh: list of blocks (reference: ``cgnsDoms`` +
    per-rank ``flowDoms``, modules/cgnsGrid.F90 / block.F90)."""

    blocks: List[Block]
    name: str = "mesh"

    @property
    def n_cells(self) -> int:
        return sum(b.n_cells for b in self.blocks)

    def validate(self) -> None:
        for b in self.blocks:
            b.validate()
        for bi, b in enumerate(self.blocks):
            for c in b.conns:
                if not (0 <= c.donor_block < len(self.blocks)):
                    raise ValueError(
                        f"block {bi} connects to nonexistent donor "
                        f"{c.donor_block}")

    def wall_families(self) -> List[str]:
        fams = []
        for b in self.blocks:
            for bc in b.bcs:
                if bc.bc in WALL_BCS and bc.family not in fams:
                    fams.append(bc.family)
        return fams

    def families(self) -> List[str]:
        fams = []
        for b in self.blocks:
            for bc in b.bcs:
                if bc.family not in fams:
                    fams.append(bc.family)
        return fams


def face_slices(face: Face, dims: Tuple[int, int, int], halo: int = 2):
    """Return (ghost_slices, interior_slices) for the two ghost layers of a
    face in a halo-padded cell array of shape (ni+2h, nj+2h, nk+2h, ...).

    ghost_slices[d] = index slices selecting ghost layer d+1 (d=0 nearest);
    interior_slices[d] = the matching interior layer (mirror image), used by
    the reflective/extrapolation BC kernels.
    """
    ax = face.axis
    n = dims[ax]
    full = [slice(None)] * 3
    ghosts, interiors = [], []
    for d in range(halo):
        g = list(full)
        i = list(full)
        if face.is_high:
            g[ax] = halo + n + d
            i[ax] = halo + n - 1 - d
        else:
            g[ax] = halo - 1 - d
            i[ax] = halo + d
        ghosts.append(tuple(g))
        interiors.append(tuple(i))
    return ghosts, interiors
