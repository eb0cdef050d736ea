"""Mesh file I/O.

Reference analogue: the CGNS reader (`ADflow: src/partitioning/
readCGNSGrid.F90`). Formats here: Plot3D multiblock (.p3d/.xyz/.fmt, ASCII or
unformatted-free binary), NumPy archive (.npz, this framework's native
format), and CGNS (.cgns, the HDF5 flavour through h5py or the ADF
flavour) — reader in io/cgns.py.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import List

import numpy as np

from adflow_torch.core.mesh import Block, MultiBlockMesh


def read_mesh(path: str) -> MultiBlockMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npz",):
        return read_npz(path)
    if ext in (".p3d", ".xyz", ".fmt", ".x"):
        return read_plot3d(path)
    if ext == ".cgns":
        from adflow_torch.io.cgns import read_cgns
        return read_cgns(path)
    raise ValueError(f"Unsupported mesh format: {path}")


# ---------------------------------------------------------------------------
# Native .npz: arrays x_<i> of shape (ni+1, nj+1, nk+1, 3); BCs/conns are
# stored as a pickled metadata blob.
# ---------------------------------------------------------------------------

def write_npz(mesh: MultiBlockMesh, path: str) -> None:
    arrays = {f"x_{i}": b.x for i, b in enumerate(mesh.blocks)}
    meta = [
        {"name": b.name, "bcs": b.bcs, "conns": b.conns}
        for b in mesh.blocks
    ]
    arrays["meta"] = np.frombuffer(pickle.dumps(meta), dtype=np.uint8)
    arrays["mesh_name"] = np.array(mesh.name)
    np.savez_compressed(path, **arrays)


class _MeshUnpickler(pickle.Unpickler):
    """Unpickles the metadata of a ``.npz`` mesh into this package's mesh
    classes. A file written by the JAX package pickles its own
    ``adflow_tpu.core.mesh`` classes (same names and fields): any
    ``<package>.core.mesh`` is read as ``adflow_torch.core.mesh``, so
    reading such a file does not import that package, and with it JAX."""

    def find_class(self, module, name):
        if module.partition(".")[2] == "core.mesh":
            module = "adflow_torch.core.mesh"
        return super().find_class(module, name)


def read_npz(path: str) -> MultiBlockMesh:
    data = np.load(path, allow_pickle=False)
    meta = _MeshUnpickler(io.BytesIO(data["meta"].tobytes())).load()
    blocks = []
    for i, m in enumerate(meta):
        blocks.append(Block(name=m["name"], x=data[f"x_{i}"],
                            bcs=list(m["bcs"]), conns=list(m["conns"])))
    return MultiBlockMesh(blocks, name=str(data["mesh_name"]))


# ---------------------------------------------------------------------------
# Plot3D (whole-format ASCII; 3D multiblock with or without block count)
# ---------------------------------------------------------------------------

def read_plot3d(path: str) -> MultiBlockMesh:
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        vals = tokens[pos:pos + n]
        pos += n
        return vals

    nblocks = int(take(1)[0])
    dims = []
    for _ in range(nblocks):
        dims.append(tuple(int(v) for v in take(3)))
    blocks: List[Block] = []
    for b in range(nblocks):
        ni, nj, nk = dims[b]
        n = ni * nj * nk
        vals = np.array([float(v) for v in take(3 * n)])
        x = vals.reshape(3, nk, nj, ni).transpose(3, 2, 1, 0)
        blocks.append(Block(name=f"block{b}", x=x))
    return MultiBlockMesh(blocks, name=os.path.basename(path))


def write_plot3d(mesh: MultiBlockMesh, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"{len(mesh.blocks)}\n")
        for b in mesh.blocks:
            s = b.x.shape
            f.write(f"{s[0]} {s[1]} {s[2]}\n")
        for b in mesh.blocks:
            # Fortran order per coordinate
            vals = b.x.transpose(3, 2, 1, 0).reshape(-1)
            np.savetxt(f, vals[:, None], fmt="%.16e")
