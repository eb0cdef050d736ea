"""ADF (Advanced Data Format) core reader/writer — the legacy CGNS flavor.

Reference analogue: the reference ingests ADF-flavor CGNS through the CGNS
mid-level library (`ADflow: src/partitioning/readCGNSGrid.F90`,
3,265 LoC, linked against cgnslib); every mdolab regression mesh
(`ADflow: input_files/get-input-files.sh`) is ADF-flavor. This
module implements the ADF *core* disk format directly in Python so those
files load without an external conversion step, and provides
``adf_to_hdf5`` / ``hdf5_to_adf`` converters between the two CGNS flavors.

ADF disk format essentials (CGNS ADF core specification; cgnslib
``adf/ADF_internals.c``):

* All control metadata is **ASCII hex** (architecture independent); only
  array data is binary, in the numeric format recorded in the file header.
* A *disk pointer* is 12 ASCII hex chars: 8 for the 4096-byte block number
  + 4 for the offset within the block (absolute address =
  block * 4096 + offset). ``FFFFFFFFFFFF`` is the null pointer.
* A *node header* is a fixed 246-byte record::

      "NoDe" | name[32] | label[32] | num_sub_nodes[8 hex]
      | entries_for_sub_nodes[8 hex] | sub_node_table ptr[12]
      | data_type[32] | num_dims[2 hex] | dims[12][8 hex each]
      | num_data_chunks[4 hex] | data_chunks ptr[12] | "TaiL"

* A *sub-node table* is ``"SNTb"`` + entries of (child_name[32],
  child ptr[12]) + ``"snTR"``.
* A *data chunk* is ``start tag[4]`` + ``end-of-chunk ptr[12]`` + raw
  data; multi-chunk nodes point at a chunk table of (start, end) pointer
  pairs.

The reader is deliberately defensive about the 186-byte file header whose
exact field layout varies with ADF library versions: it verifies the
``@(#)ADF Database Version`` magic, reads the numeric-format character
from its canonical position (falling back to a tag scan), and locates the
root node by scanning for the first valid ``NoDe`` record instead of
trusting the header's root pointer. Links (data type ``LK``) within the
same file are resolved transparently; cross-file links raise.

Dimension order on disk is Fortran (like CGNS-on-HDF5); ``AdfNode``
presents data through the same transposed-C view h5py gives, so the CGNS
tree walker in ``io/cgns.py`` is flavor-agnostic.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

BLOCK = 4096
NODE_HEADER_SIZE = 246
SUBNODE_ENTRY_SIZE = 44            # name[32] + ptr[12]
NULL_PTR = b"FFFFFFFFFFFF"
MAGIC = b"@(#)ADF Database Version"

_TAG_NODE = b"NoDe"
_TAG_NODE_END = b"TaiL"
_TAG_SNT = b"SNTb"
_TAG_SNT_END = b"snTR"
_TAG_DATA = b"DbSt"
_TAG_DATA_END = b"DbEn"

# ADF data-type token -> (numpy kind, itemsize); endianness prefixed at read
_DTYPES = {
    "I4": ("i", 4), "I8": ("i", 8), "U4": ("u", 4), "U8": ("u", 8),
    "R4": ("f", 4), "R8": ("f", 8), "C1": ("S", 1), "B1": ("u", 1),
    "X4": ("c", 8), "X8": ("c", 16),
}


def _ptr_bytes(addr: int) -> bytes:
    return b"%08x%04x" % (addr // BLOCK, addr % BLOCK)


def _ptr_addr(p: bytes) -> Optional[int]:
    if p.upper() == NULL_PTR:
        return None
    try:
        return int(p[:8], 16) * BLOCK + int(p[8:12], 16)
    except ValueError:
        return None


def _hex(v: int, n: int) -> bytes:
    return (b"%0" + str(n).encode() + b"x") % v


def _str32(s: str) -> bytes:
    return s.encode("ascii", "replace")[:32].ljust(32)


class AdfNode:
    """One ADF node, presenting the h5py-group-like interface the CGNS
    tree walker uses (``attrs['name'/'label']``, ``' data'`` item,
    iteration over child names)."""

    def __init__(self, name: str, label: str, data_type: str,
                 dims: Tuple[int, ...], data: Optional[np.ndarray]):
        self.name = name
        self.label = label
        self.data_type = data_type
        self.dims = dims
        self._data = data          # C-transposed view (h5py parity)
        self._children: Dict[str, "AdfNode"] = {}

    # -- h5py-like surface ---------------------------------------------------
    @property
    def attrs(self) -> Dict[str, bytes]:
        return {"name": self.name.encode(), "label": self.label.encode()}

    def __contains__(self, key: str) -> bool:
        if key == " data":
            return self._data is not None
        return key in self._children

    def __getitem__(self, key: str):
        if key == " data":
            if self._data is None:
                raise KeyError(" data")
            return self._data
        return self._children[key]

    def __iter__(self):
        return iter(self._children)

    def add_child(self, node: "AdfNode") -> "AdfNode":
        name = node.name
        i = 1
        while name in self._children:      # duplicate names: suffix
            i += 1
            name = f"{node.name}#{i}"
        self._children[name] = node
        return node


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _AdfReader:
    def __init__(self, buf: bytes, path: str):
        self.buf = buf
        self.path = path
        if not buf.startswith(MAGIC):
            raise ValueError(f"{path}: not an ADF file (magic mismatch)")
        self.endian = self._numeric_format()

    def _numeric_format(self) -> str:
        # canonical position: what[32] "AdF0" creation[28] "AdF1"
        # modification[28] "AdF2" numeric_format os_size
        ch = chr(self.buf[100]) if len(self.buf) > 100 else "?"
        if ch not in "BLCN":
            pos = self.buf.find(b"AdF2", 0, 256)
            ch = chr(self.buf[pos + 4]) if pos >= 0 else "N"
        if ch == "B":
            return ">"
        if ch == "C":
            raise ValueError("Cray numeric format not supported")
        return "<"        # 'L' little / 'N' native (assume x86)

    def _parse_node_at(self, addr: int) -> Optional[dict]:
        b = self.buf[addr:addr + NODE_HEADER_SIZE]
        if len(b) < NODE_HEADER_SIZE or b[:4] != _TAG_NODE:
            return None
        if b[242:246] != _TAG_NODE_END:
            return None
        # field offsets: 0 tag | 4 name | 36 label | 68 n_sub | 76 entries
        # | 84 snt ptr | 96 data_type | 128 n_dims | 130 dims[12]
        # | 226 n_chunks | 230 data ptr | 242 tail
        try:
            n_sub = int(b[68:76], 16)
            n_dims = int(b[128:130], 16)
            if n_dims > 12:
                return None
            dims = tuple(int(b[130 + 8 * i:138 + 8 * i], 16)
                         for i in range(n_dims))
            n_chunks = int(b[226:230], 16)
        except ValueError:
            return None
        return dict(
            name=b[4:36].rstrip(b" \x00").decode("ascii", "replace"),
            label=b[36:68].rstrip(b" \x00").decode("ascii", "replace"),
            n_sub=n_sub,
            snt_ptr=_ptr_addr(b[84:96]),
            data_type=b[96:128].rstrip(b" \x00").decode("ascii", "replace"),
            dims=dims, n_chunks=n_chunks,
            data_ptr=_ptr_addr(b[230:242]),
        )

    def _read_children(self, snt_ptr: int, n_sub: int):
        """Yield child node addresses from the sub-node table."""
        pos = snt_ptr
        if self.buf[pos:pos + 4] == _TAG_SNT:
            pos += 4
        for _ in range(n_sub):
            ent = self.buf[pos:pos + SUBNODE_ENTRY_SIZE]
            if len(ent) < SUBNODE_ENTRY_SIZE:
                return
            addr = _ptr_addr(ent[32:44])
            if addr is not None:
                yield addr
            pos += SUBNODE_ENTRY_SIZE

    def _chunk_bytes(self, start: int, end: Optional[int] = None) -> bytes:
        """Raw payload of one data chunk record at ``start``: 4-byte tag +
        12-byte end pointer + data. ``end`` (from a chunk table) or the
        embedded end pointer bounds the data."""
        tag = self.buf[start:start + 4]
        pos = start
        if tag.isalpha() or tag == _TAG_DATA:
            pos += 4
        e = _ptr_addr(self.buf[pos:pos + 12])
        if e is not None:
            data_start = pos + 12
            data_end = end if end is not None else e
        else:                      # no end pointer: tag + raw data
            data_start = pos
            data_end = end
        return self.buf[data_start:data_end]

    def _read_data(self, nd: dict) -> Optional[np.ndarray]:
        dt = nd["data_type"].strip()
        if dt in ("", "MT", "LK") or not nd["dims"] or nd["n_chunks"] == 0:
            return None
        base = dt[:2]
        if base not in _DTYPES:
            return None
        kind, size = _DTYPES[base]
        count = int(np.prod(nd["dims"]))
        need = count * size
        ptr = nd["data_ptr"]
        if ptr is None:
            return None
        if nd["n_chunks"] == 1:
            raw = self._chunk_bytes(ptr)[:need]
        else:
            # chunk table: tag + n pairs of (start, end) pointers
            pos = ptr
            if self.buf[pos:pos + 4].isalpha():
                pos += 4
            raw = b""
            for _ in range(nd["n_chunks"]):
                s = _ptr_addr(self.buf[pos:pos + 12])
                e = _ptr_addr(self.buf[pos + 12:pos + 24])
                pos += 24
                if s is None:
                    continue
                raw += self._chunk_bytes(s, e)
                if len(raw) >= need:
                    break
            raw = raw[:need]
        if len(raw) < need:
            raise ValueError(
                f"{self.path}: node '{nd['name']}' data truncated "
                f"({len(raw)}/{need} bytes)")
        if kind == "S":
            arr = np.frombuffer(raw, dtype=np.int8)
        else:
            arr = np.frombuffer(raw, dtype=f"{self.endian}{kind}{size}")
        # Fortran dims on disk -> transposed-C view (h5py parity)
        return arr.reshape(nd["dims"], order="F").T

    def read_tree(self, resolve_links: bool = True) -> AdfNode:
        # locate the root: first valid NoDe record in the file (the root is
        # written first by every ADF implementation; we do not trust the
        # header's root pointer whose in-header position varies)
        pos = self.buf.find(_TAG_NODE)
        root_nd = None
        while pos >= 0:
            root_nd = self._parse_node_at(pos)
            if root_nd is not None:
                break
            pos = self.buf.find(_TAG_NODE, pos + 1)
        if root_nd is None:
            raise ValueError(f"{self.path}: no valid ADF node records")
        self._resolve = resolve_links
        return self._build(root_nd, pos, depth=0)

    def _build(self, nd: dict, addr: int, depth: int) -> AdfNode:
        if depth > 40:
            raise ValueError("ADF tree too deep (cycle?)")
        if nd["data_type"].strip() == "LK" and getattr(
                self, "_resolve", True):
            return self._resolve_link(nd, depth)
        node = AdfNode(nd["name"], nd["label"], nd["data_type"].strip(),
                       nd["dims"], self._read_data(nd))
        if nd["n_sub"] > 0 and nd["snt_ptr"] is not None:
            for caddr in self._read_children(nd["snt_ptr"], nd["n_sub"]):
                cnd = self._parse_node_at(caddr)
                if cnd is not None:
                    node.add_child(self._build(cnd, caddr, depth + 1))
        return node

    def _resolve_link(self, nd: dict, depth: int) -> AdfNode:
        """Same-file ADF link: data = 'file\\0path' or just 'path'."""
        raw_node = dict(nd, data_type="C1")
        data = self._read_data(raw_node)
        spec = (b"" if data is None else data.tobytes())
        parts = [p for p in spec.split(b"\x00") if p]
        lpath = parts[-1].decode("ascii", "replace") if parts else ""
        if len(parts) > 1 and parts[0] not in (b"", b".", b"/"):
            raise ValueError(
                f"cross-file ADF link to '{parts[0].decode()}' unsupported")
        # build WITHOUT link resolution to avoid link-to-link cycles
        target = _AdfReader(self.buf, self.path).read_tree(
            resolve_links=False)
        for comp in lpath.strip("/").split("/"):
            if not comp:
                continue
            target = target[comp]
        out = AdfNode(nd["name"], target.label, target.data_type,
                      target.dims, target._data)
        out._children = target._children
        return out


def read_adf_tree(path: str) -> AdfNode:
    """Parse an ADF file into an in-memory node tree."""
    with open(path, "rb") as f:
        buf = f.read()
    return _AdfReader(buf, path).read_tree()


def is_adf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# Writer (fixtures + hdf5_to_adf conversion)
# ---------------------------------------------------------------------------

class _Rec:
    __slots__ = ("payload", "addr")

    def __init__(self, payload: bytes):
        self.payload = payload
        self.addr = 0


class _AdfWriter:
    """Two-pass writer: allocate record addresses, then patch pointers."""

    def __init__(self):
        self.records: List[_Rec] = []
        self.cursor = 256          # file header region

    def _alloc(self, size: int) -> int:
        addr = self.cursor
        self.cursor += size
        return addr

    def write_tree(self, root: AdfNode, path: str):
        blobs: List[Tuple[int, bytes]] = []

        def emit_node(node: AdfNode) -> int:
            # data first
            data_ptr, n_chunks = None, 0
            dims: Tuple[int, ...] = ()
            dt = node.data_type or "MT"
            raw = b""
            if node._data is not None:
                arr = np.asarray(node._data)
                logical = arr.T                      # undo the C view
                dims = logical.shape
                if arr.dtype == np.int8 and dt in ("C1", ""):
                    dt = "C1"
                    raw = logical.tobytes(order="F")
                else:
                    tag = {np.dtype(np.int32): "I4",
                           np.dtype(np.int64): "I8",
                           np.dtype(np.uint32): "U4",
                           np.dtype(np.float32): "R4",
                           np.dtype(np.float64): "R8",
                           np.dtype(np.int8): "B1"}.get(arr.dtype)
                    if tag is None:
                        logical = logical.astype(np.float64)
                        tag = "R8"
                    dt = tag
                    raw = np.asarray(logical, order="F").tobytes(order="F")
                n_chunks = 1
                size = 4 + 12 + len(raw) + 4
                data_ptr = self._alloc(size)
                end_tag_addr = data_ptr + 4 + 12 + len(raw)
                blobs.append((data_ptr, _TAG_DATA
                              + _ptr_bytes(end_tag_addr) + raw
                              + _TAG_DATA_END))
            elif dt == "":
                dt = "MT"
            # children
            child_addrs = []
            for cname in node:
                child_addrs.append(emit_node(node[cname]))
            snt_ptr = None
            if child_addrs:
                size = 4 + SUBNODE_ENTRY_SIZE * len(child_addrs) + 4
                snt_ptr = self._alloc(size)
                ents = b"".join(
                    _str32(node[cname].name) + _ptr_bytes(a)
                    for cname, a in zip(node, child_addrs))
                blobs.append((snt_ptr, _TAG_SNT + ents + _TAG_SNT_END))
            # header
            haddr = self._alloc(NODE_HEADER_SIZE)
            dims12 = list(dims) + [0] * (12 - len(dims))
            hdr = (_TAG_NODE + _str32(node.name) + _str32(node.label)
                   + _hex(len(child_addrs), 8) + _hex(len(child_addrs), 8)
                   + (_ptr_bytes(snt_ptr) if snt_ptr is not None
                      else NULL_PTR)
                   + _str32(dt) + _hex(len(dims), 2)
                   + b"".join(_hex(d, 8) for d in dims12)
                   + _hex(n_chunks, 4)
                   + (_ptr_bytes(data_ptr) if data_ptr is not None
                      else NULL_PTR)
                   + _TAG_NODE_END)
            assert len(hdr) == NODE_HEADER_SIZE, len(hdr)
            blobs.append((haddr, hdr))
            return haddr

        # force the ROOT header to the lowest node address so the reader's
        # first-NoDe scan finds it: reserve its slot now, emit its record
        # structure after the subtree
        root_slot = self._alloc(NODE_HEADER_SIZE)
        sub_root = AdfNode(root.name, root.label, root.data_type,
                           root.dims, root._data)
        sub_root._children = root._children
        real_addr = emit_node(sub_root)
        # move the root header payload into the reserved slot
        for i, (a, payload) in enumerate(blobs):
            if a == real_addr:
                blobs[i] = (root_slot, payload)
                break

        header = bytearray(256)
        what = MAGIC + b" A02015>"
        header[0:len(what)] = what
        header[32:36] = b"AdF0"
        header[36:64] = b"Thu Jan  1 00:00:00 1970    "
        header[64:68] = b"AdF1"
        header[68:96] = b"Thu Jan  1 00:00:00 1970    "
        header[96:100] = b"AdF2"
        header[100] = ord("L")           # IEEE little-endian
        header[101] = ord("B")
        header[102:106] = b"AdF3"
        header[106:118] = _ptr_bytes(root_slot)
        header[118:130] = _ptr_bytes(self.cursor)
        header[130:142] = NULL_PTR
        header[142:146] = b"AdF4"

        out = bytearray(self.cursor)
        out[0:256] = header
        for a, payload in blobs:
            out[a:a + len(payload)] = payload
        with open(path, "wb") as f:
            f.write(bytes(out))


def write_adf_tree(root: AdfNode, path: str) -> None:
    _AdfWriter().write_tree(root, path)


# ---------------------------------------------------------------------------
# Flavor converters
# ---------------------------------------------------------------------------

def _h5_to_node(g, name: str) -> AdfNode:
    """Recursive HDF5-CGNS group -> AdfNode."""
    label = g.attrs.get("label", b"")
    if isinstance(label, np.ndarray):
        label = label.tobytes()
    label = label.split(b"\x00")[0].decode("ascii", "replace")
    dtag = g.attrs.get("type", b"MT")
    if isinstance(dtag, np.ndarray):
        dtag = dtag.tobytes()
    dtag = dtag.split(b"\x00")[0].decode("ascii", "replace")
    data = np.asarray(g[" data"]) if " data" in g else None
    node = AdfNode(name, label, dtag, (), data)
    for key in g:
        if key.startswith(" "):
            continue
        node.add_child(_h5_to_node(g[key], key))
    return node


def hdf5_to_adf(src: str, dst: str) -> None:
    """Convert a CGNS-HDF5 file to ADF flavor."""
    import h5py

    with h5py.File(src, "r") as f:
        root = AdfNode("ADF MotherNode", "Root Node of ADF File", "MT",
                       (), None)
        for key in f:
            if key.startswith(" "):
                continue
            root.add_child(_h5_to_node(f[key], key))
    write_adf_tree(root, dst)


def _node_to_h5(parent, node: AdfNode) -> None:
    g = parent.create_group(node.name)
    g.attrs.create("name", np.bytes_(node.name.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("label", np.bytes_(node.label.ljust(33, "\x00")[:33]),
                   dtype="S33")
    g.attrs.create("type", np.bytes_(
        (node.data_type or "MT").ljust(3, "\x00")[:3]), dtype="S3")
    g.attrs.create("flags", np.array([1], np.int32))
    if node._data is not None:
        g.create_dataset(" data", data=np.ascontiguousarray(node._data))
    for cname in node:
        _node_to_h5(g, node[cname])


def adf_to_hdf5(src: str, dst: str) -> None:
    """Convert an ADF-flavor CGNS file to HDF5 flavor (the documented
    conversion path; equivalent to cgnslib's adf2hdf)."""
    import h5py

    root = read_adf_tree(src)
    with h5py.File(dst, "w") as f:
        f.attrs.create("name", np.bytes_(
            "HDF5 MotherNode".ljust(33, "\x00")), dtype="S33")
        f.attrs.create("label", np.bytes_(
            "Root Node of HDF5 File".ljust(33, "\x00")), dtype="S33")
        f.attrs.create("type", np.bytes_("MT\x00"), dtype="S3")
        f.create_dataset(" format", data=np.frombuffer(
            b"IEEE_LITTLE_32\x00", dtype=np.int8))
        for cname in root:
            _node_to_h5(f, root[cname])
