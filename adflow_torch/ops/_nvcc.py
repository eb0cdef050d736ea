"""Build the kernel sources of ``adflow_torch/csrc`` into shared libraries
with ``nvcc``; the wrappers load them with ``ctypes``. Also what the two
i-marching kernels' launch plans share (``segment``, ``n_sm``, the card's
limits).

Each source becomes its own library, named by the hash of the source and
the flags, under ``build/adflow_torch_kernels/`` at the repository root (the
directory ``.gitignore`` lists). Each source is self-contained (it includes
no header of ``csrc/``), so the hash of its own bytes names its build. A
library is built once, at first use, on the machine that has the card;
nothing here runs when a module is imported. What nvcc prints goes to a
``.log`` beside the library (``build_log``, ``ptxas_report``).
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232_448      # bytes a block may use on Hopper
SM_SMEM = 233_472         # bytes an SM shares among its blocks (228 KB)
SMEM_RESERVED = 1024      # bytes the runtime reserves per block
N_SM = 132                # SMs of an H100 SXM
MIN_SEGMENT = 4           # the warm-up plane costs at most a quarter
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "adflow_torch_kernels"
# -Xptxas -v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_path(src: Path) -> Path:
    """Where the shared library for ``src`` and the current flags goes."""
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_command(src: Path, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all(srcs) -> list:
    """Compile every source of ``srcs`` that has no library yet, one
    ``nvcc`` each, all started together; return the libraries."""
    outs = [library_path(Path(s)) for s in srcs]
    jobs = []
    for src, out in zip(srcs, outs):
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs.append((Path(src).name, tmp, out, subprocess.Popen(
                build_command(Path(src), tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, _, out, proc in jobs:
        log = proc.communicate()[0]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(name)
            print(log, file=sys.stderr)
    if failed:
        raise RuntimeError(f"nvcc failed to build {failed}")
    for _, tmp, out, _ in jobs:
        os.replace(tmp, out)
    return outs


def build_log(src: Path) -> str:
    """What nvcc printed when it built ``src`` (``-Xptxas -v``: registers,
    spills and shared memory of each kernel); empty if it has not."""
    log = library_path(Path(src)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(src: Path) -> Path:
    """Compile ``src`` if it has no library yet; return the library."""
    return build_all([src])[0]


def ptxas_report(src: Path) -> list:
    """The lines of ``src``'s build log that give its kernels' registers,
    spills and shared memory (``-Xptxas -v``)."""
    return [ln.strip() for ln in build_log(src).splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


@functools.lru_cache(maxsize=None)
def segment(ni, tiles, per_wave):
    """The segment length of an i-marching kernel that minimizes waves x
    (planes + warm-up) a block: the blocks of one wave share their SMs, so
    a wave takes about as long as one block's march. Cached: the search
    takes about as long as K2 itself, and each launch asks for its plan."""
    return min(range(min(MIN_SEGMENT, ni), ni + 1),
               key=lambda si: (-(-(-(-ni // si) * tiles) // per_wave)
                               * (si + 1), si))


@functools.lru_cache(maxsize=None)
def n_sm(device):
    """SMs of the card ``device``."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
