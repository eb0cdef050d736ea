"""Build the kernel sources of ``adflow_torch/csrc`` into shared libraries
with ``nvcc``; the wrappers load them with ``ctypes``.

Each source becomes its own library, named by the hash of the source and
the flags, under ``build/adflow_torch_kernels/`` at the repository root (the
directory ``.gitignore`` lists). A library is built once, at first use, on
the machine that has the card; nothing here runs when a module is imported.
What nvcc prints goes to a ``.log`` beside the library (``build_log``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
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
