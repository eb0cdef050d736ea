#!/usr/bin/env python3
"""Run one cell of the benchmark of adflow_torch once, on the CUDA card of
the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It prints the cell's metrics as the last line
of its standard output (one JSON object) and the numbers its correctness
check compared, each beside its limit, as the last lines of its standard
error. See benchmark/README.md."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (the program
# builds its kernels into build/adflow_torch_kernels itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"
# one process with one host thread for math libraries: the card's host
# cores are shared, and the program's work on the host is one chain of
# launches
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# the checkout, not benchmark/, is where imports start
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
