"""adflow_torch — the PyTorch/CUDA port of adflow_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``adflow_tpu``: the same module
layout and names, plain PyTorch for the tensor code, and hand-written CUDA
kernels (``adflow_torch/csrc``) where the JAX package has Pallas kernels.
It imports neither JAX nor anything of ``adflow_tpu``.

The public entry point mirrors the reference Python API: ``ADFLOW(options,
mesh)`` runs on ``cuda:0`` unless given another ``device``.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-precision f32 matmuls and convolutions (counterpart of
# adflow_tpu/__init__.py:20-27): TF32 keeps ~3 decimal digits, which would
# perturb the wall-distance candidate ranking (xc @ centers.T) and the 5x5
# line-PC block solves of the implicit solvers.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from adflow_torch.options import get_default_options, Options  # noqa: E402,F401
from adflow_torch.core.refstate import ReferenceState, AeroProblem  # noqa: E402,F401
from adflow_torch.api.solver import ADFLOW, Solver  # noqa: E402,F401
