"""PyTorch/CUDA port of the RGB-D semantic SLAM system.

This package is the port of ``dynamic_visual_slam_tpu`` (the JAX reference,
which stays in the repository unchanged) to PyTorch on an NVIDIA H100.  It
mirrors the reference's module paths and public names.  Plain tensor code is
PyTorch; each Pallas kernel of the reference is a CUDA C++ kernel under
``csrc/``, built at first use by ``kernels.py``.

The package imports neither ``jax`` nor anything of the reference package:
it keeps its own copies of the configuration, the synthetic data source and
the ORB sampling pattern.

Entry points default to ``device="cuda"`` and raise when no card is present;
tests pass ``device="cpu"``, where every kernel wrapper computes its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry code (DLT nullspaces, Gauss-Newton normal equations, the banded
# blur matrices) needs true f32 matmuls: TF32 keeps ~3 decimal digits, which
# breaks the blur's integer rounding and LM convergence.  Mirrors the
# reference's "highest" default matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from dynamic_visual_slam_tpu_torch.config import SLAMConfig  # noqa: E402,F401
