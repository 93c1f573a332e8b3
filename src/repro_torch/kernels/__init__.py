"""Hand-written Hopper kernels for the main path, with their plain versions.

Each kernel ships four pieces:

  csrc/<name>.cu   the CUDA C++ kernel for sm_90a, plain C entry point
  <name>.py        the wrapper: checks, allocation, launch, launch count
  ref.py           the plain PyTorch version (CPU path and yardstick)
  ops.py           dispatch on ``use_pallas`` (library code calls these)

Kernels (the TPU kernel each replaces is named in its source):

  sfc_keys       Morton / Hilbert keys, one thread per element
  ksection_hist  k-section candidate-cut weight histogram
  fem_matvec     P1 element matvec with precomputed 4x4 element matrices

``build.py`` compiles ``csrc/*.cu`` with nvcc at first use on a CUDA
tensor; nothing is built at import.
"""
from .ops import (fem_matvec_op, ksection_histogram_op, launch_counts,
                  reset_launch_counts, sfc_keys_op)
