"""Hand-written Hopper kernels for the main path, with their plain versions.

Each kernel ships four pieces:

  csrc/<name>.cu   the CUDA C++ kernel for sm_90a, plain C entry point
  <name>.py        the wrapper: checks, allocation, launch, launch count
  ref.py           the plain PyTorch version (CPU path and yardstick)
  ops.py           dispatch on ``use_pallas`` (library code calls these)

Kernels (the TPU kernel each replaces is named in its source):

  sfc_keys       Morton / Hilbert keys, one thread per element
  ksection_hist  k-section candidate-cut weight histogram
  fem_matvec     P1 element matvec with precomputed 4x4 element matrices,
                 two passes on a plan of the mesh, no atomics
  prefix_scan    exclusive prefix sum (Algorithm 1's S_i), one pass with a
                 look-back over tile aggregates, deterministic
  flash_attention  causal / sliding-window / GQA attention (full prefill);
                 bf16 on tensor cores, float32 on CUDA cores
  serve_prefill  segment-masked causal attention over a packed buffer;
                 bf16 on tensor cores (the body shared with flash attention,
                 csrc/attention_tc.cuh), float32 on CUDA cores

``build.py`` compiles ``csrc/*.cu`` with nvcc at first use on a CUDA
tensor; nothing is built at import.
"""
from .ops import (ElementOperator, exclusive_scan_op, fem_matvec_op,
                  flash_attention_op, ksection_histogram_op, launch_counts,
                  packed_attention_op, reset_launch_counts, sfc_keys_op)
