"""Core load-balancing library: the paper's contribution, in PyTorch.

``BalanceSpec`` describes the pipeline, the stage registry provides the
host (single-device) implementation of ``keys -> partition1d -> remap ->
migrate``, and ``Balancer`` runs it on a device.
``DynamicLoadBalancer`` is the deprecated eager shim.
``greedy_graph_partition`` is the graph-growing baseline the paper's
partitioners are compared against (host numpy, as the reference keeps
it).
"""
from .balancer import (DynamicLoadBalancer, LegacyBalanceResult,
                       _reset_deprecation_warning)
from .graph_greedy import greedy_graph_partition
from .metrics import imbalance, migration_volume, quality
from .partition1d import (Partition1DResult, distributed_prefix_parts,
                          exclusive_scan_over_axis, ksection,
                          ksection_splitters, ksection_splitters_counted,
                          prefix_sum_parts, sorted_exact, warm_start_boxes,
                          weight_below)
from .rcb import rcb_partition
from .remap import (apply_map, greedy_map, greedy_map_torch,
                    guarded_greedy_perm, remap, similarity_matrix)
from .rtree import RefinementForest, partition_dfs, rtk_partition_forest
from .sfc import (KeyCache, bounding_box, box_drift, box_map,
                  hilbert_decode, hilbert_encode, morton_decode,
                  morton_encode, refresh_key_cache, sfc_keys)
from .spec import (BACKENDS, METHODS, ONED_SOLVERS, SFC_METHODS, STAGES,
                   Balancer, BalanceResult, BalanceSpec, Spec, compute_cut,
                   get_stage, register_stage, resolve_variants,
                   stage_variants)

__all__ = [
    "BACKENDS", "METHODS", "ONED_SOLVERS", "SFC_METHODS", "STAGES",
    "BalanceResult", "BalanceSpec", "Balancer", "DynamicLoadBalancer",
    "KeyCache", "LegacyBalanceResult",
    "Partition1DResult", "RefinementForest", "Spec",
    "apply_map", "bounding_box", "box_drift", "box_map", "compute_cut",
    "distributed_prefix_parts", "exclusive_scan_over_axis",
    "get_stage", "greedy_graph_partition", "greedy_map", "greedy_map_torch",
    "guarded_greedy_perm",
    "hilbert_decode", "hilbert_encode", "imbalance", "ksection",
    "ksection_splitters", "ksection_splitters_counted", "migration_volume",
    "morton_decode", "morton_encode", "partition_dfs", "prefix_sum_parts",
    "quality", "rcb_partition", "refresh_key_cache", "register_stage",
    "remap", "resolve_variants", "rtk_partition_forest", "sfc_keys",
    "similarity_matrix", "sorted_exact", "stage_variants",
    "warm_start_boxes", "weight_below",
]
