"""Data pipeline: the balanced training-data packer, the synthetic
corpus and random batches, and the serving engine's first-fit packer."""
from .packing import (SyntheticCorpus, attention_cost, balanced_pack,
                      first_fit_pack, greedy_pack, pack_batches,
                      random_batch)

__all__ = ["SyntheticCorpus", "attention_cost", "balanced_pack",
           "first_fit_pack", "greedy_pack", "pack_batches", "random_batch"]
