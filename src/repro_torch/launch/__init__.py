"""Launchers: the production mesh and its rules, the training loop
(``launch.train``), the production dry-run (``launch.dryrun``) and its
roofline analysis."""
from .mesh import arch_rules, decode_rules, make_production_mesh

__all__ = ["arch_rules", "decode_rules", "make_production_mesh"]
