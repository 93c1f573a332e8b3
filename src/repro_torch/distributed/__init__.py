"""The multi-device layer on ``torch.distributed``: collectives over a
process group and a helper that starts a world of ranks (``comm``), the
sharded balancing stages for the ``BalanceSpec`` registry (``stages``),
the legacy multi-device balancer (``DistributedBalancer``, deprecated)
and the all_to_all migration executor (``migrate``).

One process per rank: each rank holds its own shard, and the shards in
rank order are the JAX package's global arrays.  Importing this package
registers the sharded stages."""
from . import stages  # registers the sharded stage variants on import
from .balancer import DistributedBalancer
from .comm import BACKENDS, KINDS, Comm, DryComm, run_world
from .migrate import (MigrationResult, dispatch_slots, migrate_items,
                      payload_nbytes)
from .sharding import DEFAULT_RULES, spec_for
from .stages import build_balance_fn, check_world

__all__ = ["BACKENDS", "DEFAULT_RULES", "KINDS", "Comm", "DistributedBalancer",
           "DryComm", "MigrationResult", "build_balance_fn", "check_world",
           "dispatch_slots", "migrate_items", "payload_nbytes", "run_world",
           "spec_for", "stages"]
