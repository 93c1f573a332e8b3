"""ms a repartition on the host clock in the program's span
``balance/part_weights``: the final part-weight sum and imbalance, no
sync at either end (``bench.program``)."""
from bench import program


def read(ctx):
    return program.stage_reading(ctx, "host_ms", "part_weights")
