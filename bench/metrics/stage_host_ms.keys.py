"""ms a repartition on the host clock in the program's span
``balance/keys``: the keys stage, no sync at either end
(``bench.program``)."""
from bench import program


def read(ctx):
    return program.stage_reading(ctx, "host_ms", "keys")
