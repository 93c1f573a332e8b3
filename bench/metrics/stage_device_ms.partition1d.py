"""ms a repartition on the card in the program's span
``balance/partition1d``: the partition1d stage (the k-section), between
CUDA events recorded on the stream as it opens and closes
(``bench.program``); nothing without a card."""
from bench import program


def read(ctx):
    return program.stage_reading(ctx, "device_ms", "partition1d")
