"""The whole step's share of the card's memory bandwidth: the least
bytes a repartition moves (``bench.yardstick.repartition_bytes``) at
HBM's peak, over the window's time a repartition, in %."""
from bench import yardstick


def read(ctx):
    least_s = (yardstick.repartition_bytes(ctx["n"], ctx["has_old"])
               / yardstick.HBM_BYTES_PER_S)
    return 100.0 * least_s * len(ctx["times_s"]) / ctx["window_s"]
