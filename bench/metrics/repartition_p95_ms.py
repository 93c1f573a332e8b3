"""The 95th percentile of the window's repartitions, each timed on the
host clock to its synchronise, in ms."""
from bench.harness import p95


def read(ctx):
    return 1e3 * p95(ctx["times_s"])
