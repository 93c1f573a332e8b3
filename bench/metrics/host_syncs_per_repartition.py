"""Calls inside ``Balancer.balance`` that make the host wait for the
card, a repartition: the program's ``host_syncs`` count on its
``balance`` span (``bench.program``)."""
from bench import program


def read(ctx):
    return program.reading(ctx, "host_syncs")
