"""``cudaMalloc`` and ``cudaFree`` calls of the caching allocator inside
``Balancer.balance``, a repartition: the program's ``allocator_calls``
count on its ``balance`` span (``bench.program``); nothing without a
card."""
from bench import program


def read(ctx):
    return program.reading(ctx, "allocator_calls")
