"""``ksection_hist``'s share of its roofline: the least time its calls could
take (``bench.yardstick``) over their device time between CUDA events,
in %."""


def read(ctx):
    t, bound = (ctx["kernels"] or {}).get("ksection_hist", (0.0, 0.0))
    return 100.0 * bound / t if t > 0 else None
