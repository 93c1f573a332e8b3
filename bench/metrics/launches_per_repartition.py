"""Kernels the device ran in the profiled stretch, a repartition."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["launches"] or prof.get("lost_kernels"):
        return None
    return prof["launches"] / prof["reps"]
