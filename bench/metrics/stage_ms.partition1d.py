"""ms a repartition in the partition1d stage, from a span around the stage
function the registry resolves, synchronised at both ends."""


def read(ctx):
    return (ctx["spans"] or {}).get("partition1d")
