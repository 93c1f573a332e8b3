"""ms a repartition in the migrate stage, from a span around the stage
function the registry resolves, synchronised at both ends."""


def read(ctx):
    return (ctx["spans"] or {}).get("migrate")
