"""What the solver waits a DLB step: the window over the repartitions
completed in it, in ms."""


def read(ctx):
    return 1e3 * ctx["window_s"] / len(ctx["times_s"])
