"""From the process's start to the first timed repartition: imports, the
CUDA context, the kernel library, the inputs built on the device and
the warm-up repartitions."""


def read(ctx):
    return ctx["setup_s"]
