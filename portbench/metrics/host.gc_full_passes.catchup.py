"""host.gc_full_passes.catchup: the cyclic collector's full (generation 2)
passes in the replay window (the `process.gc-full` counter's window
delta).  None from a program that has no such counter."""


def read(ctx):
    if "process.gc-full" not in ctx.registry:
        return None
    return ctx.counter("process.gc-full")
