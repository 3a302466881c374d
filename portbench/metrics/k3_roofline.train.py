"""K3's least time for the traced steps' recurrences over its device time in the trace."""

from portbench.flops import KERNELS


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev, bound = t.kernel_seconds(KERNELS["K3"]), t.bounds.get("K3", 0.0)
    return 100 * bound / dev if dev and bound else None
