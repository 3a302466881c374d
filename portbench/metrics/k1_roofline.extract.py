"""K1's least time for the traced batches (portbench/flops.py) over its device time in the trace."""

from portbench.flops import KERNELS


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev, bound = t.kernel_seconds(KERNELS["K1"]), t.bounds.get("K1", 0.0)
    return 100 * bound / dev if dev and bound else None
