"""K3b's least time (gate recompute, recurrence, dW) for the traced steps over its kernels' device time."""

from portbench.flops import KERNELS


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    dev, bound = t.kernel_seconds(KERNELS["K3b"]), t.bounds.get("K3b", 0.0)
    return 100 * bound / dev if dev and bound else None
