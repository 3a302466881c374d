"""100 x (1 - the union of device activity over the traced slice's length)."""


def read(ctx):
    t = ctx.trace
    return 100 * (1 - t.busy_s / t.window_s) if t is not None and t.window_s > 0 else None
