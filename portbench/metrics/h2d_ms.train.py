"""Device ms of host-to-device copies a training step, from the trace (the batch's copy)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.items:
        return None
    s = t.copy_seconds("HtoD")
    return 1e3 * s / t.items if s else None
