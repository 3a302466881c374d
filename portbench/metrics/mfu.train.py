"""Forward and backward FLOPs of the window's training steps over (window seconds x the peak of the cell's dtype)."""

from portbench.flops import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    return 100 * w["flops"] / (w["seconds"] * PEAK_FLOPS[ctx.dtype]) if w["flops"] else None
