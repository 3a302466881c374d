"""Mean ms of the program's ``forward.h2d`` span: a batch's inputs pinned and their copies enqueued (encoder step)."""

from interspeech_ser_tpu_torch.utils import profiling


def read(ctx):
    snapshot = getattr(profiling, "snapshot", None)  # a program without the spans reads nothing
    n, s = snapshot()["spans"].get("forward.h2d", (0, 0.0)) if snapshot else (0, 0.0)
    return 1e3 * s / n if n else None
