"""Mean ms of the program's ``forward.encoder`` span: a batch's encoder work enqueued on the host (encoder step)."""

from interspeech_ser_tpu_torch.utils import profiling


def read(ctx):
    snapshot = getattr(profiling, "snapshot", None)  # a program without the spans reads nothing
    n, s = snapshot()["spans"].get("forward.encoder", (0, 0.0)) if snapshot else (0, 0.0)
    return 1e3 * s / n if n else None
