"""Mean ms of the program's ``stream.decode`` span: host time to decode one wav (host I/O)."""

from interspeech_ser_tpu_torch.utils import profiling


def read(ctx):
    snapshot = getattr(profiling, "snapshot", None)  # a program without the spans reads nothing
    n, s = snapshot()["spans"].get("stream.decode", (0, 0.0)) if snapshot else (0, 0.0)
    return 1e3 * s / n if n else None
