"""100 x the program's ``stream.live_samples`` / ``stream.padded_samples``: real audio over the padded batches (host I/O)."""

from interspeech_ser_tpu_torch.utils import profiling


def read(ctx):
    snapshot = getattr(profiling, "snapshot", None)  # a program without the counters reads nothing
    counters = snapshot()["counters"] if snapshot else {}
    padded = counters.get("stream.padded_samples", 0)
    return 100 * counters.get("stream.live_samples", 0) / padded if padded else None
