"""Mean ms the extraction loop waited in ``next()`` on the batch stream (host I/O)."""


def read(ctx):
    s = ctx.spans.get("batch_wait")
    return 1e3 * sum(s) / len(s) if s else None
