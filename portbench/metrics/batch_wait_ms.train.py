"""Mean ms a training step waited in ``next()`` on the prefetch loader (fusion batches)."""


def read(ctx):
    s = ctx.spans.get("batch_wait")
    return 1e3 * sum(s) / len(s) if s else None
