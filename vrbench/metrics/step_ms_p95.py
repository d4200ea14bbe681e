"""step_ms_p95: the 95th percentile over every step of the window of one
step's milliseconds, from the step's start (the camera set and the reset
where a group starts) to the end of its device sync (host clock)."""

from vrbench.stats import percentile


def read(ctx):
    return percentile([(r[3] - r[0]) * 1e3 for r in ctx.records], 95)
