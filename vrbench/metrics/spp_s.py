"""spp_s: samples per pixel completed over the whole window, at the cell's
frame size: every step's samples over the window's seconds, from its first
step's start to its last step's end (host clock)."""

from vrbench.stats import rate


def read(ctx):
    return rate([r[4] for r in ctx.records], ctx.t_start, ctx.t_end)
