"""trace_host_ms: the mean host milliseconds of a ``Renderer.trace`` call,
the span around it with no sync inside (the pool's uniforms and draw, the
parameter block, the launches, the running mean), over the window's calls
before the traced slices (the profiler's own host cost is left out)."""


def read(ctx):
    end = ctx.profile_first if ctx.profile_first is not None else len(ctx.records)
    spans = [(r[2] - r[1]) * 1e3 for r in ctx.records[:end]]
    return sum(spans) / len(spans) if spans else None
