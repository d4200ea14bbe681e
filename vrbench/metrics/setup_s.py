"""setup_s: seconds from the process's start to the window's first step:
imports, the inputs made from the seed, the scene's load and upload, the
kernels' build (the first run in a checkout compiles them) and the
warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
