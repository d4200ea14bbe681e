"""scene_setup_s: the program's seconds of scene set-up in the run's
process, the sum of its spans ``volren_tpu_torch.environment`` (a sky's
importance pyramid built), ``.alias`` (the alias table and the sky's
upload) and ``.commit`` (the brick grids' upload). Imports, CUDA's start,
the brick file's load and the kernels' build are not in it (host clock;
vrbench.program_spans)."""

from vrbench.program_spans import module

SET_UP = ("volren_tpu_torch.environment", "volren_tpu_torch.alias", "volren_tpu_torch.commit")


def read(ctx):
    spans = module()
    if spans is None or ctx.profile is None:
        return None
    totals = spans.totals()
    seconds = [totals[name][1] for name in SET_UP if name in totals]
    return sum(seconds) if seconds else None
