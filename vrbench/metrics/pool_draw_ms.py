"""pool_draw_ms: the mean host milliseconds of a dispatch's NEE pool draw
(the program's span ``volren_tpu_torch.pool``: numpy's uniforms, the pinned
copy, the draw kernel's launch), over the traced window's device slice
(host clock; vrbench.program_spans)."""

from vrbench.program_spans import in_device_slice

POOL = "volren_tpu_torch.pool"


def read(ctx):
    got = in_device_slice(ctx)
    if got is None:
        return None
    records, inside = got
    ms = [(records[i].end_ns - records[i].start_ns) * 1e-6 for i in inside
          if records[i].name == POOL]
    return sum(ms) / len(ms) if ms else None
