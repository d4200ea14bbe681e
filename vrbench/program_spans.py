"""The program's own spans (``volren_tpu_torch.utils.spans``) for the
metrics that read them: the records inside a traced window's device slice,
and the process's totals. The profiler runs through that slice, so the
program records every span there. A program without the module (an older
tree) gives None, and so does a run without a device slice."""

from __future__ import annotations


def module():
    """``volren_tpu_torch.utils.spans``, or None where the program has no
    such module."""
    try:
        from volren_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def in_device_slice(ctx):
    """(every record, the indices of those inside the device slice's steps,
    from its first step's start to its last step's end on the host clock);
    None without a device slice or the module, or with no record inside."""
    spans = module()
    if spans is None or ctx.profile is None or ctx.profile_first is None:
        return None
    steps = ctx.records[ctx.profile_first:ctx.profile_first + ctx.profile.steps]
    if not steps:
        return None
    lo, hi = steps[0][0] * 1e9, steps[-1][3] * 1e9
    records = spans.recorded()
    inside = [i for i, r in enumerate(records)
              if r.end_ns is not None and lo <= r.start_ns and r.end_ns <= hi]
    return (records, inside) if inside else None
