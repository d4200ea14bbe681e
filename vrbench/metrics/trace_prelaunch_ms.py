"""trace_prelaunch_ms: the mean host milliseconds from the start of a
``Renderer.trace`` call (the program's span ``volren_tpu_torch.trace``) to
the end of its first ``volren_tpu_torch.launch`` child, the step's kernel
queued: the host work the card, idle since the last step's sync, waits
through. Over the calls in the traced window's device slice (host clock;
vrbench.program_spans)."""

from vrbench.program_spans import in_device_slice

TRACE, LAUNCH = "volren_tpu_torch.trace", "volren_tpu_torch.launch"


def read(ctx):
    got = in_device_slice(ctx)
    if got is None:
        return None
    records, inside = got
    traces = {i for i in inside if records[i].name == TRACE}
    queued = {}
    for i in inside:
        r = records[i]
        if r.name == LAUNCH and r.parent in traces and r.parent not in queued:
            queued[r.parent] = r.end_ns
    ms = [(end - records[t].start_ns) * 1e-6 for t, end in queued.items()]
    return sum(ms) / len(ms) if ms else None
