"""device_idle_pct: the share of a step's time in which no kernel, copy or
memset ran on the card: 1 minus the device's busy time a step, the union of
their intervals in torch.profiler's trace of the card alone over the
traced window's device slice, over the mean period of a step in the same
window's untraced part (host clock; vrbench.profile). It also reads
``device_idle_pct.step``, the same quantity in the cells whose end-to-end
metric is a step's latency."""

from vrbench.profile import idle_pct, untraced_step_s


def read(ctx):
    return idle_pct(ctx.profile, untraced_step_s(ctx.records, ctx.profile_first))
