"""torch.profiler over two slices at the end of a traced window, reduced to
what the metrics read.

- The device slice records the card's activity alone: the device's busy
  time, the union of its work, over the slice's steps, and the device time
  by operation name. The idle share sets the busy time a step against the
  period of a step in the untraced part of the same window: the profiler
  lengthens the host's work a step (CUPTI's record of each runtime call,
  and with the host recorded, each operator), and with it the slice's.
- The labelled slice after it records the host too, and names each of its
  idle intervals by what the host was doing; it feeds ``breakdown`` alone.
"""

from __future__ import annotations

import contextlib
import sys
from typing import NamedTuple

import numpy as np

from .stats import gaps, union_length, union_of

# the device activities of a kineto trace that are work on the card
# ("device": a card event that is no annotation, where torch's events do
# not name their activity)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "device")
# names of spans, not work: the harness's, the program's and the profiler's
SPAN_PREFIXES = ("vrbench.", "volren_tpu_torch.", "ProfilerStep")
# the harness's span around each step; every span of the program nests in it
STEP_SPAN = "vrbench.step"


class Profile(NamedTuple):
    """A traced window's readings: ``window_s`` the device slice's length on
    the host clock, from its first step's start to its last step's end,
    ``busy_s`` the union of the device's work inside it (one card), ``steps``
    the steps it holds, ``device_ops`` [name, seconds] by its device time,
    and ``idle_gaps``
    [what the host was doing, seconds] over the labelled slice's idle
    intervals, both sorted longest first."""

    window_s: float
    busy_s: float
    steps: int
    device_ops: list
    idle_gaps: list


def start(host: bool):
    """A running profiler of the card, and of the host's operators and spans
    where ``host``. It keeps the events of every cycle: torch may end a cycle
    on its own (``acc_events``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = profile(activities=activities, acc_events=True)
    prof.__enter__()
    return prof


def warm_up():
    """Start and stop each kind of profiler once around a card op, so that
    its first start (seconds of CUPTI's set-up) falls in set-up, not in the
    window."""
    import torch

    for host in (False, True):
        prof = start(host)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)


def end(prof):
    """Stop a running profiler; its events are reduced later (``stop``)."""
    prof.__exit__(None, None, None)


def _events(prof, what: str):
    """A stopped profiler's (host events, device work, step spans), each as
    (start s, end s, name) on the profiler's clock."""
    host, device, steps, kinds = [], [], [], {}
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    for e in events:
        t0 = (e.start_ns() - base) * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        kind = _kind(e)
        key = f"{e.device_type()}:{kind}"
        kinds[key] = kinds.get(key, 0) + 1
        if str(e.device_type()).endswith("CUDA"):
            if kind in DEVICE_WORK:
                device.append((t0, t1, e.name()))
        elif e.name() == STEP_SPAN:
            steps.append((t0, t1))
        else:
            host.append((t0, t1, e.name()))
    print(f"vrbench: {what} slice: events by kind {kinds}", file=sys.stderr, flush=True)
    return host, device, steps


def reduce(device_prof, window_s: float, n_steps: int, labelled_prof=None) -> Profile | None:
    """The readings of the two slices' stopped profilers. ``window_s`` is the
    device slice's length on the host clock and ``n_steps`` its steps: that
    slice starts and stops between steps, each of which ends in a device
    sync, so every device interval it records lies inside that length. None
    where the device slice recorded no device work."""
    _, device, _ = _events(device_prof, "device")
    host, l_device, steps = (_events(labelled_prof, "labelled") if labelled_prof is not None
                             else ([], [], []))
    if not device:
        return None
    by_op: dict = {}
    for a, b, name in device:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    by_host: dict = {}
    if steps:
        lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
        busy = union_of([(max(a, lo), min(b, hi)) for a, b, _ in l_device if b > lo and a < hi])
        idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:MAX_LABELLED]
        at = _HostAt(host, steps)
        for a, b in idle:
            label = at(0.5 * (a + b))
            by_host[label] = by_host.get(label, 0.0) + (b - a)
    busy_s = union_length(union_of([(a, b) for a, b, _ in device]))
    return Profile(window_s, busy_s, n_steps, _top(by_op), _top(by_host))


# the longest idle intervals a slice labels by what the host was doing
MAX_LABELLED = 5000


def _kind(e) -> str:
    """The kineto activity of an event: torch's name for it where its
    events carry one, else "device" for a card event that is no span."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    annotation = (getattr(e, "is_user_annotation", lambda: False)()
                  or e.name().startswith(SPAN_PREFIXES))
    if str(e.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if annotation else "device"
    return "user_annotation" if annotation else "cpu_op"


class _HostAt:
    """What the host was doing at a time: the innermost recorded host event
    around it (an annotation of the program, an aten op, a runtime call),
    or, outside any, whether it was inside a step or between steps."""

    def __init__(self, host, steps):
        self.a = np.array([h[0] for h in host])
        self.b = np.array([h[1] for h in host])
        self.names = [h[2] for h in host]
        self.steps = np.array(steps).reshape(-1, 2)

    def __call__(self, t: float) -> str:
        inside = np.nonzero((self.a <= t) & (t <= self.b))[0]
        if inside.size:
            return self.names[int(inside[np.argmin(self.b[inside] - self.a[inside])])]
        if ((self.steps[:, 0] <= t) & (t <= self.steps[:, 1])).any():
            return "python in a step, outside any recorded call"
        return "between steps"


def untraced_step_s(records, first) -> float | None:
    """The mean period of a step, start to start, over the window's steps
    before the traced slices (``first`` of them); None without any."""
    if not first:
        return None
    return (records[first][0] - records[0][0]) / first


def idle_pct(p: Profile | None, step_s: float | None) -> float | None:
    """100 (1 - the device slice's busy time a step / ``step_s``, the
    untraced steps' period); None without a slice, untraced steps or work
    on the card."""
    if p is None or not step_s or p.busy_s <= 0.0 or p.steps <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.steps / step_s)


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def maybe(enabled: bool):
    """The span the window wraps around each step of the labelled slice (a
    null context elsewhere)."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(STEP_SPAN)
