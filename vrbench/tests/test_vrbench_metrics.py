"""The metric arithmetic: a rate over the whole window, the 95th percentile
over every step, the idle share from a union of intervals, the frozen work
bound against the program's ``measure.kernel_bound``, and the readers on a
window's records."""

from types import SimpleNamespace

import numpy as np
import pytest
from helpers_vrbench import brick_path, sky  # noqa: F401

from vrbench import stats
from vrbench.cell import reader
from vrbench import profile
from vrbench.profile import Profile


def test_rate_counts_all_the_work_over_all_the_time():
    # a stalled step counts with the rest: a median of chunks would not see it
    ctx = SimpleNamespace(records=[(0, 0, 0, 1.0, 1024), (1.0, 1.0, 1.0, 4.0, 1024),
                                   (4.0, 4.0, 4.0, 5.0, 1024)], t_start=0.0, t_end=5.0)
    assert reader("spp_s")(ctx) == pytest.approx(3 * 1024 / 5.0)
    assert stats.rate([4] * 10, 2.0, 4.0) == 20.0


def test_p95_is_over_every_step():
    steps = [(i * 0.01, i * 0.01, i * 0.01, i * 0.01 + (0.050 if i % 20 == 0 else 0.005), 4)
             for i in range(200)]
    ctx = SimpleNamespace(records=steps)
    want = float(np.percentile([(r[3] - r[0]) * 1e3 for r in steps], 95))
    assert reader("step_ms_p95")(ctx) == pytest.approx(want)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_idle_share_is_one_minus_the_union():
    busy = stats.union_of([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 9.0)])
    assert busy == [(0.0, 3.0), (5.0, 6.0)]
    assert stats.union_length(busy) == 4.0
    assert stats.gaps(busy, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.gaps(busy, 1.0, 5.5) == [(3.0, 5.0)]
    # 4 s busy over 8 profiled steps, against untraced steps of 1.25 s
    recs = [(1.25 * i, 0, 0, 1.25 * i + 1.2, 4) for i in range(10)]
    ctx = SimpleNamespace(profile=Profile(11.0, 4.0, 8, [], []), records=recs, profile_first=4)
    assert profile.untraced_step_s(recs, 4) == pytest.approx(1.25)
    assert reader("device_idle_pct")(ctx) == pytest.approx(60.0)
    assert reader("device_idle_pct")(SimpleNamespace(profile=None, records=recs,
                                                     profile_first=None)) is None
    assert reader("device_idle_pct")(SimpleNamespace(profile=ctx.profile, records=recs,
                                                     profile_first=0)) is None


def test_trace_host_ms_leaves_out_the_profiled_steps():
    recs = [(0, 0.0, 0.001, 0.005, 4), (0, 0.0, 0.003, 0.005, 4), (0, 0.0, 0.050, 0.06, 4)]
    assert reader("trace_host_ms")(SimpleNamespace(records=recs, profile_first=2)) == \
        pytest.approx(2.0)
    assert reader("trace_host_ms")(SimpleNamespace(records=recs, profile_first=None)) == \
        pytest.approx(18.0)


def test_frozen_bound_is_measure_kernel_bound(sky):
    from volren_tpu_torch.measure import kernel_bound as program_bound
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params
    from volren_tpu_torch.renderer import Renderer
    from volren_tpu_torch.scene.environment import Environment
    from volren_tpu_torch.voldata import Volume

    from vrbench.roofline import kernel_bound

    r = Renderer(device="cpu")
    r.volume = Volume(brick_path())
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(sky))
    r.init(64, 48)
    r.commit()
    ks, tp = r._kernel_scene(), r._trace_params()
    pool = build_env_pool(r._env_device, 5, 0)
    pf, pi = build_params(ks, tp, 64, 48, 0, 4)
    events = {"regen": 12288, "march": 4_100_000, "test": 900_000, "emission": 0,
              "nee": 300_000, "escape": 12_000, "scatter": 290_000}
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (ks.atlas, ks.slot, ks.lo, ks.hi, ks.mip, ks.env, pool))
    assert kernel_bound(n_bytes, 64 * 48, events) == program_bound(ks, pool, pi, events)


class _Event:
    """A kineto event as vrbench.profile reads it."""

    def __init__(self, name, t0_ms, t1_ms, card):
        self._n, self._a, self._b, self._card = name, t0_ms, t1_ms, card

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._a * 1e6)

    def duration_ns(self):
        return int((self._b - self._a) * 1e6)

    def device_type(self):
        return "DeviceType.CUDA" if self._card else "DeviceType.CPU"


def _stopped(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_idle_share_takes_the_busy_time_of_the_card_alone():
    # the device slice holds the card's work alone: two overlapping kernels
    # and a copy, 6 ms busy in a slice of 10 ms on the host clock
    device = _stopped([_Event("k", 0, 4, True), _Event("k", 2, 5, True),
                       _Event("Memcpy HtoD", 7, 8, True), _Event("cudaLaunchKernel", 0, 1, False)])
    labelled = _stopped([_Event("vrbench.step", 0, 10, False), _Event("aten::add", 5, 9, False),
                         _Event("k", 0, 5, True)])
    p = profile.reduce(device, 0.010, 1, labelled)
    assert p.window_s == 0.010 and p.busy_s == pytest.approx(0.006) and p.steps == 1
    # untraced steps of 10 ms
    ctx = SimpleNamespace(profile=p, records=[(0.0,), (0.010,), (0.020,)], profile_first=2)
    assert reader("device_idle_pct")(ctx) == pytest.approx(40.0)
    assert reader("device_idle_pct.step")(ctx) == pytest.approx(40.0)
    assert p.device_ops[0][0] == "k" and p.device_ops[0][1] == pytest.approx(0.007)
    # the labelled slice names its one idle interval, 5-10 ms, by the host op
    # around its middle
    assert p.idle_gaps == [["aten::add", pytest.approx(0.005)]]
    assert profile.reduce(_stopped([]), 0.010, 1, labelled) is None
