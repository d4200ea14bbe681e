"""The readers of the program's spans: ``trace_prelaunch_ms`` and
``pool_draw_ms`` count only the spans inside the device slice's steps,
``scene_setup_s`` sums the set-up spans' totals, and each reads None
without a device slice or in a program without the span module."""

import sys
import time
from types import SimpleNamespace

import pytest
from helpers_vrbench import ROOT  # noqa: F401

from vrbench.cell import reader
from vrbench.profile import Profile
from volren_tpu_torch.utils import spans

P = "volren_tpu_torch."
S = 1_000_000_000   # ns a second


def _step_spans(k, prelaunch_s, pool_s, dispatches=1):
    """A synthetic ``trace`` call of step ``k`` (starting at k + 0.1 s) and
    its children as the program records them, the parents' indices within
    the call."""
    t0 = int((k + 0.1) * S)
    out = [(P + "trace", None, t0, t0 + int(0.8 * S)),
           (P + "tables", 0, t0, t0 + 1000), (P + "params", 0, t0 + 1000, t0 + 2000)]
    at = t0 + int(prelaunch_s * S) - 1000 - int(pool_s * S)
    for _ in range(dispatches):
        out += [(P + "pool", 0, at, at + int(pool_s * S)),
                (P + "launch", 0, at + int(pool_s * S), at + int(pool_s * S) + 1000),
                (P + "mean", 0, at + int(pool_s * S) + 1000, at + int(pool_s * S) + 2000)]
        at += int(0.1 * S)
    return out


def _records(per_step):
    recs = []
    for k, args in enumerate(per_step):
        base = len(recs)
        recs += [spans.Span(n, None if p is None else base + p, a, b, 1)
                 for n, p, a, b in _step_spans(k, *args)]
    return recs


# four steps of one second: step 0 before the slices, 1-2 the device slice,
# 3 the labelled slice
STEPS = [(float(k), float(k), float(k) + 0.9, float(k) + 0.95, 4) for k in range(4)]


def _ctx(first=1, steps=2, profile=True):
    return SimpleNamespace(records=STEPS, profile_first=first,
                           profile=Profile(2.0, 1.5, steps, [], []) if profile else None)


@pytest.fixture
def synthetic(monkeypatch):
    recs = _records([(0.5, 0.3), (0.002, 0.0005, 2), (0.004, 0.0015), (0.7, 0.3)])
    monkeypatch.setattr(spans, "recorded", lambda: recs)
    monkeypatch.setattr(spans, "totals", lambda: {P + "environment": (1, 4.5),
                                                  P + "alias": (2, 0.25),
                                                  P + "commit": (1, 1.25),
                                                  P + "trace": (9, 100.0)})
    return recs


def test_only_the_device_slice_counts(synthetic):
    # the first launch's end, 2 and 4 ms after the call's start; the
    # second dispatch of step 1 is not the launch the card waits for
    assert reader("trace_prelaunch_ms")(_ctx()) == pytest.approx(3.0, abs=1e-3)
    assert reader("pool_draw_ms")(_ctx()) == pytest.approx((0.5 + 0.5 + 1.5) / 3)
    assert reader("trace_prelaunch_ms")(_ctx(first=3, steps=1)) == pytest.approx(700.0, abs=1e-3)
    assert reader("scene_setup_s")(_ctx()) == pytest.approx(6.0)


@pytest.mark.parametrize("name", ["trace_prelaunch_ms", "pool_draw_ms", "scene_setup_s"])
def test_none_without_a_slice_or_the_module(synthetic, monkeypatch, name):
    read = reader(name)
    assert read(_ctx(profile=False)) is None
    if name != "scene_setup_s":
        assert read(_ctx(first=None)) is None
        # a slice whose steps hold no span: steps 0.95-0.99 s
        assert read(SimpleNamespace(records=[(0.95, 0.95, 0.96, 0.99, 4)], profile_first=0,
                                    profile=Profile(0.04, 0.01, 1, [], []))) is None
    monkeypatch.setitem(sys.modules, "volren_tpu_torch.utils.spans", None)
    monkeypatch.delattr(sys.modules["volren_tpu_torch.utils"], "spans")
    assert read(_ctx()) is None


def test_scene_setup_s_none_without_set_up_spans(monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: {P + "trace": (1, 1.0)})
    assert reader("scene_setup_s")(_ctx()) is None


def test_the_program_clock_is_the_harness_clock():
    spans.clear()
    t0 = time.perf_counter()
    with spans.recording():
        with spans.span(P + "trace"):
            with spans.span(P + "pool"):
                time.sleep(0.002)
            with spans.span(P + "launch"):
                time.sleep(0.010)
    t1 = time.perf_counter()
    ctx = SimpleNamespace(records=[(t0, t0, t1, t1, 4)], profile_first=0,
                          profile=Profile(t1 - t0, 0.0, 1, [], []))
    try:
        assert 12.0 <= reader("trace_prelaunch_ms")(ctx) <= (t1 - t0) * 1e3
        assert 2.0 <= reader("pool_draw_ms")(ctx) < 12.0
    finally:
        spans.clear()
