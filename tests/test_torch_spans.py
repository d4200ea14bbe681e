"""volren_tpu_torch.utils.spans on the CPU: with tracing off a span only
counts and times (no record, no profiler event); under ``recording()``
spans nest per thread; under torch.profiler each span is an event of the
same name over the same interval; the spans ``Renderer.trace`` and
the scene's set-up record; the cap on records."""

import threading
import time

import numpy as np
import pytest
import torch

from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene import environment
from volren_tpu_torch.utils import spans
from volren_tpu_torch.voldata import DenseGrid, Volume

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

P = "volren_tpu_torch."
DISPATCH = ("pool", "launch", "mean")


@pytest.fixture(autouse=True)
def _clear():
    spans.clear()
    yield
    spans.clear()


def _renderer(dense):
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, dense))
    r.scale_and_move_to_unit_cube()
    r.bounces, r.seed = 2, 3
    r.init(4, 4)
    r.commit()
    return r


def _count(name):
    return spans.totals().get(P + name, (0, 0.0))[0]


def _raise(*args, **kwargs):
    raise AssertionError("a profiler event entered with tracing off")


def test_off_counts_and_records_nothing(random_grid16, monkeypatch):
    monkeypatch.setattr(spans, "_annotation", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    r = _renderer(random_grid16)
    r.trace(4)
    r.trace(4)
    assert spans.recorded() == [] and spans.dropped() == 0
    got = spans.totals()
    for name in ("trace", "tables", "params") + DISPATCH:
        count, seconds = got[P + name]
        assert count == 2 and seconds > 0.0, name
    assert got[P + "commit"][0] == 1 and got[P + "pack"][0] == 1
    assert got[P + "trace"][1] >= got[P + "launch"][1]


@pytest.mark.parametrize("threads", [1, 2])
def test_recording_nests_per_thread(threads):
    start = threading.Barrier(threads)

    def work(tag):
        start.wait(timeout=10)
        with spans.span(f"outer{tag}"):
            with spans.span(f"inner{tag}"):
                time.sleep(0.002)
            with spans.span(f"second{tag}"):
                pass

    with spans.recording():
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=30)
            assert not t.is_alive()
    with spans.span("after"):
        pass
    recs = spans.recorded()
    assert len(recs) == 3 * threads
    for k in range(threads):
        i = next(j for j, s in enumerate(recs) if s.name == f"outer{k}")
        inner, second = (next(j for j, s in enumerate(recs) if s.name == f"{n}{k}")
                         for n in ("inner", "second"))
        outer = recs[i]
        assert outer.parent is None and recs[inner].parent == i and recs[second].parent == i
        assert i < inner < second
        assert len({outer.thread, recs[inner].thread, recs[second].thread}) == 1
        assert (outer.start_ns <= recs[inner].start_ns < recs[inner].end_ns
                <= recs[second].start_ns <= recs[second].end_ns <= outer.end_ns)
        assert recs[inner].end_ns - recs[inner].start_ns >= 2_000_000
    assert len({s.thread for s in recs}) == threads
    assert spans.totals()["after"][0] == 1


def test_profiler_annotates_each_span():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("volren_tpu_torch.test_outer"):
            with spans.span("volren_tpu_torch.test_sleep"):
                time.sleep(0.02)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = spans.recorded()
    assert [s.name for s in recs] == ["volren_tpu_torch.test_outer", "volren_tpu_torch.test_sleep"]
    assert recs[1].parent == 0
    for rec in recs:
        e = events[rec.name]
        a0, a1 = e.start_ns(), e.start_ns() + e.duration_ns()
        s0, s1 = spans.profiler_ns(rec)
        overlap = min(a1, s1) - max(a0, s0)
        assert overlap >= 0.9 * max(a1 - a0, s1 - s0), (rec.name, a0, a1, s0, s1)


@pytest.mark.parametrize("spp,dispatches", [(4, 1), (130, 3)])
def test_trace_records_its_spans(random_grid16, spp, dispatches):
    r = _renderer(random_grid16)
    with spans.recording():
        r.trace(spp)
    recs = spans.recorded()
    assert recs[0].name == P + "trace" and recs[0].parent is None
    children = [s.name[len(P):] for s in recs if s.parent == 0]
    assert children == ["tables", "params"] + list(DISPATCH) * dispatches
    assert [s.name for s in recs if s.parent == 1] == [P + "pack"]
    for s in recs[1:]:
        assert recs[0].start_ns <= s.start_ns <= s.end_ns <= recs[0].end_ns


def test_pack_only_when_the_tables_change(random_grid16):
    r = _renderer(random_grid16)
    r.trace(4)
    with spans.recording():
        r.trace(4)
        assert P + "pack" not in {s.name for s in spans.recorded()}
        r.set_environment(r.environment)
        r.trace(4)
    names = [s.name for s in spans.recorded()]
    assert names.count(P + "pack") == 1 and names.count(P + "alias") == 1


def test_oracle_launches_under_trace(random_grid16):
    r = _renderer(random_grid16)
    r.engine = "oracle"
    with spans.recording():
        r.trace(2)
    recs = spans.recorded()
    assert recs[0].name == P + "trace"
    assert [s.name for s in recs if s.parent == 0] == [P + "params", P + "oracle"]


def _environment(dense):
    # a sky too large for the content cache, at a small importance map
    environment.Environment(np.random.default_rng(1).random((8, 16, 3), np.float32))


def _commit(dense):
    _renderer(dense).commit()


def _upload(dense):
    r = _renderer(dense)
    r.set_environment(r.environment)


@pytest.mark.parametrize("name,action,adds", [("environment", _environment, 1),
                                              ("commit", _commit, 2), ("alias", _upload, 2)])
def test_set_up_adds_to_totals(random_grid16, monkeypatch, name, action, adds):
    Renderer(device="cpu")   # the white sky's pyramid at its size, cached before the count
    monkeypatch.setattr(environment, "DIMENSION", 64)
    monkeypatch.setattr(environment, "SAMPLES_PER_AXIS", 1)
    before = _count(name)
    action(random_grid16)
    assert _count(name) == before + adds
    assert spans.recorded() == []


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with spans.recording():
        with spans.span("a"):
            with spans.span("b"):
                pass
        with spans.span("c"):
            with spans.span("d"):
                with spans.span("e"):
                    pass
    recs = spans.recorded()
    assert [(s.name, s.parent) for s in recs] == [("a", None), ("b", 0), ("c", None)]
    assert spans.dropped() == 2
    assert {k: v[0] for k, v in spans.totals().items()} == dict.fromkeys("abcde", 1)
    spans.clear()
    assert spans.recorded() == [] and spans.dropped() == 0 and spans.totals() == {}
