"""Spans: named intervals of the port's host work, timed where it happens.

``with span("volren_tpu_torch.pool"): ...`` times its body on
``time.perf_counter_ns()``, the clock of a caller's ``time.perf_counter()``,
so a caller can select the spans of its own steps.

- Tracing off (no ``recording()`` context active and no torch profiler
  running): a span adds its duration to its name's count and total
  (``totals()``) and does nothing else; it enters no profiler event.
- Tracing on: a span also keeps a record in memory (``recorded()``): its
  name, the index of the span it opened inside on its thread, its start and
  end, and its thread; up to ``CAP`` records, the rest counted by
  ``dropped()``. While a profiler runs it also opens a record function of
  its name (torch's ``RecordFunctionFast``: about 1 µs under a profiler,
  where ``torch.profiler.record_function`` takes 8-10 µs whether or not one
  runs) and takes its own times inside it, so the profiler's trace names
  the span and a leaf span's time leaves out that event's cost.
  ``profiler_ns`` puts a record on the profiler's clock (CLOCK_REALTIME
  nanoseconds, kineto's ``start_ns()``).

The port's spans (``volren_tpu_torch.`` and): ``trace`` (``Renderer.trace``)
holds ``tables`` (``_kernel_scene``; ``pack`` inside it where the tables are
packed again), ``params`` (``_trace_params``), and per dispatch ``pool``
(the NEE pool's draw), ``launch`` (``parallel.sharding.render_sharded``) and
``mean`` (the running mean), or ``oracle`` per oracle launch; the scene's
set-up has ``environment`` (the sky's importance pyramid), ``alias``
(``ops.scene.upload_environment``) and ``commit`` (``Renderer.commit``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

CAP = 1_000_000   # records kept in memory; later ones are counted, not kept

_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_annotation = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index in ``recorded()`` of the
    span it opened inside on its thread (None at the top, or where that one
    was dropped), ``end_ns`` None while it is open."""

    name: str
    parent: int | None
    start_ns: int
    end_ns: int | None
    thread: int


_lock = threading.Lock()
_local = threading.local()   # .totals: {name: [count, ns]}, .stack: open records' indices
_thread_totals: list = []    # every thread's .totals, for totals()
_records: list = []          # [name, parent, start, end, thread]
_dropped = 0
_recording = 0               # active recording() contexts
_offset_ns = 0               # the profiler's clock minus perf_counter_ns


def _thread_state() -> dict:
    """This thread's totals, made on its first span."""
    try:
        return _local.totals
    except AttributeError:
        _local.totals, _local.stack = {}, []
        with _lock:
            _thread_totals.append(_local.totals)
        return _local.totals


class span:
    """Context manager: time the body under ``name`` (the module docstring)."""

    __slots__ = ("name", "_t0", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rec = None
        if _recording or _profiling():
            self._open()
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        try:
            totals = _local.totals
        except AttributeError:
            totals = _thread_state()
        count = totals.get(self.name)
        if count is None:
            count = totals[self.name] = [0, 0]
        count[0] += 1
        count[1] += t1 - self._t0
        if self._rec is not None:
            self._close(t1)
        return False

    def _open(self):
        global _dropped, _offset_ns
        _thread_state()
        stack = _local.stack
        if not stack:
            _offset_ns = time.time_ns() - _now()
        rec = [self.name, stack[-1] if stack else None, 0, None, threading.get_ident()]
        with _lock:
            if len(_records) < CAP:
                stack.append(len(_records))
                _records.append(rec)
            else:
                stack.append(None)
                _dropped += 1
        self._rec = rec
        self._rf = None
        if _profiling():
            self._rf = _annotation(self.name)
            self._rf.__enter__()

    def _close(self, t1: int):
        self._rec[2], self._rec[3] = self._t0, t1
        _local.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)


@contextlib.contextmanager
def recording():
    """Record every span inside, on every thread, with no profiler."""
    global _recording, _offset_ns
    with _lock:
        _recording += 1
    _offset_ns = time.time_ns() - _now()
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def recorded() -> list[Span]:
    """The records kept, in the order the spans opened."""
    with _lock:
        records = list(_records)
    return [Span(*r) for r in records]


def totals() -> dict[str, tuple[int, float]]:
    """Every span name's (count, total seconds) in this process, traced or
    not, over all threads."""
    with _lock:
        per_thread = [dict(t) for t in _thread_totals]
    out: dict = {}
    for t in per_thread:
        for name, (n, ns) in t.items():
            c, s = out.get(name, (0, 0.0))
            out[name] = (c + n, s + ns * 1e-9)
    return out


def dropped() -> int:
    """The records not kept since ``clear()``: those beyond ``CAP``."""
    return _dropped


def profiler_ns(record: Span) -> tuple[int, int | None]:
    """A record's (start, end) on the profiler's clock, by the offset
    between the two clocks sampled when recording last started (at each
    top-level span while tracing is on, and on entering ``recording()``)."""
    return (record.start_ns + _offset_ns,
            None if record.end_ns is None else record.end_ns + _offset_ns)


def clear():
    """Forget the records, the dropped count and the totals."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
        for t in _thread_totals:
            t.clear()
