"""The chunked schedule of the plain versions' lane loops on the card.

A plain version (``kernels.megakernel.render_plain``; the oracle's
``tracer.trace_path`` and the tracking loops of ``tracking.run_loop``)
runs its lanes through a masked step until every lane has ended, and sets
the ended lanes aside once they are half of the set. Asking after every
step how many lanes still run is a host sync, and between syncs the card
runs one small kernel at a time, each launched from Python. On CUDA
tensors the loops take a chunked schedule instead (``Schedule``):

- a chunk of steps runs with no host sync: a lane that ended within it
  runs on as a no-op under its masks, and the stats' counts add into int64
  tensors on the device, read once when the call returns;
- after a chunk one sync reads how many lanes still run: the loop stops at
  none, and sets the ended lanes aside once they are half of the set, down
  to a power of two of lanes no smaller than ``_MIN_LANES``, padded with
  ended ones (``cut``, ``keep``), which stay no-ops and are written back
  where they were;
- a chunk has ``_CHUNK`` steps on ``_LANE_STEPS // _CHUNK`` lanes or
  fewer, fewer steps on more lanes and one from ``_LANE_STEPS`` lanes up
  (``chunk``): there a step is long on the card and a check is cheap
  beside it, and ended lanes are set aside soon;
- every chunk of a loop but its first replays as the CUDA graph of its
  lane count and length, captured the first time on static copies of its
  state, into one memory pool a call. A step reads only its state and
  tensors that outlive the call (the scene's tables,
  ``geometry.device_const``'s constants, the call's own). The call frees
  its graphs and their memory when it returns.

Capturing a chunk costs about as much host time as running it eagerly,
and a replay runs its kernels back to back: short chunks are captured
cheaply and replayed often. A step's lanes are independent of each other,
so the schedule changes no bit of a result and no count. On the CPU the
plain versions keep their per-step schedule. Tests force a schedule on any
device with ``_FORCE`` (the graphs are CUDA's).
"""

from __future__ import annotations

import torch

# the most steps between two liveness checks of a chunked loop
_CHUNK = 4
# a chunk's steps times its lanes at most this (and one step at least)
_LANE_STEPS = 1 << 16
# the fewest lanes a set is cut to: below it a kernel's time on the card
# barely depends on its lanes, and fewer lane counts mean fewer graphs
_MIN_LANES = 1 << 14
# tests: True runs every device's loops chunked, False per step
_FORCE: bool | None = None


def chunked(device: torch.device) -> bool:
    """Whether a plain version's loops on ``device`` run chunked."""
    return device.type == "cuda" if _FORCE is None else _FORCE


def chunk(n: int) -> int:
    """Steps of a chunk on ``n`` lanes (read at run time: tests set the
    constants)."""
    return max(1, min(_CHUNK, _LANE_STEPS // n))


def cut(n_live: int, n: int) -> int:
    """The lanes a set of ``n``, ``n_live`` of them live, keeps after a
    check: a power of two, at least _MIN_LANES, once the ended lanes are
    half of the set (else ``n``)."""
    if 2 * n_live > n:
        return n
    m = max(1 << max(0, n_live - 1).bit_length(), _MIN_LANES)
    return m if m < n else n


def keep(live: torch.Tensor, m: int) -> torch.Tensor:
    """The ``m`` lanes a set keeps: the live ones in order, then ended ones."""
    return torch.argsort((~live).to(torch.uint8), stable=True)[:m]


def count(stats, key: str, n) -> None:
    """``stats[key] += n`` (a count, or a mask's lanes): a dict on the host,
    a ``Schedule`` on the device, None nowhere."""
    if isinstance(stats, Schedule):
        stats.count(key, n)
    elif stats is not None:
        stats[key] = stats.get(key, 0) + int(n.sum() if torch.is_tensor(n) else n)


def _leaves(state: dict) -> list:
    return [x for v in state.values() for x in (v if isinstance(v, tuple) else (v,))]


def _copy_into(static: dict, state: dict) -> None:
    """Write ``state``'s leaves into ``static``'s, key by key, in place. A
    leaf that is another slot's static tensor is read before any is
    written."""
    dst = _leaves(static)
    src = _leaves({k: state[k] for k in static})
    ptrs = {d.data_ptr() for d in dst}
    src = [s if s is d or s.data_ptr() not in ptrs else s.clone() for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


class Schedule:
    """One plain-version call's chunked schedule: its counts on the device
    (``stats``: the caller's dict, or None to count nothing) and, on CUDA,
    its CUDA graphs. Use it in a ``with`` block: leaving it frees the
    graphs, and ``counts()`` then reads the counts."""

    def __init__(self, device: torch.device, stats: dict | None = None):
        self._counting = stats is not None
        self._graphs = device.type == "cuda"
        self._dev = {}        # key -> int64 0-d device tensor
        self._host = {}       # key -> int
        self._captured = {}   # chunk -> (CUDAGraph, static state)
        self._loops = set()   # loops that ran a chunk eagerly
        self._stream = self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        """Frees the graphs, their static state and their memory pools."""
        if self._captured:
            torch.cuda.synchronize()
            self._captured.clear()
            torch.cuda.empty_cache()

    def count(self, key: str, n) -> None:
        """Adds ``n`` (a count, or a mask's lanes) to ``key``'s count."""
        if not self._counting:
            return
        if not torch.is_tensor(n):
            self._host[key] = self._host.get(key, 0) + int(n)
            return
        c = self._dev.get(key)
        if c is None:
            if n.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"count {key!r} first seen in a CUDA graph's capture")
            c = self._dev[key] = torch.zeros((), dtype=torch.int64, device=n.device)
        c.add_(n.sum())

    def counts(self) -> dict:
        """The counts as Python ints (one read of the device's)."""
        out = dict(self._host)
        if self._dev:
            vals = torch.stack(list(self._dev.values())).tolist()
            for key, v in zip(self._dev, vals):
                out[key] = out.get(key, 0) + v
        return out

    def run(self, loop: str, step, state: dict, steps: int, graph: bool = True) -> dict:
        """``steps`` calls of ``step`` (state dict -> state dict; values are
        lane-first tensors or tuples of them) on ``state``. On CUDA, with
        ``graph``, every chunk of ``loop`` but its first (which runs
        eagerly: it loads the kernels and makes the counts) replays as the
        CUDA graph of its lane count and length, captured the first time,
        and the state returned lives in the graph's static tensors: it
        holds until the same chunk runs again."""
        key = (loop, _leaves(state)[0].shape[0], steps)
        entry = self._captured.get(key)
        if entry is None and not (graph and self._graphs and loop in self._loops):
            self._loops.add(loop)
            for _ in range(steps):
                state = step(state)
            return state
        if entry is None:
            entry = self._captured[key] = self._capture(step, state, steps)
        cuda_graph, static = entry
        if state is not static:
            _copy_into(static, state)
        cuda_graph.replay()
        return static

    def _capture(self, step, state: dict, steps: int):
        static = {k: tuple(torch.empty_like(x) for x in v) if isinstance(v, tuple)
                  else torch.empty_like(v) for k, v in state.items()}
        cuda_graph = torch.cuda.CUDAGraph()
        if self._stream is None:
            # the graphs run one after another and keep nothing in the
            # pool between replays: they share it
            self._stream, self._pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            cuda_graph.capture_begin(self._pool)
            try:
                out = static
                for _ in range(steps):
                    out = step(out)
                _copy_into(static, out)
            finally:
                cuda_graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        return cuda_graph, static
