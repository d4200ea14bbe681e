"""What every probe module shares: the run's context (device, sizes,
output), one JSON line per stage, guarded stages, timing and the LCG."""

from __future__ import annotations

import json
import subprocess
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, TextIO

import numpy as np
import torch


@dataclass
class Context:
    """One run of the probes. ``device`` is where the stages run: "cuda"
    launches the kernels and times them with CUDA events; "cpu" runs the
    plain versions and times them with the host clock (never a device
    number). ``rows`` and ``rounds`` size the dmagather table and loop
    (dmagather4 runs ``r1`` and ``r2`` rounds)."""
    device: torch.device
    rows: int = 65536
    rounds: int = 512
    r1: int = 2048
    r2: int = 32768
    out: TextIO | None = None
    records: list = field(default_factory=list)
    cache: dict = field(default_factory=dict)
    ptxas: dict = field(default_factory=dict)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def emit(self, rec: dict):
        rec = {k: (v.item() if isinstance(v, (np.generic,)) else v) for k, v in rec.items()}
        rec["device"] = torch.cuda.get_device_name(self.device) if self.on_card else "cpu"
        self.records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out is not None:
            self.out.write(line + "\n")
            self.out.flush()

    def t(self, a, dtype=None) -> torch.Tensor:
        """A numpy array as a tensor on the run's device (u32 as int64)."""
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype=dtype) if dtype is not None else t.to(self.device)

    def time_ms(self, fn: Callable[[], object], reps: int = 20, hide_host: bool = True) -> float:
        """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up:
        CUDA events around the launches on the card, the host clock on the
        CPU (one call: the plain versions are slow, and their time is not
        what the probes ask). Nothing is copied to the host inside the
        window. With ``hide_host``, a spin kernel queued before the window
        outlasts the host's enqueueing of the ``reps`` calls, so the window
        holds the device's back-to-back work only; without it, the window
        also holds the device's waits for the host (wrapper and launch)."""
        if not self.on_card:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        fn()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hide_host:   # cycles at <= 2 GHz: the spin lasts at least this long
            torch.cuda._sleep(int((2.0 * reps * enqueue_s + 2e-4) * 2.0e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def marginal(ctx: Context, run: Callable[[int], object], lo: int, hi: int, reps: int = 5):
    """(ms at ``lo`` iterations, ms at ``hi``, ms per extra iteration) of
    ``run(iterations)``: the probes' marginal between two counts, which
    cancels the per-launch cost."""
    m_lo, m_hi = ctx.time_ms(lambda: run(lo), reps), ctx.time_ms(lambda: run(hi), reps)
    return m_lo, m_hi, (m_hi - m_lo) / (hi - lo)


def run_stage(ctx: Context, probe: str, key: str, name: str, fn: Callable[[Context], dict]) -> dict:
    """Run one stage; emit its line with ``ok`` and the stage's keys, or
    ``ok: false`` and the error. Returns the record."""
    t0 = time.time()
    try:
        rec = {key: name, **(fn(ctx) or {}), "ok": True}
    except Exception as e:  # the line says what failed; main exits non-zero
        rec = {key: name, "ok": False, "error": f"{type(e).__name__}: {e}"[:400],
               "trace": traceback.format_exc()[-800:]}
    rec["wall_s"] = round(time.time() - t0, 2)
    rec["probe"] = probe
    ctx.emit(rec)
    return rec


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def lcg_np(s: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (s * np.uint32(1664525) + np.uint32(1013904223)).astype(np.uint32)


def seeds_np(seed: int, lanes, row_mul: int) -> np.ndarray:
    h, w = lanes
    return (np.full(lanes, seed, np.uint64) + np.arange(h, dtype=np.uint64)[:, None] * row_mul
            + np.arange(w, dtype=np.uint64)[None, :]).astype(np.uint32)


def relerr(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1.0)


def total(acc: torch.Tensor) -> float:
    """The total of per-lane float32 accumulators, summed in float64."""
    return float(acc.sum(dtype=torch.float64))


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)
