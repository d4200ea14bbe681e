"""probes/probe_pallas3.py on the card: gathers timed inside one kernel
with LCG indices, by the marginal between two iteration counts.

W1/W6 per lane of an (R, 128) block, T[i, lcg % 128] summed over iters, R
      3584 and 9344 f32, 3584 i32 (lcg_gather_sum, "row");
W2    the same on an (8, 16384) wide row;
W3    axis-0 gather T[idx[i, j], j] at (8, 128) and (32, 128) (gather);
W4    transposes (128, 1024), (1024, 128), (8, 1024) (index_copy, 16-byte
      segments through a shared tile); the first also in turns with PyTorch's
      .t().contiguous() (median and spread of 101 rounds); on the card also
      (8192, 8192), held bitwise to t.t() and timed in turns with it (21
      rounds), with the bytes' bound and the kernel's share of it;
W7    T[r, c] for 1024 lanes with r and c from the LCG, from (3584, 128)
      (lcg_gather_sum, "rc"; the TPU's one-hot MXU row fetch and select
      are one load here).
Totals are checked at 3 iterations against the probe's numpy LCG oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..measure import PEAK_BYTES_S
from ..ops.kernels import probes as K
from ._common import (Context, interleaved_ms, lcg_np, marginal, relerr, require, seeds_np,
                      total)

PROBE, KEY = "pallas3", "stage"
ATLAS_R = 3584
BAR = 1e-6


def _row_oracle(tn, seed, iters):
    r, w = tn.shape
    sd = seeds_np(seed, (r, w), 7919)
    acc = np.zeros((r, w), np.float64)
    for _ in range(iters):
        sd = lcg_np(sd)
        idx = (sd >> np.uint32(8)).astype(np.int64) % w
        acc += np.take_along_axis(tn, idx, axis=1)
    return float(acc.sum())


def _row_probe(r: int, dtype, w: int = 128, lo: int = 16, hi: int = 256):
    def probe(ctx: Context):
        tn = (np.arange(r * w) % 977).reshape(r, w).astype(dtype)
        t = ctx.t(tn)
        got = total(K.lcg_gather_sum(t, "row", (r, w), 3, 42))
        err = relerr(got, _row_oracle(tn, 42, 3))
        require(err <= BAR, f"relerr {err} above {BAR}")
        m_lo, m_hi, per = marginal(
            ctx, lambda n: K.lcg_gather_sum(t, "row", (r, w), n, 1000), lo, hi)
        return {"R": r, "relerr": err, f"ms_lo{lo}": m_lo, f"ms_hi{hi}": m_hi,
                "us_per_gather": per * 1e3, "ns_per_elem": per * 1e6 / (r * w)}
    return probe


def w2(ctx: Context):
    rec = _row_probe(8, np.float32, w=16384, lo=4, hi=32)(ctx)
    return {k: rec[k] for k in ("relerr", "us_per_gather", "ns_per_elem")}


def w3(ctx: Context):
    res = {}
    for r in (8, 32):
        tn = (np.arange(r * 128) % 977).astype(np.float32).reshape(r, 128)
        i0 = np.random.default_rng(3).integers(0, r, (r, 128), dtype=np.int32)
        t, idx = ctx.t(tn), ctx.t(i0)
        require(np.array_equal(K.gather(t, idx).cpu().numpy(), np.take_along_axis(tn, i0, axis=0)),
                f"R{r} wrong")
        res[f"R{r}"] = "ok"
        res[f"R{r}_ms"] = ctx.time_ms(lambda: K.gather(t, idx), reps=100)
    return res


W4_SHAPES = ((128, 1024), (1024, 128), (8, 1024))
BIG = 8192   # on the card, a transpose of 256 MiB: the bytes set its time, not the launch


def transpose_vs_library(ctx: Context, t: torch.Tensor, rounds: int = 101) -> dict:
    """The transpose kernel and PyTorch's ``.t().contiguous()`` on ``t``,
    in turns (interleaved_ms): median and spread of each."""
    return interleaved_ms(ctx, {"kernel": lambda: K.index_copy(t, "transpose"),
                                ".t().contiguous()": lambda: t.t().contiguous()}, rounds)


def w4(ctx: Context):
    res = {}
    for a, b in W4_SHAPES:
        tn = np.arange(a * b, dtype=np.float32).reshape(a, b)
        t = ctx.t(tn)
        require(np.array_equal(K.index_copy(t, "transpose").cpu().numpy(), tn.T),
                f"{a}x{b} wrong")
        res[f"{a}x{b}"] = "ok"
        res[f"{a}x{b}_ms"] = ctx.time_ms(lambda: K.index_copy(t, "transpose"), reps=100)
        if (a, b) == W4_SHAPES[0]:   # against PyTorch's own transpose, in turns
            res[f"{a}x{b}_vs_library"] = transpose_vs_library(ctx, t)
    if ctx.on_card:
        t = torch.rand(BIG, BIG, device=ctx.device)
        require(torch.equal(K.index_copy(t, "transpose"), t.t()), f"{BIG}x{BIG} wrong")
        turns = transpose_vs_library(ctx, t, rounds=21)
        bound_ms = 2 * t.numel() * 4 / PEAK_BYTES_S * 1e3
        res[f"{BIG}x{BIG}_vs_library"] = turns
        res[f"{BIG}x{BIG}_bound_ms"] = bound_ms
        res[f"{BIG}x{BIG}_share_of_bound"] = bound_ms / turns["kernel"]["median"]
    return res


def rc_oracle(tn, lanes, row_mul, seed, iters):
    """The probes' (r, c) LCG gather total in float64."""
    r_n = tn.shape[0]
    sd = seeds_np(seed, lanes, row_mul)
    acc = 0.0
    for _ in range(iters):
        sd = lcg_np(sd)
        r = (sd >> np.uint32(8)).astype(np.int64) % r_n
        sd = lcg_np(sd)
        c = (sd >> np.uint32(8)).astype(np.int64) % 128
        acc += tn[r, c].astype(np.float64).sum()
    return acc


def w7(ctx: Context):
    tn = np.random.default_rng(2).random((ATLAS_R, 128)).astype(np.float32)
    t = ctx.t(tn)
    got = total(K.lcg_gather_sum(t, "rc", (1, 1024), 3, 42))
    err = relerr(got, rc_oracle(tn, (1, 1024), 7919, 42, 3))
    require(err <= BAR, f"relerr {err} above {BAR}")
    m_lo, m_hi, per = marginal(ctx, lambda n: K.lcg_gather_sum(t, "rc", (1, 1024), n, 3000),
                               8, 64)
    return {"relerr": err, "ms_lo8": m_lo, "ms_hi64": m_hi,
            "us_per_general_gather_1024": per * 1e3}


STAGES = (("W1_axis1_3584_f32", _row_probe(3584, np.float32)),
          ("W1_axis1_9344_f32", _row_probe(9344, np.float32)),
          ("W2_wide_axis1", w2), ("W3_axis0_small", w3), ("W4_transpose_big", w4),
          ("W6_axis1_3584_i32", _row_probe(3584, np.int32)),
          ("W7_general_gather_v2", w7))
