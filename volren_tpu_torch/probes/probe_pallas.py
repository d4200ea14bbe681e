"""probes/probe_pallas.py on the card: the launch floor, the cost of an
in-kernel loop step (host and device trip counts), gathers from a 16384
float table, and a loop of launches.

P0 one launch of x * 2 (affine_loop, one step): the device's time per
   back-to-back launch, and (host_ms_per_call) with the host's enqueueing;
P1 marginal ms per in-kernel step, 256 vs 4096 steps of x = x * 1.0000001
   + 1e-6 on (256, 512);
P2 the same with the trip count read from device memory by the kernel;
P3a-d table[idx], table[idx % 2048], table[idx] (the TPU's scalar loop),
   t2[rows] (gather);
P4 the 64-step kernel launched n times from the host, n 8 vs 64: the
   device's cost per launch, and (host_ms_*) the loop's with the host's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import probes as K
from ._common import Context, marginal, require

PROBE, KEY = "pallas", "stage"
SHAPE = (256, 512)
A, B = 1.0000001, 0.000001
TABLE_N = 16384
LANES2D = (8, 128)


def p0(ctx: Context):
    x = ctx.t(np.full(LANES2D, 3.0, np.float32))
    got = K.affine_loop(x, 1, a=2.0, b=0.0)
    require(float(got[0, 0]) == 6.0, "x * 2 is wrong")
    ms = ctx.time_ms(lambda: K.affine_loop(x, 1, a=2.0, b=0.0), reps=200)
    host_ms = ctx.time_ms(lambda: K.affine_loop(x, 1, a=2.0, b=0.0), reps=200, hide_host=False)
    return {"ms_per_call": ms, "host_ms_per_call": host_ms}


def p1(ctx: Context):
    x = ctx.t(np.full(SHAPE, 1.0, np.float32))
    lo, hi = 256, 4096
    got = K.affine_loop(x, lo, A, B)
    require(torch.equal(got, K.affine_loop_plain(x, lo, A, B)), "kernel != plain version")
    m_lo, m_hi, per = marginal(ctx, lambda n: K.affine_loop(x, n, A, B), lo, hi)
    return {"ms_lo": m_lo, "ms_hi": m_hi, "iters": [lo, hi], "marginal_us_per_iter": per * 1e3}


def p2(ctx: Context):
    x = ctx.t(np.full(SHAPE, 1.0, np.float32))
    n64 = ctx.t(np.array([64], np.int32))
    require(torch.equal(K.affine_loop(x, a=A, b=B, iters_dev=n64), K.affine_loop(x, 64, A, B)),
            "device trip count != host trip count")
    ns = {n: ctx.t(np.array([n], np.int32)) for n in (256, 4096)}
    m_lo, m_hi, per = marginal(ctx, lambda n: K.affine_loop(x, a=A, b=B, iters_dev=ns[n]),
                               256, 4096)
    return {"ms_lo": m_lo, "ms_hi": m_hi, "marginal_us_per_iter": per * 1e3}


def _mk_idx(i):
    return np.random.default_rng(1234 + i).integers(0, TABLE_N, size=LANES2D, dtype=np.int32)


def _table(ctx: Context):
    return ctx.t(np.arange(TABLE_N, dtype=np.float32) * 0.5)


def _gather_stage(ctx: Context, row_mod: int):
    t, i0 = _table(ctx), _mk_idx(0)
    idx = ctx.t(i0)
    got = K.gather(t, idx, row_mod=row_mod).cpu().numpy()
    want = ((i0.astype(np.int64) % row_mod) if row_mod else i0.astype(np.int64)) * 0.5
    require(np.array_equal(got, want.astype(np.float32)), "gather is wrong")
    return ctx.time_ms(lambda: K.gather(t, idx, row_mod=row_mod), reps=100)


def p3a(ctx: Context):
    return {"ms_per_call": _gather_stage(ctx, 0)}


def p3b(ctx: Context):
    return {"ms_per_call": _gather_stage(ctx, 2048), "note": "N=2048 subtable"}


def p3c(ctx: Context):
    ms = _gather_stage(ctx, 0)
    return {"ms_per_call": ms, "us_per_elem": ms * 1e3 / 1024}


def p3d(ctx: Context):
    t2n = (np.arange(TABLE_N, dtype=np.float32) * 0.5).reshape(TABLE_N // 128, 128)
    rows_n = np.random.default_rng(7).integers(0, TABLE_N // 128, (8, 1), dtype=np.int32)
    t2, rows = ctx.t(t2n), ctx.t(rows_n)
    got = K.gather(t2, rows).cpu().numpy()
    require(np.array_equal(got, t2n[rows_n[:, 0]]), "row fetch is wrong")
    return {"ms_per_call": ctx.time_ms(lambda: K.gather(t2, rows), reps=100)}


def p4(ctx: Context):
    inner = 64
    x = ctx.t(np.full(SHAPE, 1.0, np.float32))

    def loop(n):
        y = x
        for _ in range(n):
            y = K.affine_loop(y, inner, A, B)
        return y

    require(torch.equal(loop(2), K.affine_loop(x, 2 * inner, A, B)),
            "two launches of 64 steps != one of 128")
    m_lo, m_hi = ctx.time_ms(lambda: loop(8), 5), ctx.time_ms(lambda: loop(64), 5)
    h_lo = ctx.time_ms(lambda: loop(8), 5, hide_host=False)
    h_hi = ctx.time_ms(lambda: loop(64), 5, hide_host=False)
    return {"ms_lo": m_lo, "ms_hi": m_hi, "ms_per_outer_iter": (m_hi - m_lo) / (64 - 8),
            "host_ms_per_outer_iter": (h_hi - h_lo) / (64 - 8), "inner_iters": inner}


STAGES = (("P0_trivial", p0), ("P1_inkernel_fori", p1), ("P2_inkernel_while", p2),
          ("P3a_vector_take", p3a), ("P3b_onehot_mxu", p3b), ("P3c_scalar_loop", p3c),
          ("P3d_dynamic_slice_rows", p3d), ("P4_pallas_in_while", p4))
