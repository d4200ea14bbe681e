"""probes/probe_pallas5.py on the card: the in-kernel gather formulations
and a row cumsum.

On the TPU, V1 (mask-reduce), V2 (MXU reduce), V3 (in-row shuffle), V4 and
V5 (group select, looped and unrolled) and V8 (group select with four
accumulators) were five ways to compute one function: the sum over iters
of T.flat[((s >> 8) & 0x7FFFFF) % (R * 128)] for an (8, 128) lane block.
On the card each is the same load (lcg_gather_sum, "flat"), so each table
height R (1, 74, 896) runs once and every formulation's line reports that
run ("runs_as"). cumsum_axis1 is row_scan on (8, 128), held at the probe's
own bar, allclose(rtol=1e-5): a parallel scan adds in another order.
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels import probes as K
from ._common import Context, lcg_np, marginal, relerr, require, seeds_np, total

PROBE, KEY = "pallas5", "stage"
BAR = 1e-6
N_ITERS = (16, 1024)


def flat_table(r: int) -> np.ndarray:
    return ((np.arange(r * 128) * 13) % 997).astype(np.float32).reshape(r, 128)


def flat_oracle(tn, seed, iters):
    sd = seeds_np(seed, (8, 128), 7919)
    acc = 0.0
    for _ in range(iters):
        sd = lcg_np(sd)
        idx = ((sd >> np.uint32(8)) & np.uint32(0x7FFFFF)).astype(np.int64) % tn.size
        acc += tn.reshape(-1)[idx].astype(np.float64).sum()
    return acc


def _measure(ctx: Context, r: int) -> dict:
    key = ("flat", r)
    if key not in ctx.cache:
        tn = flat_table(r)
        t = ctx.t(tn)
        err = relerr(total(K.lcg_gather_sum(t, "flat", (8, 128), 3, 42)), flat_oracle(tn, 42, 3))
        require(err <= BAR, f"relerr {err} above {BAR}")
        m_lo, m_hi, per = marginal(ctx, lambda n: K.lcg_gather_sum(t, "flat", (8, 128), n, 11),
                                   *N_ITERS)
        ctx.cache[key] = {"relerr": err, "us_per_gather": per * 1e3,
                          "ms_lo": m_lo, "ms_hi": m_hi,
                          "runs_as": f"lcg_gather_sum flat R={r}"}
    return dict(ctx.cache[key])


def _variant(r: int):
    return lambda ctx: _measure(ctx, r)


def cumsum_axis1(ctx: Context):
    xn = np.random.default_rng(0).random((8, 128), np.float32)
    x = ctx.t(xn)
    got = K.row_scan(x)
    ok_np = np.allclose(got.cpu().numpy(), np.cumsum(xn, axis=1), rtol=1e-5)
    ok_plain = np.allclose(got.cpu().numpy(), K.row_scan_plain(x).cpu().numpy(), rtol=1e-5)
    require(ok_np and ok_plain, "row_scan differs from cumsum beyond rtol 1e-5")
    return {"ms_per_call": ctx.time_ms(lambda: K.row_scan(x), reps=100)}


VARIANTS = ("v1_maskreduce", "v2_mxu", "v4_group_fori", "v5_group_static", "v8_group_ilp")
STAGES = (("v3_shuffle_R1", _variant(1)),
          *((f"{v}_R{r}", _variant(r)) for r in (74, 896) for v in VARIANTS),
          ("cumsum_axis1", cumsum_axis1))
