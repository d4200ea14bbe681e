"""probes/probe_pallas4.py on the card: the (r, c) gather that the TPU
emulated with a mask-reduce, and a loop carrying 30 values per lane (the
megakernel's shape).

X1/X2 T[r, c] with r, c from the LCG for an (8, 128) lane block, summed
      over iters, from (3584, 128) i32 and (74, 128) f32 (lcg_gather_sum,
      "rc"), checked at 3 iterations against the numpy LCG oracle;
X3    a loop of 64 vs 512 steps carrying 30 (8, 128) f32 arrays chained
      a = a * 0.9999 + prev * 1e-4 after one (74, 128) gather per step
      (carry_loop's carry30 kernel), checked against its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import probes as K
from ._common import Context, marginal, relerr, require, total
from .probe_pallas3 import BAR, rc_oracle

PROBE, KEY = "pallas4", "stage"


def mask_reduce_table(r: int, np_dtype):
    rng = np.random.default_rng(5)
    if np_dtype == np.int32:
        return rng.integers(0, 2 ** 20, (r, 128)).astype(np.int32)
    return rng.random((r, 128)).astype(np.float32)


def _mask_reduce_probe(r: int, np_dtype):
    def probe(ctx: Context):
        tn = mask_reduce_table(r, np_dtype)
        t = ctx.t(tn)
        got = total(K.lcg_gather_sum(t, "rc", (8, 128), 3, 42))
        err = relerr(got, rc_oracle(tn, (8, 128), 7919, 42, 3))
        require(err <= BAR, f"relerr {err} above {BAR}")
        m_lo, m_hi, per = marginal(ctx, lambda n: K.lcg_gather_sum(t, "rc", (8, 128), n, 11),
                                   8, 64)
        return {"R": r, "relerr": err, "ms_lo8": m_lo, "ms_hi64": m_hi,
                "us_per_gather1024": per * 1e3}
    return probe


X3_R = 74


def x3_table():
    return np.random.default_rng(6).random((X3_R, 128)).astype(np.float32)


def x3(ctx: Context):
    t = ctx.t(x3_table())
    got = K.carry30(t, 1, 64)
    require(torch.equal(got, K.carry30_plain(t, 1, 64, (8, 128))), "kernel != plain version")
    m_lo, m_hi, per = marginal(ctx, lambda n: K.carry30(t, 11, n), 64, 512)
    rec = {"us_per_iter": per * 1e3, "ms_lo64": m_lo, "ms_hi512": m_hi}
    if "carry30" in ctx.ptxas:
        rec["ptxas"] = ctx.ptxas["carry30"]
    return rec


STAGES = (("X1_maskreduce_3584_i32", _mask_reduce_probe(3584, np.int32)),
          ("X2_maskreduce_74_f32", _mask_reduce_probe(74, np.float32)),
          ("X3_carry30_while", x3))
