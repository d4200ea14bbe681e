"""probes/probe_pallas2.py on the card: gathers against table height, an
in-row shuffle, shape operations, the general 2-D gather, TEA in u32, and
the march-like body.

Q1 axis-0 gather flat[idx] through a replicated (N, 128) table, N 1024 /
   4096 / 16384 f32 and 4096 i32 (gather);
Q2 in-row shuffle T[i, idx[i, j]], (8, 128) and (3584, 128) (gather);
Q3 transpose, repeat x4 on axis 0, three reshapes (views: no kernel),
   roll 3 on axis 1, broadcast of row 0, iota + x[0, 0] (index_copy);
Q4 T[r, c] from the (3584, 128) atlas shape (gather);
Q5 8 TEA rounds on u32, bit-exact against numpy (tea8);
Q6 64 march-like steps: LCG jitter, a majorant gather with row 0's cell,
   a step and a position update (carry_loop's march kernel). The TPU
   probe's kernel never ran (its body deletes a name it never bound); the
   port checks the kernel against its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import probes as K
from ._common import Context, marginal, require

PROBE, KEY = "pallas2", "stage"
ATLAS_R = 3584


def q1(ctx: Context):
    res = {}
    for n in (1024, 4096, 16384):
        flat = np.arange(n, dtype=np.float32) * 0.25
        t = ctx.t(np.tile(flat[:, None], (1, 128)))
        i0 = np.random.default_rng(100).integers(0, n, (n, 128), dtype=np.int32)
        idx = ctx.t(i0)
        require(np.array_equal(K.gather(t, idx).cpu().numpy(), flat[i0]),
                "replicated axis0 gather wrong")
        res[f"f32_N{n}_ms"] = ctx.time_ms(lambda: K.gather(t, idx), reps=20)
    n = 4096
    flati = np.arange(n, dtype=np.int32) * 3
    ti = ctx.t(np.tile(flati[:, None], (1, 128)))
    i0 = np.random.default_rng(5).integers(0, n, (n, 128), dtype=np.int32)
    idx = ctx.t(i0)
    require(np.array_equal(K.gather(ti, idx).cpu().numpy(), flati[i0]), "i32 gather wrong")
    res["i32_N4096_ms"] = ctx.time_ms(lambda: K.gather(ti, idx), reps=20)
    return res


def q2(ctx: Context):
    res = {}
    for r in (8, 3584):
        tn = np.random.default_rng(1).random((r, 128)).astype(np.float32)
        i0 = np.random.default_rng(300).integers(0, 128, (r, 128), dtype=np.int32)
        t, idx = ctx.t(tn), ctx.t(i0)
        require(np.array_equal(K.gather(t, cols=idx).cpu().numpy(),
                               np.take_along_axis(tn, i0, axis=1)), "shuffle wrong")
        res[f"R{r}_ms"] = ctx.time_ms(lambda: K.gather(t, cols=idx), reps=20)
    return res


def q3(ctx: Context):
    """Each op checked against numpy; the reshapes are views (no kernel)."""
    xn = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    bign = np.arange(256 * 128, dtype=np.float32).reshape(256, 128)
    x, big = ctx.t(xn), ctx.t(bign)
    res = {}
    kernel_ops = (
        ("transpose_8x128", "transpose", 0, xn.T),
        ("repeat_axis0", "tile_rows", 4, np.tile(xn, (4, 1))),
        ("roll_axis1", "roll_cols", 3, np.roll(xn, 3, axis=1)),
        ("broadcast_row_to_3584", "broadcast_row0", 3584, np.broadcast_to(xn[0:1], (3584, 128))),
        ("iota_3584x128", "iota_plus", 3584,
         np.arange(3584, dtype=np.int32).astype(np.float32)[:, None] + np.zeros((1, 128),
                                                                               np.float32)
         + xn[0, 0]),
    )
    for key, op, arg, want in kernel_ops:
        require(np.array_equal(K.index_copy(x, op, arg).cpu().numpy(), want), f"{key} wrong")
        res[key] = "ok"
        res[f"{key}_ms"] = ctx.time_ms(lambda: K.index_copy(x, op, arg), reps=20)
    for key, src, shape in (("reshape_8x128_to_1x1024", x, (1, 1024)),
                            ("reshape_8x128_to_1024x1", x, (1024, 1)),
                            ("reshape_256x128_to_128x256", big, (128, 256))):
        view = src.reshape(shape)
        require(view.data_ptr() == src.data_ptr(), f"{key} copied")
        res[key] = "ok (a view: no kernel)"
    return res


def q4(ctx: Context):
    tn = np.random.default_rng(2).random((ATLAS_R, 128)).astype(np.float32)
    rng = np.random.default_rng(400)
    r0 = rng.integers(0, ATLAS_R, (8, 128), dtype=np.int32)
    c0 = rng.integers(0, 128, (8, 128), dtype=np.int32)
    t, r, c = ctx.t(tn), ctx.t(r0), ctx.t(c0)
    require(np.array_equal(K.gather(t, r, c).cpu().numpy(), tn[r0, c0]), "general gather wrong")
    return {"ms_per_call": ctx.time_ms(lambda: K.gather(t, r, c), reps=100),
            "note": "1024 lanes from (3584,128)"}


def tea8_np(v0, v1):
    s = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(8):
            s = np.uint32(s + np.uint32(0x9E3779B9))
            v0 = v0 + ((((v1 << np.uint32(4)) + np.uint32(0xA341316C)) ^ (v1 + s)
                        ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))))
            v1 = v1 + ((((v0 << np.uint32(4)) + np.uint32(0xAD90777D)) ^ (v0 + s)
                        ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))))
    return v0, v1


def q5(ctx: Context):
    rng = np.random.default_rng(9)
    an = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)
    bn = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)
    a, b = ctx.t(an), ctx.t(bn)
    g0, g1 = K.tea8(a, b)
    w0, w1 = tea8_np(an.copy(), bn.copy())
    require(np.array_equal(g0.cpu().numpy(), w0) and np.array_equal(g1.cpu().numpy(), w1),
            "TEA mismatch")
    ab, bb = K.u32_bits(a), K.u32_bits(b)     # timed without the int64 conversions
    return {"tea_bitexact": True, "ms_per_call": ctx.time_ms(lambda: K.tea8(ab, bb), reps=100)}


Q6_R, Q6_ITERS = 4096, 64


def q6_inputs(ctx: Context):
    t = ctx.t(np.random.default_rng(3).random((Q6_R, 128), np.float32))
    x = ctx.t(np.random.default_rng(4).random((8, 128)).astype(np.float32))
    s = ctx.t(np.random.default_rng(5).integers(0, 2 ** 32, (8, 128), dtype=np.uint32))
    return t, x, s


def q6_step_ms(ctx: Context) -> float:
    """ms of one step of Q6's chain on one warp alone (Q6's first
    MARCH_COLS columns: march_plan gives them one 32-thread block): the
    median of 5 marginals between 64 and 512 steps, which cancel the
    launch. Times the card."""
    t, x, s = q6_inputs(ctx)
    t, x, s = (a[:, :K.MARCH_COLS].contiguous() for a in (t, x, K.u32_bits(s)))
    return float(np.median([marginal(ctx, lambda n: K.march(t, x, s, n), 64, 512, reps=20)[2]
                            for _ in range(5)]))


def q6(ctx: Context):
    t, x, s = q6_inputs(ctx)
    got = K.march(t, x, s, Q6_ITERS)
    require(bool(torch.isfinite(got).all()), "non-finite positions")
    require(torch.equal(got, K.march_plain(t, x, s, Q6_ITERS)), "kernel != plain version")
    sb = K.u32_bits(s)
    ms = ctx.time_ms(lambda: K.march(t, x, sb, Q6_ITERS), reps=100)
    rec = {"ms_per_call": ms, "us_per_iter": ms * 1e3 / Q6_ITERS}
    if "march" in ctx.ptxas:
        rec["ptxas"] = ctx.ptxas["march"]
    return rec


STAGES = (("Q1_axis0_cost", q1), ("Q2_axis1_shuffle", q2), ("Q3_shape_ops", q3),
          ("Q4_general_gather", q4), ("Q5_tea_u32", q5), ("Q6_compile_scale", q6))
