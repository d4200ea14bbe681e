"""One representative call for each of the 28 Pallas call sites the probe
kernels replace, at the probe's own shapes: what ``chip_smoke.py`` holds
against the plain version, times, and bounds for its kernels line.

A site's ``stages`` (an ``--only`` selection) are the probe stages that
launch its kernel; together the sites' stages are every stage of
``python -m volren_tpu_torch.probes``, each in exactly one site.

The bound of a call is the larger of its bytes at 3.35 TB/s and its
arithmetic operations (integer and float alike, counted by hand from
csrc/probes.cu) at the float32 rate, 67 TFLOP/s. Bytes count each input
and output once; a gather counts the table words its indices read
(at most the table), since which words it reads depends on the data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..measure import PEAK_BYTES_S, PEAK_F32_S
from ..ops.kernels import probes as K
from . import (probe_dmagather, probe_pallas, probe_pallas2, probe_pallas4, probe_pallas5,
               scan_gather)
from ._common import Context


@dataclass
class Case:
    kernel: Callable[[], object]          # the call on the card
    plain: Callable[[], object]           # its plain version on the same inputs
    library: Callable[[], object] | None  # one PyTorch call computing the same, if any
    n_bytes: int
    n_ops: int
    exact: bool = True                    # bitwise; else allclose(rtol=1e-5)
    library_calls: int = 1                # the PyTorch calls ``library`` makes

    def bound(self):
        """(ms, "bytes" | "operations")."""
        t_bytes, t_ops = self.n_bytes / PEAK_BYTES_S, self.n_ops / PEAK_F32_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@dataclass(frozen=True)
class Site:
    name: str
    replaces: str
    family: str          # key of ops.kernels.probes.WRAPPERS
    stages: str
    make: Callable[[Context], Case]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _words(table: torch.Tensor, n_reads: int) -> int:
    return min(_nbytes(table), 4 * n_reads)


# ---- affine_loop
def _affine(ctx, shape, iters, a, b, dev_count=False):
    x = ctx.t(np.full(shape, 1.0, np.float32))
    n = ctx.t(np.array([iters], np.int32)) if dev_count else None
    kernel = (lambda: K.affine_loop(x, 0, a, b, n)) if dev_count else \
        (lambda: K.affine_loop(x, iters, a, b))
    library = (lambda: x * 2.0) if (iters, b) == (1, 0.0) else None
    return Case(kernel, lambda: K.affine_loop_plain(x, iters, a, b), library,
                2 * _nbytes(x) + (4 if dev_count else 0), 2 * x.numel() * iters)


def _p4(ctx):
    x = ctx.t(np.full(probe_pallas.SHAPE, 1.0, np.float32))

    def loop(step):
        y = x
        for _ in range(64):
            y = step(y)
        return y

    return Case(lambda: loop(lambda y: K.affine_loop(y, 64, probe_pallas.A, probe_pallas.B)),
                lambda: loop(lambda y: K.affine_loop_plain(y, 64, probe_pallas.A,
                                                           probe_pallas.B)),
                None, 2 * _nbytes(x), 2 * x.numel() * 64 * 64)


# ---- gather
def _gather_case(table, rows=None, cols=None, row_mod=0, library=None):
    out = K.gather_plain(table, rows, cols, row_mod)
    n_bytes = _words(table, out.numel()) + _nbytes(out) + sum(
        _nbytes(t) for t in (rows, cols) if t is not None)
    return Case(lambda: K.gather(table, rows, cols, row_mod),
                lambda: K.gather_plain(table, rows, cols, row_mod), library, n_bytes, 0)


def _p3(ctx, row_mod=0):
    t = ctx.t(np.arange(probe_pallas.TABLE_N, dtype=np.float32) * 0.5)
    idx = ctx.t(probe_pallas._mk_idx(0))
    il = idx.long()
    return _gather_case(t, idx, row_mod=row_mod, library=None if row_mod else (lambda: t[il]))


def _p3d(ctx):
    t2 = ctx.t((np.arange(16384, dtype=np.float32) * 0.5).reshape(128, 128))
    rows = ctx.t(np.random.default_rng(7).integers(0, 128, (8, 1), dtype=np.int32))
    rl = rows.long().view(-1)
    return _gather_case(t2, rows, library=lambda: t2[rl])


def _q1(ctx):
    n = 16384
    t = ctx.t(np.tile((np.arange(n, dtype=np.float32) * 0.25)[:, None], (1, 128)))
    idx = ctx.t(np.random.default_rng(100).integers(0, n, (n, 128), dtype=np.int32))
    il = idx.long()
    return _gather_case(t, idx, library=lambda: torch.gather(t, 0, il))


def _q2(ctx):
    t = ctx.t(np.random.default_rng(1).random((3584, 128)).astype(np.float32))
    idx = ctx.t(np.random.default_rng(300).integers(0, 128, (3584, 128), dtype=np.int32))
    il = idx.long()
    return _gather_case(t, cols=idx, library=lambda: torch.gather(t, 1, il))


def _q4(ctx):
    t = ctx.t(np.random.default_rng(2).random((3584, 128)).astype(np.float32))
    rng = np.random.default_rng(400)
    r = ctx.t(rng.integers(0, 3584, (8, 128), dtype=np.int32))
    c = ctx.t(rng.integers(0, 128, (8, 128), dtype=np.int32))
    rl, cl = r.long(), c.long()
    return _gather_case(t, r, c, library=lambda: t[rl, cl])


def _w3(ctx):
    t = ctx.t((np.arange(32 * 128) % 977).astype(np.float32).reshape(32, 128))
    idx = ctx.t(np.random.default_rng(3).integers(0, 32, (32, 128), dtype=np.int32))
    il = idx.long()
    return _gather_case(t, idx, library=lambda: torch.gather(t, 0, il))


def _harness(ctx):
    """Both tables in one launch; the library is two calls (no one PyTorch
    call gathers two tables)."""
    tf32, ti32, rn, cn = scan_gather.harness_inputs()
    t1, t2, r, c = (ctx.t(a) for a in (tf32, ti32, rn, cn))
    rl, cl = r.long(), c.long()
    n_bytes = 2 * (_words(t1, r.numel()) + 4 * r.numel()) + _nbytes(r, c)
    return Case(lambda: K.gather((t1, t2), r, c), lambda: K.gather_plain((t1, t2), r, c),
                lambda: (t1[rl, cl], t2[rl, cl]), n_bytes, 0, library_calls=2)


# ---- index_copy
def _q3(ctx):
    x = ctx.t(np.arange(8 * 128, dtype=np.float32).reshape(8, 128))
    ops = (("transpose", 0), ("tile_rows", 4), ("roll_cols", 3), ("broadcast_row0", 3584),
           ("iota_plus", 3584))
    outs = [K.index_copy_plain(x, op, arg) for op, arg in ops]
    return Case(lambda: tuple(K.index_copy(x, op, arg) for op, arg in ops),
                lambda: tuple(K.index_copy_plain(x, op, arg) for op, arg in ops), None,
                len(ops) * _nbytes(x) + _nbytes(*outs), outs[-1].numel())


def _w4(ctx):
    t = ctx.t(np.arange(128 * 1024, dtype=np.float32).reshape(128, 1024))
    return Case(lambda: K.index_copy(t, "transpose"), lambda: K.index_copy_plain(t, "transpose"),
                lambda: t.t().contiguous(), 2 * _nbytes(t), 0)


# ---- tea8, row_scan
def _q5(ctx):
    rng = np.random.default_rng(9)
    a, b = (K.u32_bits(ctx.t(rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)))
            for _ in range(2))
    return Case(lambda: K.tea8(a, b), lambda: K.tea8_plain(a, b), None, 4 * _nbytes(a),
                a.numel() * 8 * 17)


def _cumsum(ctx):
    x = ctx.t(np.random.default_rng(0).random((8, 128), np.float32))
    return Case(lambda: K.row_scan(x), lambda: K.row_scan_plain(x),
                lambda: torch.cumsum(x, dim=1), 2 * _nbytes(x), x.numel(), exact=False)


# ---- lcg_gather_sum (ops per lane and iteration: "row" 7, "rc" 11, "flat" 6,
# one more for an int32 table's conversion)
OPS_LCG = {"row": 7, "rc": 11, "flat": 6}


# the five sites' (table, mode, lanes, iters, seed), at the probes' shapes
LCG_SITES = {
    "probe_W1_W6": (lambda: (np.arange(3584 * 128) % 977).reshape(3584, 128).astype(np.float32),
                    "row", (3584, 128), 256, 1000),
    "probe_W2": (lambda: (np.arange(8 * 16384) % 977).reshape(8, 16384).astype(np.float32),
                 "row", (8, 16384), 32, 2000),
    "probe_W5_W7": (lambda: np.random.default_rng(2).random((3584, 128)).astype(np.float32),
                    "rc", (1, 1024), 64, 3000),
    "probe_X1_X2": (lambda: probe_pallas4.mask_reduce_table(3584, np.int32), "rc", (8, 128), 64,
                    11),
    "probe_V": (lambda: probe_pallas5.flat_table(896), "flat", (8, 128), 1024, 11),
}


def _lcg(ctx, make_table, mode, lanes, iters, seed):
    t = ctx.t(make_table())
    n = lanes[0] * lanes[1]
    ops = n * iters * (OPS_LCG[mode] + (t.dtype == torch.int32))
    return Case(lambda: K.lcg_gather_sum(t, mode, lanes, iters, seed),
                lambda: K.lcg_gather_sum_plain(t, mode, lanes, iters, seed, 7919), None,
                _words(t, n * iters) + 4 * n, ops)


# ---- carry_loop
def _x3(ctx):
    t = ctx.t(probe_pallas4.x3_table())
    iters, n = 512, 8 * 128
    return Case(lambda: K.carry30(t, 11, iters), lambda: K.carry30_plain(t, 11, iters, (8, 128)),
                None, _words(t, n * iters) + 4 * n, n * (iters * 100 + 29))


def _q6(ctx):
    t, x, s = probe_pallas2.q6_inputs(ctx)
    sb = K.u32_bits(s)
    it = probe_pallas2.Q6_ITERS
    return Case(lambda: K.march(t, x, sb, it), lambda: K.march_plain(t, x, sb, it), None,
                _words(t, 128 * it) + _nbytes(x, sb) + _nbytes(x), it * (1024 * 10 + 128 * 5))


# ---- row_gather_rounds (4 operations per lane and round)
def _rounds(ctx, mode, use_mask, rounds):
    tab, base, _, _ = probe_dmagather.tables(ctx)
    n_words = rounds * K.LANES if mode in ("direct", "staged") else 0
    return Case(lambda: K.row_gather_rounds(base, tab, mode, rounds, K.LANES, use_mask),
                lambda: K.row_gather_rounds_plain(base, tab, mode, rounds, K.LANES, use_mask),
                None, _words(tab, n_words) + 2 * _nbytes(base), 4 * K.LANES * rounds)


SITES = (
    Site("probe_P0", "probes/probe_pallas.py:105", "affine_loop", "pallas:P0_trivial",
         lambda c: _affine(c, (8, 128), 1, 2.0, 0.0)),
    Site("probe_P1", "probes/probe_pallas.py:133", "affine_loop", "pallas:P1_inkernel_fori",
         lambda c: _affine(c, probe_pallas.SHAPE, 4096, probe_pallas.A, probe_pallas.B)),
    Site("probe_P2", "probes/probe_pallas.py:178", "affine_loop", "pallas:P2_inkernel_while",
         lambda c: _affine(c, probe_pallas.SHAPE, 4096, probe_pallas.A, probe_pallas.B, True)),
    Site("probe_P3a", "probes/probe_pallas.py:223", "gather", "pallas:P3a_vector_take", _p3),
    Site("probe_P3b", "probes/probe_pallas.py:256", "gather", "pallas:P3b_onehot_mxu",
         lambda c: _p3(c, 2048)),
    Site("probe_P3c", "probes/probe_pallas.py:285", "gather", "pallas:P3c_scalar_loop", _p3),
    Site("probe_P3d", "probes/probe_pallas.py:313", "gather", "pallas:P3d_dynamic_slice_rows",
         _p3d),
    Site("probe_P4", "probes/probe_pallas.py:341", "affine_loop", "pallas:P4_pallas_in_while",
         _p4),
    Site("probe_Q1", "probes/probe_pallas2.py:105", "gather", "pallas2:Q1_axis0_cost", _q1),
    Site("probe_Q2", "probes/probe_pallas2.py:160", "gather", "pallas2:Q2_axis1_shuffle", _q2),
    Site("probe_Q3", "probes/probe_pallas2.py:192", "index_copy", "pallas2:Q3_shape_ops", _q3),
    Site("probe_Q4", "probes/probe_pallas2.py:274", "gather", "pallas2:Q4_general_gather", _q4),
    Site("probe_Q5", "probes/probe_pallas2.py:321", "tea8", "pallas2:Q5_tea_u32", _q5),
    Site("probe_Q6", "probes/probe_pallas2.py:385", "march", "pallas2:Q6_compile_scale", _q6),
    Site("probe_W1_W6", "probes/probe_pallas3.py:141", "lcg_gather_sum",
         "pallas3:W1_axis1_3584_f32,pallas3:W1_axis1_9344_f32,pallas3:W6_axis1_3584_i32",
         lambda c: _lcg(c, *LCG_SITES["probe_W1_W6"])),
    Site("probe_W2", "probes/probe_pallas3.py:201", "lcg_gather_sum", "pallas3:W2_wide_axis1",
         lambda c: _lcg(c, *LCG_SITES["probe_W2"])),
    Site("probe_W3", "probes/probe_pallas3.py:240", "gather", "pallas3:W3_axis0_small", _w3),
    Site("probe_W4", "probes/probe_pallas3.py:271", "index_copy", "pallas3:W4_transpose_big",
         _w4),
    Site("probe_W5_W7", "probes/probe_pallas3.py:334", "lcg_gather_sum",
         "pallas3:W7_general_gather_v2",
         lambda c: _lcg(c, *LCG_SITES["probe_W5_W7"])),
    Site("probe_X1_X2", "probes/probe_pallas4.py:155", "lcg_gather_sum",
         "pallas4:X1_maskreduce_3584_i32,pallas4:X2_maskreduce_74_f32",
         lambda c: _lcg(c, *LCG_SITES["probe_X1_X2"])),
    Site("probe_X3", "probes/probe_pallas4.py:229", "carry30", "pallas4:X3_carry30_while", _x3),
    Site("probe_V", "probes/probe_pallas5.py:185", "lcg_gather_sum",
         ",".join(f"pallas5:{name}" for name, _ in probe_pallas5.STAGES[:-1]),
         lambda c: _lcg(c, *LCG_SITES["probe_V"])),
    Site("probe_cumsum", "probes/probe_pallas5.py:243", "row_scan", "pallas5:cumsum_axis1",
         _cumsum),
    Site("probe_dmagather", "probes/probe_dmagather.py:116", "row_gather_rounds", "dmagather",
         lambda c: _rounds(c, "staged", False, c.rounds)),
    Site("probe_dmagather2", "probes/probe_dmagather2.py:112", "row_gather_rounds",
         "dmagather2", lambda c: _rounds(c, "staged", False, c.rounds)),
    Site("probe_dmagather3", "probes/probe_dmagather3.py:114", "row_gather_rounds",
         "dmagather3", lambda c: _rounds(c, "direct", True, c.rounds)),
    Site("probe_dmagather4", "probes/probe_dmagather4.py:111", "row_gather_rounds",
         "dmagather4", lambda c: _rounds(c, "staged", True, c.r2)),
    Site("scan_gather_harness", "tests/test_pallas.py:55", "gather", "scan_gather",
         _harness),
)
