"""probes/probe_dmagather.py on the card: the cost of a round of 128 row
gathers from a (rows, 128) int32 table, staged through shared memory.

Per round k, lane j's row is (base[j] + 7919 k) % rows, and lanes j < n
add tab[row, row & 127] to a wrapping checksum (row_gather_rounds). The
TPU probe compared two ways to scalarise the row indices (an SMEM staging
DMA, "smem"; a masked vector reduce, "reduce") at n = 128 and 32; both are
the "staged" mode here (the block copies its n demanded 512-byte rows into
shared memory with cp.async, then each lane picks its word), so the
"reduce" lines report the "smem" runs ("runs_as"). At the probe's 65536
rows the table is 32 MB and lives in the card's 50 MB L2: these are L2
numbers (``--rows`` asks the device-memory question).

The shared set-up of dmagather 1-4 lives here: the table and lane indices
from seed 7 as the TPU probes made them, the numpy checksum oracle, and
one measured run per (mode, n, index form, rounds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import probes as K
from ._common import Context, require

PROBE, KEY = "dmagather", "tag"


def tables(ctx: Context):
    """(tab, base) on the device and in numpy, made once per run."""
    key = ("dmagather_tab", ctx.rows)
    if key not in ctx.cache:
        rng = np.random.default_rng(7)
        tab = rng.integers(0, 2 ** 31 - 1, (ctx.rows, 128), dtype=np.int32)
        base = rng.integers(0, ctx.rows, (1, 128), dtype=np.int32)
        ctx.cache[key] = (ctx.t(tab), ctx.t(base), tab, base)
    return ctx.cache[key]


def ref_checksum(base, tab, n, rounds, use_mask, mode="staged"):
    """The numpy oracle: per lane, the wrapping int32 sum over rounds of
    tab[row, row & 127] (lanes j < n) or of the row number ("ids" and
    "stage" modes), or 0 ("stale")."""
    rows = tab.shape[0]
    k = np.arange(rounds, dtype=np.int64)[:, None]
    v = base.reshape(1, -1).astype(np.int64) + 7919 * k
    ids = v & 0xFFFF if use_mask else v % rows
    if mode in ("ids", "stage"):
        vals = ids
    elif mode == "stale":
        vals = np.zeros_like(ids)
    else:
        vals = np.where(np.arange(128) < n, tab[ids, ids & 127].astype(np.int64), 0)
    return (vals.sum(0) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def measure(ctx: Context, mode: str, n: int = 128, use_mask: bool = False,
            rounds: int | None = None) -> dict:
    """One checked, timed run of row_gather_rounds; cached, so TPU variants
    that map to the same run do not run twice. The kernel must equal its
    plain version; the numpy oracle holds it too, except for "stale",
    whose buffer nothing wrote."""
    rounds = ctx.rounds if rounds is None else rounds
    key = ("rows", mode, n, use_mask, rounds, ctx.rows)
    if key not in ctx.cache:
        tab, base, tab_n, base_n = tables(ctx)
        got = K.row_gather_rounds(base, tab, mode, rounds, n, use_mask)
        plain = K.row_gather_rounds_plain(base, tab, mode, rounds, n, use_mask)
        require(torch.equal(got, plain), "kernel != plain version")
        require(np.array_equal(got.cpu().numpy(),
                               ref_checksum(base_n, tab_n, n, rounds, use_mask, mode)),
                "checksum != numpy oracle")
        ms = ctx.time_ms(lambda: K.row_gather_rounds(base, tab, mode, rounds, n, use_mask), 3)
        ctx.cache[key] = {"ms": ms, "runs_as": f"{mode} n={n} {'&0xFFFF' if use_mask else '%rows'}"
                                                f" rounds={rounds}"}
    return dict(ctx.cache[key])


def table_mb(ctx: Context) -> float:
    return ctx.rows * 128 * 4 / 1e6


def _variant(n: int):
    def run(ctx: Context):
        m = measure(ctx, "staged", n)
        return {"warm_s": m["ms"] / 1e3, "us_per_round": m["ms"] * 1e3 / ctx.rounds,
                "us_per_dma": m["ms"] * 1e3 / ctx.rounds / n, "rows": ctx.rows,
                "table_mb": table_mb(ctx), "runs_as": m["runs_as"]}
    return run


STAGES = tuple((f"{s}_n{n}", _variant(n)) for s in ("smem", "reduce") for n in (128, 32))
