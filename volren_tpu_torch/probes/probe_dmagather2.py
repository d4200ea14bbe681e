"""probes/probe_dmagather2.py on the card: the TPU probe bisected the
fixed cost of a row-gather round. Its variants, and the run each maps to
here (one run each, reported by every variant that maps to it):

  full, bigwait, unroll8, nostage   staged, 128 rows (the TPU's one
                                    whole-buffer wait, unrolled DMA-start
                                    loop and index-free row numbers are
                                    DMA-engine mechanisms with no
                                    counterpart: cp.async waits once)
  dma8                              staged, 8 rows
  nomod                             staged, 128 rows, index & 0xFFFF
  diagonly, stageonly               stale: the pick from a landing buffer
                                    that nothing wrote (zero-filled here)
"""

from __future__ import annotations

from ._common import Context
from .probe_dmagather import measure, table_mb

PROBE, KEY = "dmagather2", "tag"
MAPS = {"diagonly": ("stale", 128, False), "stageonly": ("stale", 128, False),
        "nostage": ("staged", 128, False), "bigwait": ("staged", 128, False),
        "dma8": ("staged", 8, False), "unroll8": ("staged", 128, False),
        "nomod": ("staged", 128, True), "full": ("staged", 128, False)}


def _variant(tag: str):
    mode, n, use_mask = MAPS[tag]

    def run(ctx: Context):
        m = measure(ctx, mode, n, use_mask)
        return {"us_per_round": m["ms"] * 1e3 / ctx.rounds, "rows": ctx.rows,
                "table_mb": table_mb(ctx), "runs_as": m["runs_as"]}
    return run


STAGES = tuple((tag, _variant(tag)) for tag in MAPS)
