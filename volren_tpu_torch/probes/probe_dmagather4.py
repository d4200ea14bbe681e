"""probes/probe_dmagather4.py on the card: the true per-round cost by
delta timing, (T(r2) - T(r1)) / (r2 - r1) with r1 = 2048 and r2 = 32768
rounds, indices & 0xFFFF, which cancels the per-launch cost.

  loop               ids: the empty round
  diag               stale: the pick from the never-written landing buffer
  dma128, dma128big  stage: copy the 128 rows to shared memory, no pick
                     (the TPU's per-copy and whole-buffer waits are one
                     cp.async wait here)
  full               staged: copy, then pick each lane's word
"""

from __future__ import annotations

from ._common import Context
from .probe_dmagather import measure, table_mb

PROBE, KEY = "dmagather4", "tag"
MAPS = {"loop": "ids", "diag": "stale", "dma128": "stage", "dma128big": "stage",
        "full": "staged"}


def _variant(tag: str):
    def run(ctx: Context):
        t1 = measure(ctx, MAPS[tag], 128, True, ctx.r1)
        t2 = measure(ctx, MAPS[tag], 128, True, ctx.r2)
        return {"t_r1_ms": t1["ms"], "t_r2_ms": t2["ms"],
                "us_per_round": (t2["ms"] - t1["ms"]) * 1e3 / (ctx.r2 - ctx.r1),
                "rows": ctx.rows, "table_mb": table_mb(ctx), "runs_as": t2["runs_as"]}
    return run


STAGES = tuple((tag, _variant(tag)) for tag in MAPS)
