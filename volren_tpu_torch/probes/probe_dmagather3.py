"""probes/probe_dmagather3.py on the card: the selection's cost against
landing each demanded word directly, indices & 0xFFFF.

  loop                          ids: the empty round (acc + row number)
  load, gather, reduce,         stale: a pick from the never-written
  hoist, diag                   landing buffer (the TPU's load / shuffle /
                                masked-reduce halves of its diagonal scan
                                are one shared-memory load here)
  word4                         direct: each lane loads its own 4-byte
                                word, no staging; checked bitwise
"""

from __future__ import annotations

from ._common import Context
from .probe_dmagather import measure, table_mb

PROBE, KEY = "dmagather3", "tag"
MAPS = {"loop": "ids", "load": "stale", "gather": "stale", "reduce": "stale", "hoist": "stale",
        "diag": "stale", "word4": "direct"}


def _variant(tag: str):
    def run(ctx: Context):
        m = measure(ctx, MAPS[tag], 128, True)
        rec = {"us_per_round": m["ms"] * 1e3 / ctx.rounds, "rows": ctx.rows,
               "table_mb": table_mb(ctx), "runs_as": m["runs_as"]}
        if tag == "word4":
            rec["bitwise"] = True    # measure() held it to the numpy oracle
        return rec
    return run


STAGES = tuple((tag, _variant(tag)) for tag in MAPS)
