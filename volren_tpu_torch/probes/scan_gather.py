"""The `_scan_gather` test harness (tests/test_pallas.py:55, around
volren_tpu/ops/pallas/kernel.py:396) on the card: T1[r, c] and T2[r, c]
from a (384, 128) float32 and int32 table pair for an (8, 128) lane block.
The TPU emulated the gather with a mask-reduce scan; here it is the
gather kernel, checked bitwise against numpy fancy indexing."""

from __future__ import annotations

import numpy as np

from ..ops.kernels import probes as K
from ._common import Context, require

PROBE, KEY = "scan_gather", "stage"
ROWS = 384


def harness_inputs():
    """The harness's tables and indices, from its seed."""
    rng = np.random.default_rng(3)
    tf32 = rng.random((ROWS, 128)).astype(np.float32)
    ti32 = rng.integers(0, 2 ** 20, (ROWS, 128)).astype(np.int32)
    r = rng.integers(0, ROWS, (8, 128)).astype(np.int32)
    c = rng.integers(0, 128, (8, 128)).astype(np.int32)
    return tf32, ti32, r, c


def harness_exact(ctx: Context):
    tf32, ti32, rn, cn = harness_inputs()
    t1, t2, r, c = (ctx.t(a) for a in (tf32, ti32, rn, cn))
    require(np.array_equal(K.gather(t1, r, c).cpu().numpy(), tf32[rn, cn]), "f32 gather wrong")
    require(np.array_equal(K.gather(t2, r, c).cpu().numpy(), ti32[rn, cn]), "i32 gather wrong")
    ms = ctx.time_ms(lambda: (K.gather(t1, r, c), K.gather(t2, r, c)), reps=100)
    return {"exact": True, "ms_per_pair": ms}


STAGES = (("harness_exact", harness_exact),)
