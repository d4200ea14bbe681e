"""The Pallas probes of ``probes/`` asked again of the card.

    python -m volren_tpu_torch.probes [--only STAGES] [--out FILE]
        [--device cuda|cpu] [--rows N] [--rounds N]

One module per TPU probe file, under the same name (and ``scan_gather``
for the ``_scan_gather`` test harness), each with the stage
functions of its original under the original stage names; each stage
builds the original's inputs from the original's seeds, checks its output
against the original's numpy oracle (or, where the original had none,
against the kernel's plain version) and prints one JSON line with the
original's keys. On the card the kernels are those of
``volren_tpu_torch/csrc/probes.cu`` and every time is from CUDA events;
``--device cpu`` runs their plain torch versions and times them with the
host clock. A stage that fails prints ``"ok": false`` and the run exits 1.

``--only`` takes a comma-separated list of probe names (``pallas2``),
stage names (``Q4_general_gather``) or ``probe:stage`` (``dmagather4:full``).
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels import probes as K
from . import (probe_dmagather, probe_dmagather2, probe_dmagather3, probe_dmagather4,
               probe_pallas, probe_pallas2, probe_pallas3, probe_pallas4, probe_pallas5,
               scan_gather)
from ._common import Context, card_line, run_stage

MODULES = (probe_pallas, probe_pallas2, probe_pallas3, probe_pallas4, probe_pallas5,
           probe_dmagather, probe_dmagather2, probe_dmagather3, probe_dmagather4, scan_gather)


def select(only: str | None):
    """[(module, stage name, stage fn)] in the originals' order, filtered
    by ``--only``; raises for a name that selects nothing."""
    stages = [(m, name, fn) for m in MODULES for name, fn in m.STAGES]
    if not only:
        return stages
    picked = []
    for item in only.split(","):
        probe, _, stage = item.strip().rpartition(":")
        hits = [s for s in stages
                if (stage in (s[1], s[0].PROBE) and not probe) or (probe == s[0].PROBE
                                                                   and stage == s[1])]
        if not hits:
            raise ValueError(f"--only {item!r} selects no stage")
        picked += [s for s in hits if s not in picked]
    return [s for s in stages if s in picked]


def _ptxas_by_kernel(lib_path: str) -> dict:
    """ptxas's lines by kernel family (template instantiations joined)."""
    usage: dict = {}
    for line in K.resource_usage(lib_path):
        name, _, text = line.partition(" ")
        usage.setdefault(name.split("<")[0], []).append(text)
    return {name: "; ".join(lines) for name, lines in usage.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m volren_tpu_torch.probes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="comma-separated probes, stages or probe:stage")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=65536, help="rows of the dmagather table")
    ap.add_argument("--rounds", type=int, default=512, help="rounds of dmagather 1-3")
    args = ap.parse_args(argv)
    stages = select(args.only)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; --device cpu runs the plain torch versions")
    out = open(args.out, "a") if args.out else None
    try:
        ctx = Context(device, rows=args.rows, rounds=args.rounds, out=out)
        env = {"mode": "env", "probe": "all", "torch": torch.__version__,
               "rows": ctx.rows, "rounds": ctx.rounds, "r1": ctx.r1, "r2": ctx.r2}
        if ctx.on_card:
            env["card"] = card_line()
            lib = K.build()
            ctx.ptxas = _ptxas_by_kernel(lib)
            env["ptxas"] = ctx.ptxas
        ctx.emit(env)
        failed = [name for m, name, fn in stages
                  if not run_stage(ctx, m.PROBE, m.KEY, name, fn)["ok"]]
        ctx.emit({"mode": "done", "probe": "all", "stages": len(stages), "failed": failed})
    finally:
        if out is not None:
            out.close()
    return 1 if failed else 0
