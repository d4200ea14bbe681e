"""A dry run of rendering across devices: spawned processes on one machine,
joined by gloo, each rendering a small scene through ``Renderer.distribute``
(the counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m volren_tpu_torch.parallel.dryrun [--procs 4] [--device cpu]

The processes render on the card (``cuda:rank % device_count``) unless
``--device cpu`` asks for the plain version on the CPU.

Each case is a mesh ``n_tiles x n_spp`` over the first ``n_tiles * n_spp``
processes, a frame size and a sample count. Every rank of a case must hold
the same framebuffer, and it is held against one process's render of the
same scene: bitwise for row bands, within rtol = atol = 1e-5 for a sample
split, whose merge adds the shards in another order (the bar of volren_tpu's
tests/test_sharding.py). The scene is the random 16^3 grid under a white
sky, or a volume file under an HDR sky. Prints one JSON line per case and
exits 1 if any fails.
"""

from __future__ import annotations

import argparse
import json
import queue as queue_mod
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.kernels import megakernel
from ..renderer import Renderer
from ..scene.environment import Environment
from ..voldata import DenseGrid, Volume
from .sharding import band_rows, gather_bands, make_mesh, reduce_shards

# (n_tiles, n_spp, width, height, spp): bands, ragged bands (13 rows over 4
# tiles: 4, 4, 4, 1), an uneven sample split (5 over 2: 3 + 2), and both
CASES = ((2, 1, 16, 16, 8), (4, 1, 16, 13, 4), (1, 2, 16, 16, 5), (2, 2, 16, 15, 8))
TOL = 1e-5
MERGE_REPS = 5    # merges timed alone after each case's render


def scene_renderer(device, width: int, height: int, volume: str | None = None,
                   sky: str | None = None, bounces: int = 8, seed: int = 123) -> Renderer:
    """A committed Renderer: the random 16^3 grid (seed 5) under a white
    sky of strength 0.8, or ``volume`` under the HDR ``sky``."""
    r = Renderer(device=device)
    if volume is None:
        dense = np.random.default_rng(5).random((16, 16, 16)).astype(np.float32)
        r.volume = Volume(DenseGrid(16, 16, 16, dense))
    else:
        r.volume = Volume(volume)
    r.scale_and_move_to_unit_cube()
    # the default white map's importance pyramid is built once per process
    env = Environment.white() if sky is None else Environment(sky)
    env.strength = 0.8 if sky is None else env.strength
    r.set_environment(env)
    r.bounces = bounces
    r.seed = seed
    r.init(width, height)
    r.commit()
    return r


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, address: str, cases, scene: dict, device: str, out) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    try:
        for i, (n_tiles, n_spp, width, height, spp) in enumerate(cases):
            n = n_tiles * n_spp
            # every process makes every group (dist.new_group's rule)
            group = None if n == world else dist.new_group(list(range(n)))
            mesh = make_mesh(n_tiles, n_spp, group)
            if mesh is None:
                continue
            r = scene_renderer(device, width, height, **scene)
            r.distribute(mesh)
            if r.device.type == "cuda":
                # the timed render finds the kernel's library loaded and the
                # group's first collective made
                r.render(1)
            megakernel.render.launches = 0
            t0 = time.perf_counter()
            r.render(spp)
            seconds = time.perf_counter() - t0
            launches = megakernel.render.launches
            # the merge alone (a dispatch's all_reduce and a trace's
            # all_gather) of a band of this rank's shape, the ranks lined up
            # by a barrier first
            band = torch.zeros(band_rows(height, n_tiles, mesh.tile)[1] * width, 4,
                               device=r.device)
            merge_s = []
            for _ in range(MERGE_REPS):
                dist.barrier(group=mesh.group)
                t1 = time.perf_counter()
                gather_bands(reduce_shards(band, mesh), mesh, width, height)
                if band.is_cuda:
                    torch.cuda.synchronize(band.device)
                merge_s.append(time.perf_counter() - t1)
            out.put((rank, i, r.framebuffer().cpu().numpy(), seconds,
                     float(np.median(merge_s)), launches, r.last_engine))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun(n_procs: int = 4, cases=CASES, device: str = "cuda", volume: str | None = None,
           sky: str | None = None, bounces: int = 8, seed: int = 123,
           timeout: float = 600.0) -> list[dict]:
    """Run ``cases`` in ``n_procs`` spawned gloo processes (every process on
    ``device``; on a CUDA device, ``cuda:rank % device_count``), then each
    case's one-process render here. Returns one record per case: its mesh,
    size and spp, ``ok``, ``bitwise``, ``max_abs`` against one process, the
    slowest rank's render seconds (``seconds``), the slowest rank's median
    ms of a merge alone after a barrier (``merge_ms``), the fewest kernel launches of a rank
    (``launches``: the CUDA kernel's, 0 on the CPU) and the engines the
    ranks ran."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run on 'cuda' needs a CUDA device; none is available "
                           "(pass device='cpu', --device cpu, for the plain version)")
    if any(nt * ns > n_procs for nt, ns, *_ in cases):
        raise ValueError(f"a case needs more than {n_procs} processes")
    scene = {"volume": volume, "sky": sky, "bounces": bounces, "seed": seed}
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_worker, args=(rank, n_procs, address, tuple(cases), scene,
                                                device, out), daemon=True)
             for rank in range(n_procs)]
    for p in procs:
        p.start()
    expected = sum(nt * ns for nt, ns, *_ in cases)
    got: dict[int, list] = {i: [] for i in range(len(cases))}
    deadline = time.time() + timeout
    try:
        while sum(len(v) for v in got.values()) < expected:
            try:
                rank, i, *rec = out.get(timeout=1.0)
                got[i].append(rec)
            except queue_mod.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.time() > deadline:
                    raise RuntimeError(f"the dry run's processes failed (exit codes {failed})"
                                       if failed else f"the dry run took over {timeout} s")
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
            if p.exitcode != 0:
                raise RuntimeError(f"a dry-run process ended with exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    records = []
    for i, (n_tiles, n_spp, width, height, spp) in enumerate(cases):
        one = scene_renderer(device, width, height, **scene)
        one.render(spp)
        ref = one.framebuffer().cpu().numpy()
        fbs = [fb for fb, *_ in got[i]]
        same = all(np.array_equal(fb, fbs[0]) for fb in fbs)
        bitwise = np.array_equal(fbs[0], ref)
        max_abs = float(np.abs(fbs[0] - ref).max())
        close = bool(np.allclose(fbs[0], ref, rtol=TOL, atol=TOL))
        records.append({
            "mesh": [n_tiles, n_spp], "size": [width, height], "spp": spp, "device": device,
            "ok": same and bool(np.isfinite(fbs[0]).all()) and (bitwise if n_spp == 1 else close),
            "ranks_agree": same, "bitwise": bitwise, "max_abs": max_abs,
            "seconds": max(rec[1] for rec in got[i]),
            "merge_ms": max(rec[2] for rec in got[i]) * 1e3,
            "launches": min(rec[3] for rec in got[i]),
            "engines": sorted({rec[4] for rec in got[i]}),
        })
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cases = [c for c in CASES if c[0] * c[1] <= args.procs]
    records = dryrun(args.procs, cases, device=args.device)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(rec["ok"] for rec in records) else 1


if __name__ == "__main__":
    sys.exit(main())
