"""Rendering across devices: row bands x sample shards over torch.distributed.

The counterpart of volren_tpu.parallel.sharding. A mesh of
``n_tiles x n_spp`` ranks splits a frame two ways:

  tiles -- bands of the frame's rows, ``ceil(H / n_tiles)`` rows each (the
           last band may be shorter, or empty); the scene is replicated, so
           tracing needs no traffic between ranks;
  spp   -- the samples of each dispatch, split as evenly as they go; the
           shards of a band are merged with a sum ``all_reduce`` after
           every dispatch (``reduce_shards``).

An ``all_gather`` of the bands (``gather_bands``) then leaves the whole
(H, W, 4) frame on every rank, as the JAX functions return it.
``Renderer.trace`` keeps each band's running mean on its own rank and
gathers once per trace, as volren_tpu's renderer calls its render_sharded
once per trace. A mesh of one tile gathers nothing and a tile of one shard
reduces nothing, so a world of one makes no collective. Each (pixel, sample) is seeded from
the global pixel index and the sample index, and a band's pixels keep the
whole frame's camera, so a mesh traces exactly the samples one process
traces. Bands are therefore bitwise equal to one process (the kernel adds a
pixel's samples in sample order); a sample split differs from it only by
the order of the merge's sum.

JAX has five functions for this: ``render_sharded``,
``render_sharded_queue``, ``render_sharded_queue_device``,
``render_sharded_host`` and ``render_sharded_pallas``. They are XLA and
Pallas schedules of one sample set, and here they are one function,
``render_sharded``, one dispatch whose every band and shard is one launch
of the CUDA megakernel (or its plain version on the CPU). The NEE pool belongs to the
dispatch: a rank that traces samples ``[b + k, b + k + s)`` of the dispatch
based at ``b`` uses the pool drawn for ``b``.

The collectives run on the mesh's process group: NCCL when the tensors are
on the card, gloo on the CPU. A gloo group given CUDA tensors has them
staged through the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops.kernels import megakernel
from ..ops.kernels.pack import DISPATCH_SPP, KernelScene, build_params
from ..ops.scene import TraceParams
from ..utils import spans


@dataclass
class Mesh:
    """``n_tiles x n_spp`` ranks of a process group, in the JAX mesh's order
    (``devices.reshape(n_tiles, n_spp)``): mesh rank r is tile ``r //
    n_spp`` and sample shard ``r % n_spp``. ``group`` is None for a world
    of one without a process group. ``merge_group`` holds the ranks of this
    rank's tile (the sample shards summed), ``gather_group`` the ranks of
    this rank's sample shard (the bands gathered)."""

    n_tiles: int
    n_spp: int
    rank: int = 0
    global_rank: int = 0
    group: object = None
    merge_group: object = None
    gather_group: object = None

    @property
    def shape(self) -> dict:
        return {"tiles": self.n_tiles, "spp": self.n_spp}

    @property
    def size(self) -> int:
        return self.n_tiles * self.n_spp

    @property
    def tile(self) -> int:
        return self.rank // self.n_spp

    @property
    def spp_shard(self) -> int:
        return self.rank % self.n_spp


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, group=None) -> Mesh | None:
    """A mesh over the ranks of ``group`` (the default group when None).
    Every process of the default group calls it, in the same order, as
    ``dist.new_group`` asks: it makes the subgroups of the merges. A process
    outside ``group`` gets None. With no process group initialised the mesh
    is a world of one."""
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a mesh over a group needs an initialised process group")
        n_tiles = 1 if n_tiles is None else n_tiles
        if n_tiles * n_spp != 1:
            raise ValueError(f"{n_tiles}x{n_spp} mesh != 1 process (no process group)")
        return Mesh(1, 1)
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if n_tiles is None:
        n_tiles = n // n_spp
    if n_tiles * n_spp != n:
        raise ValueError(f"{n_tiles}x{n_spp} mesh != {n} ranks")
    me = dist.get_rank()
    rank = ranks.index(me) if me in ranks else None
    if n == 1:
        return Mesh(1, 1, 0, me, group, group, group)
    # every process makes every subgroup and keeps its own
    merge_groups = [dist.new_group([ranks[t * n_spp + s] for s in range(n_spp)])
                    for t in range(n_tiles)]
    gather_groups = [dist.new_group([ranks[t * n_spp + s] for t in range(n_tiles)])
                     for s in range(n_spp)]
    if rank is None:
        return None
    return Mesh(n_tiles, n_spp, rank, me, group, merge_groups[rank // n_spp],
                gather_groups[rank % n_spp])


def band_rows(height: int, n_tiles: int, tile: int) -> tuple[int, int]:
    """(first row, row count) of band ``tile``: ``ceil(height / n_tiles)``
    rows from ``tile`` times that, cut at the frame's edge."""
    rows = -(-height // n_tiles)
    row0 = min(tile * rows, height)
    return row0, min(rows, height - row0)


def spp_share(spp: int, n_spp: int, shard: int) -> tuple[int, int]:
    """(first sample, sample count) of shard ``shard`` of a dispatch of
    ``spp`` samples: the first ``spp % n_spp`` shards take one more."""
    q, r = divmod(spp, n_spp)
    return shard * q + min(shard, r), q + (1 if shard < r else 0)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    # gloo's collectives run on host memory: stage CUDA tensors there
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def reduce_shards(band: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's band sum -> the sum over its tile's sample shards (a sum
    ``all_reduce``; ``band`` itself when the tile has one shard)."""
    if mesh.n_spp == 1:
        return band
    x = _staged(band, mesh.merge_group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.merge_group)
    return x.to(band.device)


def gather_bands(band: torch.Tensor, mesh: Mesh, width: int, height: int) -> torch.Tensor:
    """This rank's band (rows*W*4 values) -> the whole (H, W, 4) frame on
    every rank: an ``all_gather`` of the bands, each padded to the longest
    band (``band`` itself, reshaped, when the mesh has one tile)."""
    if mesh.n_tiles == 1:
        return band.reshape(height, width, 4)
    x = _staged(band.reshape(-1, 4), mesh.gather_group)
    rows = -(-height // mesh.n_tiles)
    padded = torch.zeros(rows * width, 4, dtype=x.dtype, device=x.device)
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(mesh.n_tiles)]
    dist.all_gather(parts, padded, group=mesh.gather_group)
    whole = torch.cat([p[:band_rows(height, mesh.n_tiles, t)[1] * width]
                       for t, p in enumerate(parts)])
    return whole.reshape(height, width, 4).to(band.device)


def render_sharded(ks: KernelScene, pool: torch.Tensor, params: TraceParams, width: int,
                   height: int, spp: int, spp_base: int, mesh: Mesh) -> torch.Tensor:
    """One dispatch, samples ``[spp_base, spp_base + spp)`` (at most
    DISPATCH_SPP) of every pixel across ``mesh``: this rank traces its
    band's rows for its share of the samples with the dispatch's NEE
    ``pool``, and the shares are summed over the tile (``reduce_shards``).
    Returns the band's (rows*W, 4) float32 sample SUM; ``gather_bands`` of
    it is the whole frame's on every rank, the contract of volren_tpu's
    render_sharded. ``Renderer.trace`` keeps each band's running mean on its
    own rank and gathers once per trace."""
    with spans.span("volren_tpu_torch.launch"):
        if spp > DISPATCH_SPP:
            raise ValueError(f"a dispatch has at most {DISPATCH_SPP} samples, not {spp}")
        row0, rows = band_rows(height, mesh.n_tiles, mesh.tile)
        k0, count = spp_share(spp, mesh.n_spp, mesh.spp_shard)
        if count > 0:
            pf, pi = build_params(ks, params, width, height, spp_base + k0, count, row0, rows)
            band = megakernel.render(ks, pool, pf, pi)
        else:
            band = torch.zeros(rows * width, 4, dtype=torch.float32, device=ks.atlas.device)
        return reduce_shards(band, mesh)


__all__ = ["Mesh", "band_rows", "gather_bands", "make_mesh", "reduce_shards", "render_sharded",
           "spp_share"]
