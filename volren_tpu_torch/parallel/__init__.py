"""Rendering across devices (volren_tpu.parallel): row bands and sample
shards over torch.distributed (``sharding``), and a dry run of it in
spawned gloo processes (``dryrun``)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh, render_sharded


def init_from_launcher(device: torch.device) -> bool:
    """Initialise the default process group from torch.distributed.run's
    rendezvous (torch's ``env://``) when this process was started by it and
    no group exists: NCCL for a CUDA device, gloo for the CPU. Returns True
    when it initialised the group."""
    if dist.is_initialized() or not dist.is_torchelastic_launched():
        return False
    dist.init_process_group(backend="nccl" if torch.device(device).type == "cuda" else "gloo")
    return True


__all__ = ["Mesh", "init_from_launcher", "make_mesh", "render_sharded"]
