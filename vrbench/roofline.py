"""The render kernel's work bound: a frozen copy of
``volren_tpu_torch.measure.kernel_bound``'s arithmetic, taking the table
sizes and the event counts as plain numbers.

The least time the card could take for one dispatch is
max(bytes / peak bytes/s, float32 operations / peak float32/s). Bytes:
every table the dispatch reads, once, and its (n_pix, 4) float32 output,
once. Operations: the events the dispatch's data needs (the counts of the
kernel's STATS instantiation on the same inputs) times the float32
operations of each event, counted by hand from csrc/megakernel.cu.
``dispatch_share`` reads a cell's share of that bound from the program's
kernel, its STATS counters and CUDA events.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet, 700 W: HBM bytes/s and float32 operations/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# float32 operations of one event (measure.OPS_PER_EVENT)
OPS_PER_EVENT = {
    "regen": 120, "march": 73, "test": 183, "test_tf": 154, "emission": 202,
    "nee": 116, "nee_tf": 268, "escape": 74, "scatter": 157,
}
# what a packed table adds to its event (measure.PACKED_OPS)
PACKED_OPS = {"mip_u8": ("march", 2), "env_rgbe": ("escape", 6), "pool_rgbe": ("nee", 6)}
EVENTS = ("regen", "march", "test", "emission", "nee", "escape", "scatter")


def kernel_bound(table_bytes: int, n_pix: int, events: dict, use_tf: bool = False,
                 packs: tuple = ()):
    """(ms, "bytes" | "operations", bytes, operations) of one dispatch
    whose tables hold ``table_bytes`` and whose output has ``n_pix``
    pixels, for the event counts ``events`` (keys of EVENTS), on the TF
    variant when ``use_tf``, with the packed tables named in ``packs``."""
    n_bytes = int(table_bytes) + int(n_pix) * 4 * 4
    weights = dict(OPS_PER_EVENT)
    if use_tf:
        weights["test"], weights["nee"] = weights["test_tf"], weights["nee_tf"]
    for pack, (event, extra) in PACKED_OPS.items():
        weights[event] += extra if pack in packs else 0
    ops = sum(weights[k] * int(events.get(k, 0)) for k in EVENTS)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, ops)


# samples of one dispatch at most (Renderer.trace's fence)
DISPATCH_SPP = 64


def dispatch_share(ctx):
    """The render kernel's share of its work bound, in percent, on one
    dispatch of the cell's own size (its traffic's samples a step, at most
    the renderer's 64 a dispatch) on the cell's own tables as the window
    left them: ``kernel_bound`` from the events the kernel's STATS
    instantiation counts on that dispatch, over the median of three
    CUDA-event timings of the same dispatch through the render kernel. None
    off a card."""
    if not str(ctx.device).startswith("cuda"):
        return None
    import torch
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params

    r, sched = ctx.renderer, ctx.schedule
    ks, tp = r._kernel_scene(), r._trace_params()
    spp = min(sched.spp, DISPATCH_SPP)
    pool = build_env_pool(r._env_device, int(r.seed), 0)
    pf, pi = build_params(ks, tp, sched.width, sched.height, 0, spp)
    megakernel.render(ks, pool, pf, pi)
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        megakernel.render(ks, pool, pf, pi)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    _, st = megakernel.render_stats(ks, pool, pf, pi)
    packs = dict(zip(megakernel.PACKS, megakernel._packs(ks, pool)))
    use_tf = ks.tf is not None
    mip = ks.mip_u8 if packs["mip_u8"] else (ks.mip_tf if use_tf else ks.mip)
    env = ks.env_rgbe if packs["env_rgbe"] else ks.env
    tables = [ks.atlas, ks.slot, ks.lo, ks.hi, mip, env, pool]
    if use_tf:
        tables.append(ks.tf.lut)
    if ks.emi_atlas is not None:
        tables += [ks.emi_atlas, ks.emi_slot, ks.emi_lo, ks.emi_hi]
    n_bytes = sum(t.numel() * t.element_size() for t in tables)
    bound_ms = kernel_bound(n_bytes, sched.width * sched.height, st, use_tf,
                            tuple(k for k, on in packs.items() if on))[0]
    return 100.0 * bound_ms / statistics.median(times)
