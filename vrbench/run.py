"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 -m vrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
run makes its inputs from the seed (vrbench.inputs), sets up the program
(``volren_tpu_torch.renderer.Renderer`` on its CUDA engine, the megakernel)
and warms it up, then measures a closed loop of the cell's traffic
(vrbench.load) for ``--seconds``: every step ``trace(spp)`` and a device
sync. With ``--trace 1`` torch.profiler records two slices at the window's
end (vrbench.profile). When the window has closed it reads the device's
peak memory and the metrics (vrbench/metrics, one reader a metric), frees
the program's state and holds the framebuffer states the window left to
the plain reference (vrbench.check). It prints each number compared beside its limit as the
last lines of standard error, and the result, with those numbers under its
last key, ``check``.

It exits with 2 and prints no result without the cards the cell asks
for, and with 3 when a module of JAX or of the JAX package
(``volren_tpu``) is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()   # the process's start, as near as Python gets

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import NamedTuple  # noqa: E402

import numpy as np  # noqa: E402

from . import profile  # noqa: E402
from .cell import ROOT, Cell, load_cell, reader  # noqa: E402
from .check import LIMITS, State, judge, pick_pixels, reference_values  # noqa: E402
from .inputs import TEMPERATURE_TRANSFORM, Seeds, procedural_sky, temperature_grid  # noqa: E402
from .load import Schedule  # noqa: E402
from .reference.render import Job, dispatches_of  # noqa: E402

# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "volren_tpu")
# a traced run's two slices at the window's end (vrbench.profile): the
# device slice, then the labelled one, each a share of the window and at most
# so many seconds
DEVICE_SHARE, DEVICE_MAX_S = 0.4, 6.0
LABELLED_SHARE, LABELLED_MAX_S = 0.1, 2.0


def cache_dirs(root: str = ROOT):
    """Fixed build and kernel cache directories inside the checkout (the
    megakernel's nvcc build is ``build/`` of the program itself)."""
    base = os.path.join(root, "build", "vrbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")


class Inputs(NamedTuple):
    sky: np.ndarray
    temperature: np.ndarray | None
    temperature_transform: np.ndarray | None


def make_inputs(config: dict, seeds: Seeds) -> Inputs:
    """The sky, the configuration's own (a deployment renders under its
    one sky; a sun drawn from the run's seed would change the work: its
    shadow rays cross more or less cloud), and for an emission
    configuration the temperature grid at 1 / ``divisor`` of the density
    grid's resolution, from the run's seed."""
    sky = procedural_sky(int(config["sky"]["width"]), int(config["sky"]["height"]),
                         int(config["sky"]["seed"]))
    emission = config.get("emission")
    if not emission:
        return Inputs(sky, None, None)
    w, h, d = (int(v) // int(emission["divisor"]) for v in config["volume_voxels"])
    return Inputs(sky, temperature_grid(w, h, d, seeds.temperature), TEMPERATURE_TRANSFORM)


def setup_program(config: dict, schedule: Schedule, inputs: Inputs, device: str):
    """A committed ``Renderer`` of the configuration, at the traffic's
    frame size."""
    from volren_tpu_torch.renderer import Renderer
    from volren_tpu_torch.scene.environment import Environment
    from volren_tpu_torch.voldata import DenseGrid, Volume

    s = config["settings"]
    r = Renderer(device=device)
    r.volume = Volume(os.path.join(ROOT, config["scene"]))
    extent = [int(v) for v in r.volume.current_grid().index_extent()]
    if extent != [int(v) for v in config["volume_voxels"]]:
        raise ValueError(f"{config['scene']} holds {extent} voxels, the configuration states "
                         f"{config['volume_voxels']}")
    r.density_scale = float(s["density_scale"])
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(inputs.sky))
    r.bounces = int(s["bounces"])
    r.albedo = np.full(3, s["albedo"], np.float32)
    r.phase = float(s["phase"])
    r.emission_scale = float(s["emission_scale"])
    r.show_environment = bool(s["show_environment"])
    if inputs.temperature is not None:
        d, h, w = inputs.temperature.shape
        r.volume.update_grid_frame(0, DenseGrid(w, h, d, inputs.temperature,
                                                inputs.temperature_transform),
                                   config["emission"]["grid"])
    r.cam.up = schedule.up
    r.cam.fov_degree = schedule.fov
    r.init(schedule.width, schedule.height)
    r.commit()
    return r


def _sync(device: str):
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, t0: float | None = None) -> dict:
    """One run of ``cell``: set-up, the window, the metrics and the check.
    Returns the result's object. ``control`` adds the control's readings
    (the reference in bfloat16 against the reference) under
    ``"control"``."""
    import torch

    t0 = T0 if t0 is None else t0
    cache_dirs()
    seeds = Seeds(seed)
    sched = Schedule(cell.traffic, seeds, cell.config["camera"])
    t_in = time.perf_counter()
    inputs = make_inputs(cell.config, seeds)
    t_prog = time.perf_counter()
    r = setup_program(cell.config, sched, inputs, device)
    t_warm = time.perf_counter()
    # the steps whose framebuffer the check reads besides the window's last
    chk = cell.traffic["check"]
    snap_at = {}
    for i in sorted(seeds.check.choice(int(chk["steps_within"]), int(chk["steps"]),
                                       replace=False).tolist() if chk["steps"] else []):
        pos, d = sched.camera(sched.step(i).group)
        pix = pick_pixels(seeds.check, pos, d, sched.up, sched.fov, sched.width, sched.height,
                          int(chk["pixels"]))
        snap_at[i] = (pix, torch.as_tensor(pix, device=device))

    # warm-up: the cell's own instantiation and frame size, untimed
    if trace and device.startswith("cuda"):
        profile.warm_up()
    for _ in range(int(cell.traffic["warmup_steps"])):
        r.reset()
        r.trace(min(sched.spp, 64))
        _sync(device)

    records, snaps = [], {}
    print(f"vrbench: set-up: start {t_in - t0!r} s, inputs {t_prog - t_in!r} s, program "
          f"{t_warm - t_prog!r} s, warm-up {time.perf_counter() - t_warm!r} s", file=sys.stderr,
          flush=True)
    dev_prof = lab_prof = dev_first = lab_first = None
    lab_s = min(LABELLED_SHARE * seconds, LABELLED_MAX_S)
    dev_at = seconds - lab_s - min(DEVICE_SHARE * seconds, DEVICE_MAX_S)
    t_start = time.perf_counter()
    i = 0
    while True:
        if trace and lab_first is None:
            elapsed = time.perf_counter() - t_start
            if dev_first is None and elapsed >= dev_at:
                dev_prof, dev_first = profile.start(host=False), i
            elif dev_first is not None and i > dev_first and elapsed >= seconds - lab_s:
                profile.end(dev_prof)
                lab_prof, lab_first = profile.start(host=True), i
        step = sched.step(i)
        with profile.maybe(lab_prof is not None):
            ts = time.perf_counter()
            if step.first_of_group:
                r.cam.pos, r.cam.dir = sched.camera(step.group)
                r.seed = sched.seed(step.group)
                r.reset()
            th0 = time.perf_counter()
            r.trace(step.spp)
            th1 = time.perf_counter()
            if i in snap_at:
                snaps[i] = r.framebuffer().reshape(-1, 4).index_select(0, snap_at[i][1])
            _sync(device)
            te = time.perf_counter()
        records.append((ts, th0, th1, te, step.spp))
        i += 1
        if te - t_start >= seconds:
            break
    t_end = te
    rec = np.asarray([r_[:4] for r_ in records]) * 1e3
    step_ms = rec[:, 3] - rec[:, 0]
    half = len(step_ms) // 2
    print(f"vrbench: window steps ms: p50 {float(np.percentile(step_ms, 50))!r} p95 "
          f"{float(np.percentile(step_ms, 95))!r} max {float(step_ms.max())!r}; means: before "
          f"trace {float((rec[:, 1] - rec[:, 0]).mean())!r}, trace "
          f"{float((rec[:, 2] - rec[:, 1]).mean())!r}, sync {float((rec[:, 3] - rec[:, 2]).mean())!r}"
          f"; halves {float(step_ms[:half].mean()) if half else 0.0!r}, "
          f"{float(step_ms[half:].mean())!r}", file=sys.stderr, flush=True)
    cuda = device.startswith("cuda")
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    t_read = time.perf_counter()
    prof_out = None
    if dev_prof is not None:
        profile.end(lab_prof if lab_prof is not None else dev_prof)
        dev_last = (lab_first if lab_first is not None else len(records)) - 1
        prof_out = profile.reduce(dev_prof, records[dev_last][3] - records[dev_first][0],
                                  dev_last + 1 - dev_first, lab_prof)
        slices = [("before", 0, dev_first), ("device slice", dev_first, dev_last + 1),
                  ("labelled slice", dev_last + 1, len(records))]
        print("vrbench: mean step ms: " + ", ".join(
            f"{name} {float(step_ms[a:b].mean())!r} ({b - a} steps)"
            for name, a, b in slices if b > a), file=sys.stderr, flush=True)

    ctx = SimpleNamespace(records=records, t_start=t_start, t_end=t_end, setup_s=t_start - t0,
                          profile=prof_out, profile_first=dev_first, renderer=r,
                          schedule=sched, cell=cell, device=device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the states to check: the sampled steps', then the window's last
    last = len(records) - 1
    fb = r.framebuffer().reshape(-1, 4)
    pos, d = sched.camera(sched.step(last).group)
    pix = pick_pixels(seeds.check, pos, d, sched.up, sched.fov, sched.width, sched.height,
                      int(chk["pixels"]))
    states = []
    for k in sorted(snaps) + [last]:
        group = sched.step(k).group
        cpos, cdir = sched.camera(group)
        p = snap_at[k][0] if k in snaps else pix
        values = (snaps[k] if k in snaps else fb[torch.as_tensor(p, device=device)]).cpu().numpy()
        job = Job(cpos, cdir, sched.up, sched.fov, sched.seed(group), sched.width, sched.height,
                  dispatches_of(sched.traces_since_reset(k)), p)
        states.append(State(job, values))
    del r, fb, snaps, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    brick = os.path.join(ROOT, cell.config["scene"])
    jobs = [st.job for st in states]
    want = reference_values(cell.config, brick, inputs, jobs, device)
    correct, readings = judge(states, want)
    print(f"vrbench: {cell.name} seed {seed}: set-up {t_start - t0!r} s, window {t_end - t_start!r}"
          f" s ({len(records)} steps), metrics {t_ref - t_read!r} s, reference "
          f"{time.perf_counter() - t_ref!r} s ({sum(len(j.pixels) for j in jobs)} pixel states, "
          f"{sum(len(j.pixels) * sum(n for _, n in j.dispatches) for j in jobs)} samples)",
          file=sys.stderr, flush=True)
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(1 for st, w in zip(states, want) if not judge([st], [w])[0]),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 1, "memory_peak_bytes": int(mem)},
    }
    if prof_out is not None:
        result["device"]["busy_s"] = prof_out.busy_s
        result["device"]["window_s"] = prof_out.window_s
        result["breakdown"] = {"device_ops": prof_out.device_ops,
                               "idle_gaps": prof_out.idle_gaps}
    if control:
        low = reference_values(cell.config, brick, inputs, jobs, device, torch.bfloat16)
        result["control"] = judge([State(st.job, v) for st, v in zip(states, low)], want)[1]
    result["check"] = {k: {"value": readings[k], "limit": LIMITS[k]} for k in LIMITS}
    return result


def forbidden_modules() -> list:
    """The FORBIDDEN top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vrbench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"vrbench: the process holds {found} once the window has closed", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
