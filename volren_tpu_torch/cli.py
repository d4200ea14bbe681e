"""Command-line interface: the ``--render`` path of volren_tpu.cli.

    python -m volren_tpu_torch.cli VOLUME.brick [ENV.hdr] [LUT.txt] --render \\
        [-w W] [-h H] [--spp N] [--bounces N] [--albedo A] [--density D]
        [--emission E] [--phase G] [--env_strength S] [--env_rot DEG]
        [--env_hide] [--fau] [--tf_left L] [--tf_width W]
        [--cam_pos X Y Z] [--cam_dir X Y Z] [--cam_fov DEG]
        [--exposure E] [--gamma G] [--output out.png] [--device cuda|cpu]

A volume is a .brick or .dense file; without an .hdr the environment is
white. A .txt file is a transfer-function LUT (``%f, %f, %f, %f`` rows)
and hides the environment, as volren_tpu.cli does; ``--fau`` selects the
built-in 4-entry LUT instead. ``--tf_left`` / ``--tf_width`` set the
density window of the LUT, after it is loaded, wherever they stand.
``--emission`` scales a volume's emission grid; the port reads no VDB
file yet, so emission grids reach the renderer through its API only. ``--device`` defaults to cuda, and the CLI raises when no CUDA
device is present: it never drops to the CPU by itself. The offline loop
traces in chunks of at most 64 samples per pixel and writes
``<output stem>_<frame:06d>.png`` per animation frame (main.cpp:524-558).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .renderer import DISPATCH_SPP, Renderer
from .scene.environment import Environment, rotation_y
from .scene.transferfunc import TransferFunction
from .utils.image import save_ldr
from .voldata import Volume


# --fau: volren_tpu.cli's built-in LUT (cli.py:267-276)
FAU_LUT = [
    (0, 0, 0, 0),
    (4 / 255, 49 / 255, 106 / 255, 0.33),
    (38 / 255, 97 / 255, 65 / 255, 0.66),
    (151 / 255, 27 / 255, 47 / 255, 1.0),
]


def _parse(argv: list[str]):
    opts = {"device": "cuda", "width": 1024, "height": 1024, "output": "output.png",
            "render": False}
    settings: list[tuple] = []   # renderer settings, applied in order
    paths: list[str] = []
    i = 0

    def take(n=1):
        nonlocal i
        vals = argv[i + 1: i + 1 + n]
        if len(vals) != n:
            raise ValueError(f"{argv[i]} needs {n} value(s)")
        i += n
        return vals if n > 1 else vals[0]

    while i < len(argv):
        arg = argv[i]
        if arg == "-w":
            opts["width"] = int(take())
        elif arg == "-h":
            opts["height"] = int(take())
        elif arg == "--render":
            opts["render"] = True
        elif arg == "--output":
            opts["output"] = take()
        elif arg == "--device":
            opts["device"] = take()
        elif arg in ("--samples", "--spp", "--sppx"):
            settings.append(("sppx", int(take())))
        elif arg == "--bounces":
            settings.append(("bounces", int(take())))
        elif arg == "--albedo":
            settings.append(("albedo", np.full(3, float(take()), np.float32)))
        elif arg == "--density":
            settings.append(("density_scale", float(take())))
        elif arg == "--emission":
            settings.append(("emission_scale", float(take())))
        elif arg == "--fau":
            settings.append(("tf", FAU_LUT))
        elif arg in ("--tf_left", "--tf_width"):
            settings.append((arg[2:], float(take())))
        elif arg == "--phase":
            settings.append(("phase", float(take())))
        elif arg == "--env_strength":
            settings.append(("env_strength", float(take())))
        elif arg == "--env_rot":
            settings.append(("env_rot", float(take())))
        elif arg == "--env_hide":
            settings.append(("show_environment", False))
        elif arg == "--cam_pos":
            settings.append(("cam_pos", np.array([float(v) for v in take(3)], np.float32)))
        elif arg == "--cam_dir":
            d = np.array([float(v) for v in take(3)], np.float32)
            settings.append(("cam_dir", d / np.linalg.norm(d)))
        elif arg == "--cam_fov":
            settings.append(("cam_fov", float(take())))
        elif arg == "--exposure":
            settings.append(("tonemap_exposure", float(take())))
        elif arg == "--gamma":
            settings.append(("tonemap_gamma", float(take())))
        elif os.path.exists(arg):
            paths.append(arg)
        else:
            raise ValueError(f"unknown argument: {arg}")
        i += 1
    return opts, settings, paths


def run(argv: list[str]):
    """Parse ``argv``, render, write the PNGs. Returns (renderer, stats) with
    stats = {"spp", "seconds", "outputs"}; ``seconds`` is the wall time of
    the trace loop, synchronized on the device."""
    opts, settings, paths = _parse(list(argv))
    if not opts["render"]:
        raise ValueError("volren_tpu_torch.cli renders offline only: pass --render")
    device = torch.device(opts["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; none is available "
                           "(pass --device cpu to run the plain torch version)")
    r = Renderer(device=device)
    env_strength = env_rot = None
    luts = [TransferFunction(p) for p in paths if p.endswith(".txt")]
    window = {}
    for key, val in settings:
        if key == "tf":
            luts.append(TransferFunction(val))
        elif key in ("tf_left", "tf_width"):
            window["window_" + key[3:]] = val
        elif key == "env_strength":
            env_strength = val
        elif key == "env_rot":
            env_rot = val
        elif key == "cam_pos":
            r.cam.pos = val
        elif key == "cam_dir":
            r.cam.dir = val
        elif key == "cam_fov":
            r.cam.fov_degree = val
        else:
            setattr(r, key, val)
    volumes = [p for p in paths if not p.endswith((".hdr", ".txt"))]
    envs = [p for p in paths if p.endswith(".hdr")]
    if len(volumes) != 1:
        raise ValueError(f"need exactly one volume (.brick or .dense), got {volumes}")
    env = Environment(envs[-1]) if envs else Environment.white()
    if env_strength is not None:
        env.strength = env_strength
    if env_rot is not None:
        env.transform = rotation_y(env_rot)
    r.set_environment(env)
    if any(p.endswith(".txt") for p in paths):
        r.show_environment = False
    if luts:  # the last LUT wins (LUT files before --fau), then the window
        for key, val in window.items():
            setattr(luts[-1], key, val)
        r.set_transferfunc(luts[-1])
    r.init(opts["width"], opts["height"])
    print(f"load volume: {volumes[0]}")
    density = r.density_scale
    r.volume = Volume(volumes[0])
    r.density_scale = 1.0
    r.scale_and_move_to_unit_cube()
    r.density_scale *= density
    r.commit()

    print("rendering...")
    stem = os.path.splitext(opts["output"])[0]
    outputs = []
    seconds = 0.0
    for frame in range(r.volume.n_grid_frames()):
        r.reset()
        r.volume.grid_frame_counter = frame
        t0 = time.perf_counter()
        while r.sample < r.sppx:
            r.trace(min(r.sppx - r.sample, DISPATCH_SPP))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"{r.sample} / {r.sppx}", end="\r", flush=True)
        dt = max(time.perf_counter() - t0, 1e-9)
        seconds += dt
        print(f"\n{r.sppx} samples in {dt:.1f}s ({r.sppx / dt:.2f} spp/s, {r.last_engine})")
        out_fn = f"{stem}_{frame:06d}.png"
        save_ldr(out_fn, r.draw(), flip=True, alpha=True)
        print(f"{out_fn} written.")
        outputs.append(out_fn)
    return r, {"spp": r.sppx * r.volume.n_grid_frames(), "seconds": seconds,
               "outputs": outputs}


def main(argv: list[str] | None = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
