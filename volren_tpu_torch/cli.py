"""Command-line interface: volren_tpu.cli, flag for flag, on the port.

    python -m volren_tpu_torch.cli [PATH ...] [--render] [-w W] [-h H]
        [--spp N] [--bounces N] [--albedo A] [--density D] [--emission E]
        [--phase G] [--env_strength S] [--env_rot DEG] [--env_hide]
        [--turbo | --viridis | --fau] [--tf_left L] [--tf_width W]
        [--cam_pos X Y Z] [--cam_dir X Y Z] [--cam_fov DEG]
        [--exposure E] [--gamma G] [--vol_rot_x|y|z DEG]
        [--vol_crop_min X Y Z] [--vol_crop_max X Y Z] [--animate] [--fps F]
        [--serve [PORT]] [--engine NAME] [--step-engine NAME]
        [--output out.png] [--device cuda|cpu] [--cpu]

Bare paths are dispatched by extension like the reference's handle_path
(main.cpp:93-102): ``.py`` runs a script with the ``volpy`` shim bound to
this renderer, ``.hdr`` sets the environment, ``.txt`` sets a LUT (and
hides the environment), a folder loads an animation (``Volume.load_folder``)
and anything else is a volume (.brick, .dense, .vdb, .nvdb, DICOM); a
``.vdb`` also brings its ``flame`` / ``flames`` / ``temperature`` grid as
the emission grid. A path that fails to load is reported and the previous
state kept (main.cpp:37-91); that covers loading files only, never a
script, ``commit()`` or ``trace()``. With no volume, a debug box is
rendered (main.cpp:464-474). The window-only flags of the reference are
accepted and ignored, and an unknown argument is reported on stderr and
ignored.

``--render`` traces every animation frame offline in chunks of at most 64
samples per pixel and writes ``<output stem>_<frame:06d>.png``
(main.cpp:524-558). Without it the interactive loop runs (main.cpp:477-523):
4-spp steps, a preview PNG about once a second, kernel hot reload, the
animation advanced at ``--fps`` with ``--animate``, and with ``--serve`` a
localhost viewer (``viewer.ViewerServer``) at a preview resolution whose
``/snapshot`` renders one frame at full resolution. Ctrl-C ends it.

``--device`` defaults to cuda and raises when no CUDA device is present:
the CLI never drops to the CPU by itself; ``--cpu`` is ``--device cpu``.
``--engine`` and ``--step-engine`` take volren_tpu's names (every step
engine renders through the megakernel; ``--engine oracle`` through the
oracle engine, ``csrc/oracle.cu``); ``--no-dda`` selects the
global-majorant estimators and with them the oracle engine, as in
volren_tpu.cli. ``--distribute`` renders across the ranks of the default
process group as row bands (``Renderer.distribute``): under
``python -m torch.distributed.run --nproc_per_node N -m
volren_tpu_torch.cli ... --render --distribute`` each rank joins torch's
rendezvous (NCCL on the card, gloo on the CPU), traces its band on
``cuda:rank % device_count``, and rank 0 alone writes the PNGs; without a
launcher it is a world of one. The interactive loop does not run across
several ranks. Deliberate
differences from volren_tpu.cli: ``--density`` multiplies the density
scale that the unit-cube fit sets (there, loading the volume resets it);
``--vol_rot_*`` rotates the committed grids (there it moves only the
clip box, as its grids are uploaded before the rotation); ``--tf_left`` /
``--tf_width`` window the LUT wherever they stand; a failing script
raises.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from .parallel import init_from_launcher
from .renderer import DISPATCH_SPP, EMISSION_GRID_NAMES, Renderer
from .scene.environment import Environment, rotation_y
from .scene.transferfunc import TransferFunction
from .utils.image import save_ldr
from .voldata import DenseGrid, Volume
from .voldata.volume import load_grid


# --fau: volren_tpu.cli's built-in LUT (cli.py:267-276)
FAU_LUT = [
    (0, 0, 0, 0),
    (4 / 255, 49 / 255, 106 / 255, 0.33),
    (38 / 255, 97 / 255, 65 / 255, 0.66),
    (151 / 255, 27 / 255, 47 / 255, 1.0),
]
DEFAULT_SERVE_PORT = 8710
INTERACTIVE_SPP = 4       # samples per step of the interactive loop
PREVIEW_EDGE = 256        # the long edge of the --serve preview


def _load_volume(renderer: Renderer, path: str, density: float) -> None:
    """Load a volume file or an animation folder, fit it to the unit cube
    and scale the fit's density compensation by ``density`` (no commit)."""
    print(f"load volume: {path}")
    if os.path.isdir(path):
        volume = Volume.load_folder(path)
    else:
        volume = Volume(path)
        if path.endswith(".vdb"):
            for name in EMISSION_GRID_NAMES:
                try:
                    volume.update_grid_frame(volume.grid_frame_counter, load_grid(path, name),
                                             name)
                    break
                except Exception:
                    continue
    renderer.volume = volume
    renderer.density_scale = 1.0
    renderer.scale_and_move_to_unit_cube()
    renderer.density_scale *= density
    renderer.reset()


def _handle_path(renderer: Renderer, path: str, density: float) -> bool:
    """Load one non-script path; returns True if it loaded a volume. A
    failure is reported and the previous state kept."""
    try:
        if path.endswith(".hdr"):
            renderer.set_environment(Environment(path))
        elif path.endswith(".txt"):
            renderer.set_transferfunc(TransferFunction(path))
            renderer.show_environment = False
        else:
            _load_volume(renderer, path, density)
            return True
        renderer.reset()
    except Exception as e:  # keep previous state, like main.cpp:37-91
        print(f"Unable to load {path}: {e}", file=sys.stderr)
    return False


def run_script(renderer: Renderer, path: str) -> None:
    """Execute a Python script with the ``volpy`` shim bound to this
    renderer (counterpart of the embedded interpreter, main.cpp:83-91)."""
    from . import volpy

    volpy.bind_renderer(renderer)
    with open(path) as f:
        code = f.read()
    glb = {"__name__": "__main__", "__file__": path}
    exec(compile(code, path, "exec"), glb)


def _rotation(axis: int, degrees: float) -> np.ndarray:
    """--vol_rot_{x,y,z}: volren_tpu.cli's rotation matrix."""
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    rot = np.eye(4, dtype=np.float32)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    rot[a, a] = c
    rot[b, b] = c
    rot[a, b] = -s if axis != 1 else s
    rot[b, a] = s if axis != 1 else -s
    return rot


def _sync(renderer: Renderer) -> None:
    if renderer.device.type == "cuda":
        torch.cuda.synchronize(renderer.device)


def _device(argv: list[str]) -> tuple[torch.device, list[str]]:
    """Take --device / --cpu out of ``argv``, before the renderer exists."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        if argv[i] == "--cpu":
            device = "cpu"
        elif argv[i] == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            i += 1
        else:
            rest.append(argv[i])
        i += 1
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; none is available "
                           "(pass --device cpu to run the plain torch version)")
    return device, rest


def run(argv: list[str]):
    """Parse ``argv``, set the renderer up, and render offline (--render) or
    run the interactive loop. Returns (renderer, stats) with stats =
    {"spp", "seconds", "outputs"}: the samples traced, the wall time of
    the tracing (synchronized on the device) and the PNGs written; the
    offline render adds "frames", each frame's {"seconds", "finite",
    "mean"} (its trace time, and its framebuffer's finiteness and RGBA
    mean)."""
    device, argv = _device(list(argv))
    renderer = Renderer(device=device)

    interactive = True
    out_filename = "output.png"
    width, height = 1024, 1024
    animate = False
    animation_fps = 30.0
    serve_port = None
    paths: list[str] = []
    pending: list[tuple] = []  # deferred flag applications, in order

    i = 0
    while i < len(argv):
        arg = argv[i]

        def take(n=1):
            nonlocal i
            vals = argv[i + 1: i + 1 + n]
            if len(vals) != n:
                raise ValueError(f"{arg} needs {n} value(s)")
            i += n
            return vals if n > 1 else vals[0]

        if arg == "-w":
            width = int(take())
        elif arg == "-h":
            height = int(take())
        elif arg in ("--title", "--font", "--major", "--minor", "--swap", "--fontsize"):
            take()  # window-only flags, accepted for parity
        elif arg in ("--no-resize", "--no-decoration", "--floating", "--maximised",
                     "---debug", "--hidden"):
            pass
        elif arg == "--render":
            interactive = False
        elif arg == "--output":
            out_filename = take()
        elif arg in ("--samples", "--spp", "--sppx"):
            renderer.sppx = int(take())
        elif arg == "--bounces":
            renderer.bounces = int(take())
        elif arg == "--albedo":
            renderer.albedo = np.full(3, float(take()), np.float32)
        elif arg == "--density":
            renderer.density_scale = float(take())
        elif arg == "--emission":
            renderer.emission_scale = float(take())
        elif arg == "--phase":
            renderer.phase = float(take())
        elif arg == "--env_strength":
            pending.append(("env_strength", float(take())))
        elif arg == "--env_rot":
            pending.append(("env_rot", float(take())))
        elif arg == "--env_hide":
            renderer.show_environment = False
        elif arg in ("--turbo", "--viridis"):
            tf = renderer.transferfunc or TransferFunction()
            tf.colormap(arg.lstrip("-"))
            pending.append(("tf", tf))
        elif arg == "--fau":
            pending.append(("tf", TransferFunction(FAU_LUT)))
        elif arg in ("--tf_left", "--tf_width"):
            pending.append((arg[2:], float(take())))
        elif arg == "--cam_pos":
            renderer.cam.pos = np.array([float(v) for v in take(3)], np.float32)
        elif arg == "--cam_dir":
            d = np.array([float(v) for v in take(3)], np.float32)
            renderer.cam.dir = d / np.linalg.norm(d)
        elif arg == "--cam_fov":
            renderer.cam.fov_degree = float(take())
        elif arg == "--exposure":
            renderer.tonemap_exposure = float(take())
        elif arg == "--gamma":
            renderer.tonemap_gamma = float(take())
        elif arg in ("--vol_rot_x", "--vol_rot_y", "--vol_rot_z"):
            pending.append(("vol_rot", "xyz".index(arg[-1]), float(take())))
        elif arg == "--vol_crop_min":
            renderer.vol_clip_min = np.array([float(v) for v in take(3)], np.float32)
        elif arg == "--vol_crop_max":
            renderer.vol_clip_max = np.array([float(v) for v in take(3)], np.float32)
        elif arg == "--no-dda":
            # the global-majorant estimators live in the oracle engine only
            renderer._use_dda = False
            renderer.engine = "oracle"
        elif arg == "--engine":
            renderer.engine = take()
        elif arg == "--step-engine":
            renderer.step_engine = take()
        elif arg == "--animate":
            animate = True
        elif arg == "--fps":
            animation_fps = float(take())
        elif arg == "--distribute":
            init_from_launcher(renderer.device)
            renderer.distribute()
        elif arg == "--serve":
            has_port = i + 1 < len(argv) and argv[i + 1].isdigit()
            serve_port = int(take()) if has_port else DEFAULT_SERVE_PORT
        elif os.path.exists(arg):
            paths.append(arg)
        else:
            print(f"ignoring unknown argument: {arg}", file=sys.stderr)
        i += 1

    renderer.init(width, height)
    density = renderer.density_scale

    dirty = False  # a volume loaded (or rotated) since the last commit
    for path in paths:
        if path.endswith(".py"):
            if dirty:
                renderer.commit()
                dirty = False
            run_script(renderer, path)
        else:
            dirty |= _handle_path(renderer, path, density)

    # default debug volume if nothing loaded (main.cpp:464-474)
    if not renderer.volume.grids:
        box = DenseGrid(1, 1, 4, np.array([1.0, 2.5, 5.0, 10.0], np.float32))
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = 2.0 * renderer.cam.dir + np.array([0, -0.5, -2], np.float32)
        box.transform = t
        renderer.volume = Volume(box)
        dirty = True

    # deferred flags that touch the environment, the LUT and the volume
    window = {}
    for item in pending:
        if item[0] == "env_strength":
            renderer.environment.strength = item[1]
            renderer.set_environment(renderer.environment)
        elif item[0] == "env_rot":
            renderer.environment.transform = rotation_y(item[1])
            renderer.set_environment(renderer.environment)
        elif item[0] == "tf":
            renderer.set_transferfunc(item[1])
        elif item[0] in ("tf_left", "tf_width"):
            window["window_" + item[0][3:]] = item[1]
        elif item[0] == "vol_rot":
            renderer.volume.transform = renderer.volume.transform @ _rotation(item[1], item[2])
            dirty = True
    if window and renderer.transferfunc is not None:
        for key, val in window.items():
            setattr(renderer.transferfunc, key, val)
        renderer.set_transferfunc(renderer.transferfunc)
    if dirty:
        renderer.commit()
    renderer.reset()

    if interactive:
        if renderer.mesh.size > 1:
            raise NotImplementedError("--distribute across several ranks renders offline: "
                                      "add --render")
        return renderer, _interactive_loop(renderer, out_filename, animate, animation_fps,
                                           serve_port)
    return renderer, _offline(renderer, out_filename)


def _offline(renderer: Renderer, out_filename: str) -> dict:
    """Render every animation frame to ``<stem>_<frame:06d>.png``
    (main.cpp:524-558); across a mesh, only its rank 0 writes them."""
    writer = renderer.mesh.rank == 0
    print("rendering...")
    stem = os.path.splitext(out_filename)[0]
    outputs, frames = [], []
    seconds = 0.0
    for frame in range(renderer.volume.n_grid_frames()):
        renderer.reset()
        renderer.volume.grid_frame_counter = frame
        t0 = time.perf_counter()
        while renderer.sample < renderer.sppx:
            renderer.trace(min(renderer.sppx - renderer.sample, DISPATCH_SPP))
            _sync(renderer)
            print(f"{renderer.sample} / {renderer.sppx}", end="\r", flush=True)
        dt = max(time.perf_counter() - t0, 1e-9)
        seconds += dt
        print(f"\n{renderer.sppx} samples in {dt:.1f}s ({renderer.sppx / dt:.2f} spp/s, "
              f"{renderer.last_engine})")
        if writer:
            out_fn = f"{stem}_{frame:06d}.png"
            save_ldr(out_fn, renderer.draw(), flip=True, alpha=True)
            print(f"{out_fn} written.")
            outputs.append(out_fn)
        fb = renderer.framebuffer()
        frames.append({"seconds": dt, "finite": bool(torch.isfinite(fb).all()),
                       "mean": fb.mean(dim=(0, 1)).tolist()})
    return {"spp": renderer.sppx * renderer.volume.n_grid_frames(), "seconds": seconds,
            "outputs": outputs, "frames": frames}


def _interactive_loop(renderer: Renderer, out_filename: str, animate: bool,
                      animation_fps: float, serve_port: int | None = None) -> dict:
    """Headless analogue of the reference's interactive loop
    (main.cpp:477-523): progressive accumulation in 4-spp steps with a live
    preview file, 1 Hz kernel hot-reload polling (resets the accumulation
    on a swap, like shader reload), the volume animation advanced at
    animation_fps, an auto-save of the raw framebuffer at convergence
    (main.cpp:512-513). Ctrl-C ends it.

    With serve_port set, a localhost HTTP viewer runs alongside (port 0
    picks a free one; the line "viewer: http://127.0.0.1:<port>/" names
    it). The live view then renders at preview resolution (long edge at
    most 256 px) and the viewer's /snapshot renders one frame at the
    requested resolution to out_filename. On exit it prints the samples
    traced and their rate."""
    from .utils.hotreload import KernelWatcher

    watcher = KernelWatcher()
    preview = os.path.splitext(out_filename)[0] + "_preview.png"
    reload_timer = animation_timer = time.time()
    preview_timer = 0.0
    viewer = None
    lock = contextlib.nullcontext()
    full_res = renderer.resolution
    traced, trace_seconds, outputs = 0, 0.0, []
    if serve_port is not None:
        from .viewer import ViewerServer

        w, h = full_res
        if max(w, h) > PREVIEW_EDGE:
            scale = PREVIEW_EDGE / max(w, h)
            renderer.resize(max(16, round(w * scale)), max(16, round(h * scale)))
            print(f"serving at preview {renderer.resolution[0]}x{renderer.resolution[1]} "
                  f"(full {w}x{h} via /snapshot)")
        viewer = ViewerServer(renderer, port=serve_port).start()
        lock = viewer.lock
        print(f"viewer: http://127.0.0.1:{viewer.port}/", flush=True)
    print(f"interactive (headless): preview -> {preview}, Ctrl-C to stop", flush=True)
    try:
        while True:
            if time.time() - reload_timer >= 1.0:  # shader_check_delay_ms
                if watcher.reload_modified_kernels():
                    renderer.reset()
                reload_timer = time.time()
            if viewer is not None and viewer.snapshot_requested:
                viewer.snapshot_requested = False
                pw, ph = renderer.resolution
                with lock:
                    renderer.resize(*full_res)
                    print(f"\nsnapshot: rendering {full_res[0]}x{full_res[1]} at "
                          f"{renderer.sppx} spp...")
                    while renderer.sample < renderer.sppx:
                        renderer.trace(min(renderer.sppx - renderer.sample, INTERACTIVE_SPP))
                        print(f"snapshot {renderer.sample}/{renderer.sppx}", end="\r",
                              flush=True)
                    save_ldr(out_filename, renderer.draw(), flip=True, alpha=True)
                    outputs.append(out_filename)
                    print(f"\n{out_filename} written (tonemapped snapshot).", flush=True)
                    renderer.resize(pw, ph)
            if animate and time.time() - animation_timer >= 1.0 / animation_fps:
                renderer.volume.grid_frame_counter = (
                    renderer.volume.grid_frame_counter + 1) % renderer.volume.n_grid_frames()
                renderer.reset()
                animation_timer = time.time()
            if renderer.sample < renderer.sppx:
                t0 = time.perf_counter()
                with lock:
                    step = min(renderer.sppx - renderer.sample, INTERACTIVE_SPP)
                    renderer.trace(step)
                    _sync(renderer)
                dt = max(time.perf_counter() - t0, 1e-9)
                traced += step
                trace_seconds += dt
                eta = dt / step * (renderer.sppx - renderer.sample)
                print(f"sample {renderer.sample}/{renderer.sppx} ({step / dt:.2f} spp/s, "
                      f"est: {int(eta) // 60}m {int(eta) % 60}s)", end="\r", flush=True)
                # throttle preview writes to ~1 Hz: a PNG encode at 1024^2
                # costs a meaningful slice of a step
                if time.time() - preview_timer >= 1.0 or renderer.sample >= renderer.sppx:
                    with lock:
                        img = renderer.draw()
                    save_ldr(preview, img, flip=True, alpha=False)
                    preview_timer = time.time()
                if renderer.sample >= renderer.sppx:
                    if renderer.resolution == full_res:
                        # the reference auto-saves the raw (untonemapped) fb
                        save_ldr(out_filename, renderer.framebuffer().cpu().numpy(), flip=True,
                                 alpha=True)
                        outputs.append(out_filename)
                        print(f"\n{out_filename} written.", flush=True)
                    else:
                        # preview-res serve mode: out_filename is reserved
                        # for full-res /snapshot renders
                        print(f"\npreview converged ({renderer.sample} spp).", flush=True)
            else:
                time.sleep(0.1)  # 10 fps idle (main.cpp:515)
    except KeyboardInterrupt:
        print("\nexiting.")
    finally:
        if viewer is not None:
            viewer.stop()
    print(f"interactive: {traced} spp at {renderer.resolution[0]}x{renderer.resolution[1]} "
          f"in {trace_seconds!r} s of tracing ({traced / max(trace_seconds, 1e-9)!r} spp/s, "
          f"{renderer.last_engine})", flush=True)
    return {"spp": traced, "seconds": trace_seconds, "outputs": outputs}


def main(argv: list[str] | None = None) -> int:
    try:
        run(sys.argv[1:] if argv is None else argv)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
