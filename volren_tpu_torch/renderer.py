"""Renderer: scene state + progressive trace passes, on one torch device.

The counterpart of volren_tpu.renderer.Renderer for its kernel path: a
brick-grid density volume under an environment map, optionally classified
by a transfer function (``set_transferfunc``) and glowing from an
emission grid (a frame's ``flame`` / ``flames`` / ``temperature`` grid).
``commit()`` uploads every animation frame's brick grids, ``trace(spp)``
adds samples to the progressive mean in a device framebuffer, ``draw()``
applies the Hable tonemap. On a CUDA device a trace launches the CUDA
megakernel; on the CPU it runs the kernel's plain torch version. The
choice follows ``device`` and is recorded in ``last_engine``.

``engine = "oracle"`` traces with the oracle engine instead
(volren_tpu.ops.tracer, the GLSL-order tracer): one progressive pass per
sample, up to DISPATCH_SPP of them in one launch of ``csrc/oracle.cu`` on a
CUDA device (``ops/kernels/oracle.py``), or its plain torch version on the
CPU. It is
the only engine with the global-majorant estimators, delta and ratio
tracking: ``_use_dda = False`` selects them, and the megakernel engine,
DDA-only, refuses to trace with it.

The rest of volren_tpu.renderer.Renderer's surface is here too:
checkpoints (the same ``.npz`` keys, so either package loads the other's),
``describe()``, ``profile()`` (a torch.profiler trace), ``save_with_alpha``,
and the ``engine`` / ``step_engine`` names. The JAX package's step
engines are bitwise-identical schedules of the same sample streams, so
every name renders through the megakernel. ``distribute(mesh)`` renders
across the ranks of a torch.distributed group (``parallel.sharding``): each
rank traces its band of rows for its share of every dispatch's samples on
``cuda:rank % device_count``, and every rank ends each dispatch with the
whole frame; the oracle engine ignores the mesh, as volren_tpu's does.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .ops import scene as dscene
from .ops import tonemap as _tonemap
from .ops.kernels import megakernel, oracle
from .ops.kernels.pack import DISPATCH_SPP, bake_tf_majorant, build_env_pool, pack_scene
from .parallel import sharding
from .scene.camera import Camera
from .scene.environment import Environment
from .scene.transferfunc import TransferFunction
from .utils.image import save_ldr
from .voldata import Volume
from .voldata.brick import to_brick_grid

EMISSION_GRID_NAMES = ("flame", "flames", "temperature")  # renderer.cpp:65

# the port's engines: the megakernel (which volren_tpu's "wavefront"
# engine and its step engines name) and the oracle
ENGINE = "megakernel"
ORACLE = "oracle"
STEP_ENGINES = ("auto", "pallas", "device_queue", "queue", "chunked", "device", "host")


class Renderer:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda') needs a CUDA device; "
                               "none is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        # general settings (renderer.h:31-38)
        self.sample = 0
        self.sppx = 1024
        self.seed = 42
        self.bounces = 100
        self.tonemap_exposure = 5.0
        self.tonemap_gamma = 2.2
        self.tonemapping = True
        self.show_environment = True
        # volume settings (renderer.h:40-44)
        self.albedo = np.array([0.9, 0.9, 0.9], np.float32)
        self.phase = 0.0
        self.density_scale = 1.0
        self.emission_scale = 100.0
        # scene
        self.volume = Volume()
        self.environment = Environment.white()
        self.transferfunc = None
        self.vol_clip_min = np.zeros(3, np.float32)
        self.vol_clip_max = np.ones(3, np.float32)
        self.cam = Camera()
        # device state
        self._width = 1024
        self._height = 1024
        self._fb = None
        self._density_grids = []   # per-frame GridTables
        self._density_ranges = []  # per-frame (density grid, its minorant_majorant())
        self._emission_grids = []  # per-frame GridTables or None
        self._majorant_emission = 0.0
        self._packed = None        # (frame, KernelScene)
        self._env_device = None
        self._tf_device = None
        self._engine = ENGINE
        self._step_engine = "auto"
        # DDA tracking (True) or the global-majorant estimators, delta and
        # ratio tracking (the oracle engine only; the CLI's --no-dda)
        self._use_dda = True
        # "cuda_kernel" / "torch_plain" (the megakernel) or "cuda_oracle" /
        # "torch_oracle": what the most recent trace() ran
        self.last_engine = None
        # the parallel.sharding.Mesh the megakernel renders across: a world
        # of one until distribute()
        self.mesh = sharding.Mesh(1, 1)

    # ---- engine selection (volren_tpu.renderer's names) ----

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, name: str):
        if name not in (ENGINE, "wavefront", ORACLE):
            raise ValueError(f"unknown engine {name!r}")
        self._engine = ORACLE if name == ORACLE else ENGINE

    @property
    def step_engine(self) -> str:
        """The step engine asked for; every name renders through the kernel
        (``last_engine`` says what ran)."""
        return self._step_engine

    @step_engine.setter
    def step_engine(self, name: str):
        if name not in STEP_ENGINES:
            raise ValueError(f"unknown step engine {name!r} (one of {STEP_ENGINES})")
        self._step_engine = name

    # ---- lifecycle (RendererOpenGL::init/resize/commit/trace/draw/reset) ----

    def init(self, width: int = 1024, height: int = 1024):
        self.resize(width, height)
        if self._env_device is None:
            self.set_environment(self.environment)
        return self

    def resize(self, width: int, height: int):
        self._width, self._height = int(width), int(height)
        self._fb = torch.zeros((self._height, self._width, 4), dtype=torch.float32,
                               device=self.device)
        self.reset()

    def set_environment(self, env: Environment):
        self.environment = env
        self._env_device = dscene.upload_environment(env, self.device)
        self._packed = None

    def set_transferfunc(self, tf: TransferFunction | None):
        self.transferfunc = tf
        self._tf_device = None if tf is None else dscene.upload_transferfunc(tf, self.device)
        self._packed = None

    def commit(self):
        """Upload every animation frame's density grid, and its emission grid
        (the first of EMISSION_GRID_NAMES it has), as brick grids
        (renderer.cpp:56-76). The emission majorant over all frames
        normalises the emission lookup. Each frame's density majorant is
        kept for ``_trace_params``: a dense grid's is a scan of every voxel
        (tens of ms for a 512x512x256 frame), too slow to repeat per trace."""
        self._density_grids, self._emission_grids, self._density_ranges = [], [], []
        self._majorant_emission = 0.0
        for frame in self.volume.grids:
            self._density_grids.append(dscene.upload_grid(
                to_brick_grid(frame["density"]), self.volume.transform, self.device))
            self._density_ranges.append((frame["density"], frame["density"].minorant_majorant()))
            emission = next((frame[n] for n in EMISSION_GRID_NAMES if n in frame), None)
            if emission is not None:
                self._majorant_emission = max(self._majorant_emission,
                                              emission.minorant_majorant()[1])
                emission = dscene.upload_grid(to_brick_grid(emission), self.volume.transform,
                                              self.device)
            self._emission_grids.append(emission)
        self._packed = None

    def reset(self):
        self.sample = 0

    # ---- parameter assembly ----

    def _trace_params(self) -> dscene.TraceParams:
        bb_min, bb_max = self.volume.AABB()
        extent = bb_max - bb_min
        frame, grid = self.volume.grid_frame_counter, self.volume.current_grid()
        if frame < len(self._density_ranges) and self._density_ranges[frame][0] is grid:
            _mn, mj = self._density_ranges[frame][1]   # the committed frame's
        else:
            _mn, mj = self.volume.minorant_majorant()
        maj = max(mj * self.density_scale, 1e-20)
        f32 = np.float32
        return dscene.TraceParams(
            cam_pos=np.asarray(self.cam.pos, f32),
            cam_transform=np.asarray(self.cam.transform, f32),
            cam_fov=float(f32(self.cam.fov_degree)),
            bb_min=(bb_min + self.vol_clip_min * extent).astype(f32),
            bb_max=(bb_min + self.vol_clip_max * extent).astype(f32),
            majorant=float(f32(maj)),
            inv_majorant=float(f32(1.0 / maj)),
            albedo=np.broadcast_to(self.albedo, (3,)).astype(f32),
            phase_g=float(f32(self.phase)),
            density_scale=float(f32(self.density_scale)),
            bounces=int(self.bounces),
            show_environment=1 if self.show_environment else 0,
            seed=int(np.uint32(self.seed)),
            emission_scale=float(f32(self.emission_scale)),
            emission_norm=float(f32(1.0 / max(self._majorant_emission, 1e-4)
                                    if self._majorant_emission > 0.0 else 1.0)),
        )

    def _frame_emission(self):
        """The current frame's own emission grid, or None."""
        frame = self.volume.grid_frame_counter
        return self._emission_grids[frame] if frame < len(self._emission_grids) else None

    def _config(self) -> dscene.TraceConfig:
        """The oracle's switches for the current frame (volren_tpu.renderer.
        Renderer._config without its TPU-only fields)."""
        return dscene.TraceConfig(use_dda=bool(self._use_dda),
                                  use_tf=self._tf_device is not None,
                                  has_emission=self._frame_emission() is not None)

    def _scene_tables(self) -> dscene.SceneTables:
        """The oracle's scene for the current frame."""
        return dscene.SceneTables(density=self._density_grids[self.volume.grid_frame_counter],
                                  emission=self._frame_emission(), env=self._env_device,
                                  tf=self._tf_device)

    def _kernel_scene(self):
        """The kernel's tables for the current frame (packed once per
        frame), with the TF majorant table baked for the current trace
        parameters when a transfer function is set."""
        frame = self.volume.grid_frame_counter
        if self._packed is None or self._packed[0] != frame:
            self._packed = (frame, pack_scene(self._density_grids[frame], self._env_device,
                                              tf=self._tf_device,
                                              emission=self._emission_grids[frame]))
        ks = self._packed[1]
        return ks if ks.tf is None else bake_tf_majorant(ks, self._trace_params())

    # ---- rendering ----

    def trace(self, spp: int = 1):
        """Advance the progressive accumulation by ``spp`` samples
        (renderer.cpp:78-145): with the megakernel, in dispatches of at
        most DISPATCH_SPP, the tables (and a TF majorant table) set up once
        per trace; with the oracle, one pass per sample
        (volren_tpu/renderer.py:700-711), in launches of at most
        DISPATCH_SPP passes."""
        if not self._density_grids:
            self.commit()
        spp = int(spp)
        if self._engine == ORACLE:
            scene, params, cfg = self._scene_tables(), self._trace_params(), self._config()
            while spp > 0:
                n = min(DISPATCH_SPP, spp)
                with torch.profiler.record_function("volren_tpu_torch.oracle"):
                    self._fb = oracle.trace_passes(scene, params, cfg, self._fb, self.sample + 1,
                                                   n)
                self.last_engine = ("cuda_oracle" if self.device.type == "cuda"
                                    else "torch_oracle")
                self.sample += n
                spp -= n
            return
        if not self._use_dda:
            raise NotImplementedError("the megakernel engine is DDA-only; use engine='oracle' "
                                      "for the global-majorant estimators")
        ks, params = self._kernel_scene(), self._trace_params()
        # this rank's band of the running mean: the whole frame in a world
        # of one, gathered from every rank after the dispatches otherwise
        row0, rows = sharding.band_rows(self._height, self.mesh.n_tiles, self.mesh.tile)
        band = self._fb[row0:row0 + rows]
        while spp > 0:
            n = min(DISPATCH_SPP, spp)
            with torch.profiler.record_function("volren_tpu_torch.megakernel"):
                # the NEE pool is redrawn for every dispatch from (seed, sample)
                pool = build_env_pool(self._env_device, int(self.seed), int(self.sample))
                accum = sharding.render_sharded(ks, pool, params, self._width, self._height,
                                                n, self.sample, self.mesh)
            self.last_engine = "cuda_kernel" if self.device.type == "cuda" else "torch_plain"
            prev = self.sample
            self.sample += n
            band = (band * prev + accum.reshape(rows, self._width, 4)) / self.sample
            spp -= n
        self._fb = sharding.gather_bands(band, self.mesh, self._width, self._height)

    def render(self, spp: int):
        """Render spp samples from scratch (bindings.cpp:124-132)."""
        self.sample = 0
        self._fb = torch.zeros_like(self._fb)
        self.trace(spp=int(spp))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def draw(self) -> np.ndarray:
        """Tonemapped (or raw) framebuffer as numpy (H, W, 4)."""
        fb = self._fb
        if self.tonemapping:
            fb = _tonemap.tonemap(fb, self.tonemap_exposure, self.tonemap_gamma)
        return fb.cpu().numpy()

    def fbo_data(self) -> np.ndarray:
        """Raw HDR framebuffer RGB (H, W, 3), device -> host readback
        (bindings.cpp:141-148)."""
        return self._fb[..., :3].cpu().numpy()

    def framebuffer(self) -> torch.Tensor:
        return self._fb

    # ---- output ----

    def save(self, filename: str = "out.png"):
        save_ldr(filename, self.draw(), flip=True, alpha=False)
        print(f"{filename} written.")

    def save_with_alpha(self, filename: str = "out.png"):
        if not filename.endswith(".png"):
            filename = filename.rsplit(".", 1)[0] + ".png"
        save_ldr(filename, self.draw(), flip=True, alpha=True)
        print(f"{filename} written.")

    # ---- checkpoint / resume: the progressive state is (framebuffer,
    # sample, seed), under volren_tpu's keys ----

    def save_checkpoint(self, path: str):
        np.savez_compressed(path, framebuffer=self._fb.cpu().numpy(), sample=self.sample,
                            seed=self.seed)

    def load_checkpoint(self, path: str):
        with np.load(path) as data:
            self._fb = torch.as_tensor(np.array(data["framebuffer"], np.float32),
                                       device=self.device)
            self.sample = int(data["sample"])
            self.seed = int(data["seed"])
        self._height, self._width = self._fb.shape[:2]

    def distribute(self, mesh=None):
        """Render across ``mesh`` (a ``parallel.sharding.Mesh``): with no
        argument, a mesh of every rank of the default group as row bands
        (``make_mesh(n_tiles=world size)``; a world of one when no group is
        initialised). On a CUDA device each rank moves to ``cuda:rank %
        device_count``."""
        mesh = sharding.make_mesh() if mesh is None else mesh
        if self.device.type == "cuda":
            device = torch.device("cuda", mesh.global_rank % torch.cuda.device_count())
            self._move_to(device)
            torch.cuda.set_device(device)
        self.mesh = mesh
        return self

    def _move_to(self, device: torch.device):
        """Put the renderer's device state on ``device``."""
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return
        self.device = device
        self._packed = None
        if self._fb is not None:
            self._fb = self._fb.to(device)
        if self._env_device is not None:
            self.set_environment(self.environment)
        if self._tf_device is not None:
            self.set_transferfunc(self.transferfunc)
        if self._density_grids:
            self.commit()

    def describe(self) -> dict:
        """All live parameters, under volren_tpu.renderer.Renderer.describe's
        keys (``engine`` names the port's engine: "megakernel" or
        "oracle")."""
        return {
            "sample": self.sample,
            "sppx": self.sppx,
            "seed": self.seed,
            "bounces": self.bounces,
            "tonemap_exposure": self.tonemap_exposure,
            "tonemap_gamma": self.tonemap_gamma,
            "tonemapping": self.tonemapping,
            "show_environment": self.show_environment,
            "albedo": tuple(float(v) for v in self.albedo),
            "phase": self.phase,
            "density_scale": self.density_scale,
            "emission_scale": self.emission_scale,
            "vol_clip_min": tuple(float(v) for v in self.vol_clip_min),
            "vol_clip_max": tuple(float(v) for v in self.vol_clip_max),
            "env_strength": self.environment.strength,
            "cam_pos": tuple(float(v) for v in self.cam.pos),
            "cam_dir": tuple(float(v) for v in self.cam.dir),
            "cam_fov": self.cam.fov_degree,
            "resolution": self.resolution,
            "engine": self.engine,
            "grid_frames": self.volume.n_grid_frames(),
            "grid_frame": self.volume.grid_frame_counter,
            "transferfunc": None
            if self.transferfunc is None
            else {
                "size": self.transferfunc.size,
                "window_left": self.transferfunc.window_left,
                "window_width": self.transferfunc.window_width,
            },
        }

    def __repr__(self) -> str:
        lines = [f"{k}: {v}" for k, v in self.describe().items()]
        return "Renderer(\n  " + "\n  ".join(lines) + "\n)"

    @contextlib.contextmanager
    def profile(self, log_dir: str):
        """Context manager: a torch.profiler trace (the card's kernels too
        on a CUDA device) of the calls inside it, written to ``log_dir`` as
        a Chrome trace (``*.pt.trace.json``, for Perfetto or TensorBoard).
        Yields the profiler."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"volren_{os.getpid()}_{time.time_ns()}.pt.trace.json"))

    # ---- helpers ----

    def scale_and_move_to_unit_cube(self):
        """Fit the whole animation into [-0.5, 0.5]^3 and compensate
        density_scale by the size factor (renderer.cpp:227-242)."""
        bb_min = np.full(3, np.finfo(np.float32).max)
        bb_max = np.full(3, -np.finfo(np.float32).max)
        for frame in self.volume.grids:
            lo, hi = frame["density"].world_aabb()
            bb_min = np.minimum(bb_min, lo)
            bb_max = np.maximum(bb_max, hi)
        extent = bb_max - bb_min
        size = float(extent.max())
        if size != 1.0:
            t = np.eye(4, dtype=np.float32)
            t[:3, :3] *= 1.0 / size
            t[:3, 3] = (-bb_min - 0.5 * extent) / size
            self.volume.transform = t
            self.density_scale *= size

    @property
    def resolution(self) -> tuple[int, int]:
        return (self._width, self._height)
