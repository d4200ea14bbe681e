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
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import scene as dscene
from .ops import tonemap as _tonemap
from .ops.kernels import megakernel
from .ops.kernels.pack import bake_tf_majorant, build_env_pool, build_params, pack_scene
from .scene.camera import Camera
from .scene.environment import Environment
from .scene.transferfunc import TransferFunction
from .utils.image import save_ldr
from .voldata import Volume
from .voldata.brick import to_brick_grid

EMISSION_GRID_NAMES = ("flame", "flames", "temperature")  # renderer.cpp:65

# samples per kernel dispatch (volren_tpu.renderer.Renderer.trace's fence)
DISPATCH_SPP = 64


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
        self._emission_grids = []  # per-frame GridTables or None
        self._majorant_emission = 0.0
        self._packed = None        # (frame, KernelScene)
        self._env_device = None
        self._tf_device = None
        # "cuda_kernel" or "torch_plain": what the most recent trace() ran
        self.last_engine = None

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
        normalises the emission lookup."""
        self._density_grids, self._emission_grids = [], []
        self._majorant_emission = 0.0
        for frame in self.volume.grids:
            self._density_grids.append(dscene.upload_grid(
                to_brick_grid(frame["density"]), self.volume.transform, self.device))
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
        (renderer.cpp:78-145), in dispatches of at most DISPATCH_SPP. The
        tables (and a TF majorant table) are set up once per trace."""
        if not self._density_grids:
            self.commit()
        spp = int(spp)
        ks, params = self._kernel_scene(), self._trace_params()
        while spp > 0:
            n = min(DISPATCH_SPP, spp)
            # the NEE pool is redrawn for every dispatch from (seed, sample)
            pool = build_env_pool(self._env_device, int(self.seed), int(self.sample))
            pf, pi = build_params(ks, params, self._width, self._height, self.sample, n)
            accum = megakernel.render(ks, pool, pf, pi)
            self.last_engine = "cuda_kernel" if self.device.type == "cuda" else "torch_plain"
            prev = self.sample
            self.sample += n
            accum = accum.reshape(self._height, self._width, 4)
            self._fb = (self._fb * prev + accum) / self.sample
            spp -= n

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
