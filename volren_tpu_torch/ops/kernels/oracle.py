"""The oracle engine's passes: ``trace_passes`` (and ``trace_pass``, one
pass) launches the CUDA kernel (``volren_tpu_torch/csrc/oracle.cu``) on
CUDA tensors and runs its plain torch version,
``volren_tpu_torch.ops.tracer.trace_passes``, on CPU tensors.

Both compute progressive passes of volren_tpu.ops.tracer.trace_pass, the
JAX package's GLSL-order path tracer: every pixel traces one path per
pass seeded from (pixel, sample), with delta / ratio tracking against the
global majorant or DDA tracking over the majorant pyramid
(``TraceConfig.use_dda``), NEE through the hierarchical environment warp,
and the running-mean update of the framebuffer, pass after pass. The
kernel traces all of a call's passes in one launch, (pixel, pass) items on
a warp's lanes folded in pass order, and repeats the plain version's
arithmetic operation for operation, so on the card the two framebuffers
are bitwise equal. Its eight instantiations are <USE_DDA, USE_TF,
HAS_EMI>; ``trace_stats`` runs their STATS twins.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading

import numpy as np
import torch

from . import build as _build
from .. import tracer as _tracer
from ..scene import SceneTables, TraceConfig, TraceParams

SOURCE = os.path.join(_build.CSRC, "oracle.cu")
NVCC_FLAGS = _build.NVCC_FLAGS

# pf (OF_SIZE,) float32 slots; must match csrc/oracle.cu
OF_CAM_POS = 0          # 3
OF_CAM_XFORM = 3        # 9 row-major (3, 3) view -> world
OF_CAM_FOV = 12         # degrees
OF_BB_MIN = 13          # 3
OF_BB_MAX = 16          # 3
OF_MAJORANT = 19
OF_INV_MAJORANT = 20
OF_ALBEDO = 21          # 3
OF_PHASE_G = 24
OF_DENSITY_SCALE = 25
OF_EMI_SCALE = 26
OF_EMI_NORM = 27
OF_INV_XFORM = 28       # 16 row-major (4, 4): world -> density index
OF_XFORM = 44           # 16: density index -> world
OF_EMI_INV = 60         # 16: world -> emission index
OF_ENV_XFORM = 76       # 9
OF_ENV_INV = 85         # 9
OF_ENV_STRENGTH = 94
OF_TF_LEFT = 95
OF_TF_WIDTH = 96
OF_SIZE = 100

# pi (OI_SIZE,) int32 slots
OI_WIDTH = 0
OI_HEIGHT = 1
OI_FIRST_SAMPLE = 2     # the launch's first sample, 1-based
OI_BOUNCES = 3
OI_SEED = 4             # uint32 bit pattern
OI_SHOW_ENV = 5
OI_MAX_STEPS = 6
OI_N_BRICKS = 7         # 3
OI_MIP_DIMS = 10        # 12: (z, y, x) per level 0..3
OI_MIP_OFFSETS = 22     # 4
OI_ENV_H = 26
OI_ENV_W = 27
OI_IMP_LEVELS = 28      # importance pyramid levels (512^2 .. 1^2: 10)
OI_IMP_DIM = 29         # side of level 0
OI_TF_SIZE = 30         # LUT bins; 0 = no TF
OI_EMI_N_BRICKS = 31    # 3
OI_EMI_N_SLOTS = 34     # 0 = no emission
OI_N_SLOTS = 35
OI_N_PASSES = 36        # passes of the launch: samples first .. first + n - 1
OI_SIZE = 40


def build_params(scene: SceneTables, params: TraceParams, cfg: TraceConfig, width: int,
                 height: int, first_sample: int, n_passes: int = 1):
    """(pf, pi) host arrays for a launch of ``n_passes`` passes from sample
    ``first_sample`` on. The kernel computes each pass's weight, 1 /
    sample in float32 (``tracer.pass_weight``)."""
    f32 = np.float32
    pf = np.zeros(OF_SIZE, f32)
    pf[OF_CAM_POS:OF_CAM_POS + 3] = params.cam_pos
    pf[OF_CAM_XFORM:OF_CAM_XFORM + 9] = np.asarray(params.cam_transform, f32).reshape(-1)
    pf[OF_CAM_FOV] = params.cam_fov
    pf[OF_BB_MIN:OF_BB_MIN + 3] = params.bb_min
    pf[OF_BB_MAX:OF_BB_MAX + 3] = params.bb_max
    pf[OF_MAJORANT] = params.majorant
    pf[OF_INV_MAJORANT] = params.inv_majorant
    pf[OF_ALBEDO:OF_ALBEDO + 3] = params.albedo
    pf[OF_PHASE_G] = params.phase_g
    pf[OF_DENSITY_SCALE] = params.density_scale
    pf[OF_EMI_SCALE] = params.emission_scale
    pf[OF_EMI_NORM] = params.emission_norm
    pf[OF_INV_XFORM:OF_INV_XFORM + 16] = np.asarray(scene.density.inv_transform, f32).reshape(-1)
    pf[OF_XFORM:OF_XFORM + 16] = np.asarray(scene.density.transform, f32).reshape(-1)
    env = scene.env
    pf[OF_ENV_XFORM:OF_ENV_XFORM + 9] = np.asarray(env.transform, f32).reshape(-1)
    pf[OF_ENV_INV:OF_ENV_INV + 9] = np.asarray(env.inv_transform, f32).reshape(-1)
    pf[OF_ENV_STRENGTH] = env.strength
    pi = np.zeros(OI_SIZE, np.int32)
    pi[OI_WIDTH], pi[OI_HEIGHT] = width, height
    pi[OI_FIRST_SAMPLE] = first_sample
    pi[OI_N_PASSES] = n_passes
    pi[OI_BOUNCES] = params.bounces
    pi[OI_SEED] = np.array(params.seed, np.uint32).view(np.int32)
    pi[OI_SHOW_ENV] = 1 if int(params.show_environment) > 0 else 0
    pi[OI_MAX_STEPS] = cfg.max_steps
    pi[OI_N_BRICKS:OI_N_BRICKS + 3] = scene.density.n_bricks
    pi[OI_N_SLOTS] = scene.density.atlas.shape[0]
    pi[OI_MIP_DIMS:OI_MIP_DIMS + 12] = np.asarray(scene.density.mip_dims).reshape(-1)
    pi[OI_MIP_OFFSETS:OI_MIP_OFFSETS + 4] = scene.density.mip_offsets
    pi[OI_ENV_H], pi[OI_ENV_W] = (int(v) for v in env.envmap.shape[:2])
    pi[OI_IMP_LEVELS] = len(env.imp_mips)
    pi[OI_IMP_DIM] = env.imp_mips[0].shape[0] if env.imp_mips else 0
    if cfg.use_tf:
        pf[OF_TF_LEFT] = scene.tf.window_left
        pf[OF_TF_WIDTH] = scene.tf.window_width
        pi[OI_TF_SIZE] = scene.tf.lut.shape[0]
    if cfg.has_emission:
        pf[OF_EMI_INV:OF_EMI_INV + 16] = np.asarray(scene.emission.inv_transform,
                                                    f32).reshape(-1)
        pi[OI_EMI_N_BRICKS:OI_EMI_N_BRICKS + 3] = scene.emission.n_bricks
        pi[OI_EMI_N_SLOTS] = scene.emission.atlas.shape[0]
    return pf, pi


def _variant(scene: SceneTables, cfg: TraceConfig):
    """(use_dda, use_tf, has_emi) of a pass; the scene and the switches
    must agree on it."""
    if cfg.use_tf != (scene.tf is not None) or cfg.has_emission != (scene.emission is not None):
        raise ValueError("the TraceConfig was built for another scene variant")
    return bool(cfg.use_dda), bool(cfg.use_tf), bool(cfg.has_emission)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

# the loaded library; utils.hotreload swaps in a rebuilt one under the lock
_LIB = None
_LIB_LOCK = threading.Lock()


def build(flags: list[str] = NVCC_FLAGS, source: str = SOURCE) -> str:
    """Compile csrc/oracle.cu (or ``source``) with nvcc for sm_90a into
    ``build/libvolren_oracle_<hash>.so`` and return its path."""
    return _build.build(source, "volren_oracle", flags)


def _variant_name(kernel: str) -> str:
    flags = re.search(r"ILb([01])ELb([01])ELb([01])ELb([01])E", kernel)
    if not flags:
        return kernel
    return (f"<{flags.group(1)},{flags.group(2)},{flags.group(3)}>"
            + (" stats" if flags.group(4) == "1" else ""))


def resource_usage(lib_path: str) -> str:
    """ptxas's register, stack and spill lines for the library at
    ``lib_path``, one entry per instantiation, named by its <USE_DDA,
    USE_TF, HAS_EMI> template arguments ("stats" for the STATS ones)."""
    return "; ".join(_build.resource_usage(lib_path, _variant_name))


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built library and declare its C entry point."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load(lib_path, {"volren_oracle_trace": [p, p, i] + [p] * 19,
                                  "volren_oracle_blocks": [i] * 7})


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = load(build())
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_grid(prefix, g):
    bx, by, bz = g.n_bricks
    _check(g.atlas, f"{prefix}atlas", torch.uint8, (g.atlas.shape[0], 512))
    for name, t, dtype in (("slot", g.slot, torch.int32), ("lo", g.lo, torch.float32),
                           ("hi", g.hi, torch.float32)):
        _check(t, prefix + name, dtype, (bx * by * bz,))


def _imp_table(env) -> torch.Tensor:
    """The importance pyramid as one flat tensor, level after level: the
    storage that ``scene.imp_pyramid``'s views share, else a copy."""
    mips = env.imp_mips
    if not mips:
        raise ValueError("the environment carries no importance pyramid (EnvTables.imp_mips)")
    dim = int(mips[0].shape[0])
    if dim != 1 << (len(mips) - 1) or any(tuple(m.shape) != (dim >> k, dim >> k)
                                          for k, m in enumerate(mips)):
        raise ValueError("the importance pyramid must be square, 2^n x 2^n down to 1 x 1")
    base, offs = mips[0], np.cumsum([0] + [m.numel() for m in mips])
    if all(m.is_contiguous() and m.data_ptr() == base.data_ptr() + 4 * int(o)
           for m, o in zip(mips, offs)):
        return torch.as_strided(base, (int(offs[-1]),), (1,))
    return torch.cat([m.reshape(-1) for m in mips]).contiguous()


def _launch_cuda(scene: SceneTables, params: TraceParams, cfg: TraceConfig,
                 framebuffer: torch.Tensor, first_sample: int, n_passes: int,
                 capped: torch.Tensor | None = None, stats: torch.Tensor | None = None,
                 btimes: torch.Tensor | None = None) -> torch.Tensor:
    use_dda, use_tf, has_emi = _variant(scene, cfg)
    h, w = int(framebuffer.shape[0]), int(framebuffer.shape[1])
    _check(framebuffer, "framebuffer", torch.float32, (h, w, 4))
    g = scene.density
    _check_grid("", g)
    _check(g.mip_maj, "mip_maj", torch.float32)
    env = scene.env
    _check(env.envmap, "envmap", torch.float32, (env.envmap.shape[0], env.envmap.shape[1], 3))
    imp = _imp_table(env)
    _check(imp, "imp_mips", torch.float32)
    ptrs = [0] * 5   # tf_lut, emi atlas, slot, lo, hi
    if use_tf:
        _check(scene.tf.lut, "tf.lut", torch.float32, (scene.tf.lut.shape[0], 4))
        ptrs[0] = scene.tf.lut.data_ptr()
    if has_emi:
        _check_grid("emission.", scene.emission)
        e = scene.emission
        ptrs[1:] = [t.data_ptr() for t in (e.atlas, e.slot, e.lo, e.hi)]
    if capped is not None:
        _check(capped, "capped", torch.int32, (1,))
    pf, pi = build_params(scene, params, cfg, w, h, first_sample, n_passes)
    out = torch.empty_like(framebuffer)
    # the persistent blocks' group counter, 0 at the launch
    next_group = torch.zeros(1, dtype=torch.int32, device=framebuffer.device)
    stream = torch.cuda.current_stream(framebuffer.device).cuda_stream
    err = _lib().volren_oracle_trace(
        pf.ctypes.data, pi.ctypes.data, int(use_dda), g.atlas.data_ptr(), g.slot.data_ptr(),
        g.lo.data_ptr(), g.hi.data_ptr(), g.mip_maj.data_ptr(), env.envmap.data_ptr(),
        imp.data_ptr(), *ptrs, framebuffer.data_ptr(), out.data_ptr(),
        0 if capped is None else capped.data_ptr(), next_group.data_ptr(),
        0 if stats is None else stats.data_ptr(), 0 if btimes is None else btimes.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"oracle launch failed: CUDA error {err}")
    if stats is not None:
        return out
    trace_pass.launches += 1
    variant = (use_dda, use_tf, has_emi)
    trace_pass.launches_by_variant[variant] = trace_pass.launches_by_variant.get(variant, 0) + 1
    return out


def trace_pass(scene: SceneTables, params: TraceParams, cfg: TraceConfig,
               framebuffer: torch.Tensor, current_sample: int,
               capped: torch.Tensor | None = None) -> torch.Tensor:
    """One progressive pass over the (H, W, 4) float32 ``framebuffer``
    (sample ``current_sample``, 1-based): ``trace_passes`` of one pass."""
    return trace_passes(scene, params, cfg, framebuffer, current_sample, 1, capped=capped)


trace_pass.launches = 0
trace_pass.launches_by_variant = {}


def trace_passes(scene: SceneTables, params: TraceParams, cfg: TraceConfig,
                 framebuffer: torch.Tensor, first_sample: int, n_passes: int,
                 stats: dict | None = None, capped: torch.Tensor | None = None) -> torch.Tensor:
    """``n_passes`` progressive passes over the (H, W, 4) float32
    ``framebuffer``, samples ``first_sample`` (1-based) on, each folded into
    the running mean in turn; returns it as a new tensor. CUDA tensors
    launch the CUDA kernel's variant once for all the passes (and add one
    to ``trace_pass.launches`` and to
    ``trace_pass.launches_by_variant[(use_dda, use_tf, has_emi)]``); an
    int32 ``capped`` tensor of one element on the card gains the tracking
    loop calls that ``cfg.max_steps`` stopped. CPU tensors run the plain
    version, several passes' lanes at once (``tracer.trace_passes``), with
    ``stats`` counting its loop iterations and capped loop calls
    (``trace_stats`` counts the same on the card). The same framebuffer
    either way as ``n_passes`` calls of ``trace_pass``."""
    first_sample, n_passes = int(first_sample), int(n_passes)
    if first_sample < 1 or n_passes < 0:
        raise ValueError(f"passes {n_passes} from sample {first_sample}: samples are 1-based")
    if framebuffer.is_cuda:
        if stats is not None:
            raise ValueError("stats are counted by the plain version; trace_stats on the card")
        if n_passes == 0:
            return framebuffer.clone()
        return _launch_cuda(scene, params, cfg, framebuffer, first_sample, n_passes, capped)
    if framebuffer.device.type != "cpu":
        raise ValueError(f"unsupported device {framebuffer.device}")
    _variant(scene, cfg)
    h, w = int(framebuffer.shape[0]), int(framebuffer.shape[1])
    return _tracer.trace_passes(scene, params, cfg, framebuffer, first_sample, n_passes, w, h,
                                stats)


# the STATS instantiation's counters, in csrc/oracle.cu's order
STATS = ("paths", "bounce_iters", "sample_volume", "transmittance", "sample_volume_tests",
         "transmittance_tests", "emission", "capped", "bounce_issues", "track_issues", "groups")


def trace_stats(scene: SceneTables, params: TraceParams, cfg: TraceConfig,
                framebuffer: torch.Tensor, first_sample: int,
                n_passes: int) -> tuple[torch.Tensor, dict]:
    """``trace_passes`` of ``n_passes`` >= 1 through the kernel's STATS
    instantiation: the same framebuffer from one launch (never launched by
    a render path, not counted in ``trace_pass.launches``). Returns the
    framebuffer and the counters: what the plain version's ``stats``
    counts, under its names (``paths``, ``bounce_iters``, the tracking
    loops' ``*_iters`` and, with DDA, ``*_dda_tests``, ``emission``,
    ``capped``); ``simt_bounce`` and ``simt_track``, the lanes over 32 x
    the warp-level issues of the bounce loop's body and of a tracking-loop
    iteration; ``groups``, the groups the warps took (``paths`` over
    ``groups``: the items of a group); and from each block's (start, end)
    on the card's %globaltimer: ``blocks``, ``block_ms`` (min, median, max duration),
    ``span_ms`` (first start to last end) and ``tail_ms`` (from the moment
    a block's place on an SM goes idle for good -- the last block's start,
    or the first block's end if that is later -- to the last end)."""
    if int(n_passes) < 1:
        raise ValueError(f"trace_stats traces at least one pass, not {n_passes}")
    if not framebuffer.is_cuda:
        raise ValueError("trace_stats runs the CUDA kernel: the framebuffer must be on the card")
    dev = framebuffer.device
    h, w = int(framebuffer.shape[0]), int(framebuffer.shape[1])
    use_dda, use_tf, has_emi = _variant(scene, cfg)
    n_blocks = _lib().volren_oracle_blocks(w, h, int(n_passes), int(use_dda), int(use_tf),
                                           int(has_emi), 1)
    counters = torch.zeros(len(STATS), dtype=torch.int64, device=dev)
    btimes = torch.zeros(n_blocks, 2, dtype=torch.int64, device=dev)
    framebuffer = _launch_cuda(scene, params, cfg, framebuffer, int(first_sample), int(n_passes),
                               stats=counters, btimes=btimes)
    bt = btimes.cpu().numpy()
    bt = bt[bt[:, 1] > 0]            # blocks with a live warp
    dur = (bt[:, 1] - bt[:, 0]) / 1e6
    c = dict(zip(STATS, counters.tolist()))
    dda = "_dda" if cfg.use_dda else ""
    st = {"paths": c["paths"], "bounce_iters": c["bounce_iters"],
          f"sample_volume{dda}_iters": c["sample_volume"],
          f"transmittance{dda}_iters": c["transmittance"], "emission": c["emission"],
          "capped": c["capped"], "groups": c["groups"]}
    if cfg.use_dda:
        st["sample_volume_dda_tests"] = c["sample_volume_tests"]
        st["transmittance_dda_tests"] = c["transmittance_tests"]
    st["simt_bounce"] = c["bounce_iters"] / max(32 * c["bounce_issues"], 1)
    st["simt_track"] = (c["sample_volume"] + c["transmittance"]) / max(32 * c["track_issues"], 1)
    st.update(blocks=int(len(bt)),
              block_ms=(float(dur.min()), float(np.median(dur)), float(dur.max())),
              span_ms=float(bt[:, 1].max() - bt[:, 0].min()) / 1e6,
              tail_ms=float(bt[:, 1].max() - max(bt[:, 0].max(), bt[:, 1].min())) / 1e6)
    return framebuffer, st
