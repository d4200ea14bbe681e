"""The render kernel's inputs: one flat set of device tensors per scene,
the NEE sample pool, the per-dispatch parameter block, and the TF-baked
majorant table.

The counterpart of volren_tpu.ops.pallas.pack, without its TPU layout:
no (rows, 128) padding, no Morton slot order, no RGBE or u8 packing, no
VMEM gate. Every table stays in device memory as it is:

  atlas  (S, 512) uint8       8^3 voxels per brick slot, (z, y, x) order
  slot   (B,) int32           atlas slot per brick, z-major brick index
  lo, hi (B,) float32         per-brick decode range
  mip    (M,) float32         4-level majorant pyramid, flat
  env    (H*W, 3) float32     equirect radiance, rows in v-order
  pool   (POOL_N, 8) float32  NEE samples [wx, wy, wz, pdf, ler, leg, leb, 0]

and, for the kernel's two variants,

  tf.lut   (S, 4) float32     transfer-function LUT (TF scenes)
  mip_tf   (M,) float32       the majorant pyramid through the TF alpha,
                              baked per trace (bake_tf_majorant)
  emi_*    atlas/slot/lo/hi   the emission brick grid (emission scenes)

The parameter block is two host arrays: ``pf`` (PF_SIZE,) float32 and
``pi`` (PI_SIZE,) int32, indexed by the PF_* / PI_* constants below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..envmap import sample_environment_alias
from ..scene import EnvTables, GridTables, TFTables, TraceParams
from ..transfer import tf_alpha_majorant

# NEE environment sample pool size (volren_tpu.ops.pallas.pack.POOL_N)
POOL_N = 16384

# pf (PF_SIZE,) float32 slots
PF_CAM_POS = 0          # 3
PF_CAM_XFORM = 3        # 9 row-major (3, 3) view -> world
PF_ZCAM = 12            # -0.5 / tan(fov / 2)
PF_BB_MIN = 13          # 3
PF_BB_MAX = 16          # 3
PF_MAJORANT = 19
PF_INV_MAJORANT = 20
PF_ALBEDO = 21          # 3
PF_PHASE_G = 24
PF_DENSITY_SCALE = 25
PF_INV_XFORM = 26       # 16 row-major (4, 4) world -> index
PF_ENV_INV = 42         # 9 row-major (3, 3)
PF_ENV_STRENGTH = 51
PF_IMP_AVG = 52
PF_SHOW_ENV = 53        # 0.0 / 1.0
PF_TF_LEFT = 54         # TF density window (transferfunc.cpp:79-93)
PF_TF_WIDTH = 55
PF_EMI_SCALE = 56       # emission_scale (common.glsl:324-328)
PF_EMI_NORM = 57        # 1 / emission majorant
PF_EMI_X = 58           # 16 row-major (4, 4): density index -> emission index
PF_SIZE = 80

# pi (PI_SIZE,) int32 slots
PI_WIDTH = 0
PI_HEIGHT = 1
PI_SPP_BASE = 2
PI_BOUNCES = 3
PI_SEED = 4             # uint32 bit pattern
PI_SPP = 5
PI_N_BRICKS = 6         # 3: bx, by, bz
PI_N_SLOTS = 9
PI_ENV_H = 10
PI_ENV_W = 11
PI_MIP_DIMS = 12        # 12: (z, y, x) per level 0..3
PI_MIP_OFFSETS = 24     # 4
PI_MAX_ITERS = 28       # per-pixel step cap
PI_TF_SIZE = 29         # LUT bins; 0 = no TF
PI_EMI_N_BRICKS = 30    # 3: emission grid bx, by, bz
PI_EMI_N_SLOTS = 33     # emission atlas slots; 0 = no emission
PI_SIZE = 40


class KernelScene(NamedTuple):
    """The kernel's device tables plus the static values the parameter
    block needs (see the module docstring)."""

    atlas: torch.Tensor
    slot: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    mip: torch.Tensor
    env: torch.Tensor
    n_bricks: tuple
    mip_dims: tuple
    mip_offsets: tuple
    env_hw: tuple
    inv_transform: np.ndarray    # (4, 4) world -> index
    env_inv: np.ndarray          # (3, 3)
    env_strength: float
    imp_avg: float
    # the TF variant: the LUT and window, and the majorant pyramid baked
    # through the TF alpha (per trace, bake_tf_majorant)
    tf: TFTables | None = None
    mip_tf: torch.Tensor | None = None
    # the emission variant: the emission brick grid's tables, its brick
    # counts, and density index -> emission index, (4, 4) float32
    emi_atlas: torch.Tensor | None = None
    emi_slot: torch.Tensor | None = None
    emi_lo: torch.Tensor | None = None
    emi_hi: torch.Tensor | None = None
    emi_n_bricks: tuple = (0, 0, 0)
    emi_x: np.ndarray | None = None


def pack_scene(grid: GridTables, env: EnvTables, tf: TFTables | None = None,
               emission: GridTables | None = None) -> KernelScene:
    """The kernel's tables for one frame. ``tf`` selects the TF variant
    (its majorant table is baked per trace: bake_tf_majorant); an
    ``emission`` grid selects the emission variant."""
    eh, ew = (int(v) for v in env.envmap.shape[:2])
    emi = {}
    if emission is not None:
        emi = dict(
            emi_atlas=emission.atlas.contiguous(),
            emi_slot=emission.slot.contiguous(),
            emi_lo=emission.lo.contiguous(),
            emi_hi=emission.hi.contiguous(),
            emi_n_bricks=emission.n_bricks,
            # one (4, 4): density index -> world -> emission index
            # (volren_tpu.ops.pallas.pack.build_params_rows)
            emi_x=(np.asarray(emission.inv_transform, np.float32)
                   @ np.asarray(grid.transform, np.float32)),
        )
    return KernelScene(
        atlas=grid.atlas.contiguous(),
        slot=grid.slot.contiguous(),
        lo=grid.lo.contiguous(),
        hi=grid.hi.contiguous(),
        mip=grid.mip_maj.contiguous(),
        env=env.envmap.reshape(eh * ew, 3).contiguous(),
        n_bricks=grid.n_bricks,
        mip_dims=grid.mip_dims,
        mip_offsets=grid.mip_offsets,
        env_hw=(eh, ew),
        inv_transform=grid.inv_transform,
        env_inv=env.inv_transform,
        env_strength=env.strength,
        imp_avg=env.imp_avg,
        tf=tf,
        **emi,
    )


def bake_tf_majorant(ks: KernelScene, params: TraceParams) -> KernelScene:
    """``ks`` with ``mip_tf``: the raw majorant pyramid through the TF
    alpha, ``majorant * tf_alpha(density_scale * raw * inv_majorant)``, in
    the operation order of volren_tpu.renderer._render_pallas. It depends
    on the trace's parameters, so it is baked once per trace; the kernel
    then reads it without a density_scale factor."""
    f32 = torch.float32
    dev = ks.mip.device

    def s(v):
        return torch.tensor(float(v), dtype=f32, device=dev)

    d_norm = s(params.density_scale) * ks.mip * s(params.inv_majorant)
    return ks._replace(mip_tf=(s(params.majorant) * tf_alpha_majorant(ks.tf, d_norm)).contiguous())


def decode_dense(ks: KernelScene) -> torch.Tensor:
    """The whole brick grid decoded to a flat (Z*Y*X,) float32 voxel table,
    (z, y, x) order: lo + (u8 * (1/255)) * (hi - lo) per voxel, with the
    multiply-add fused as XLA fuses it in volren_tpu's dense decode."""
    bx, by, bz = ks.n_bricks
    unorm = ks.atlas.to(torch.float32) * (1.0 / 255.0)
    slots = ks.slot.long()
    vals = torch.addcmul(ks.lo[:, None], unorm[slots], (ks.hi - ks.lo)[:, None])
    vals = vals.reshape(bz, by, bx, 8, 8, 8).permute(0, 3, 1, 4, 2, 5)
    return vals.reshape(-1)


def build_env_pool(env: EnvTables, seed: int, spp_base: int) -> torch.Tensor:
    """POOL_N alias-table environment samples as a (POOL_N, 8) float32
    table. The uniforms come from numpy's generator seeded exactly as
    volren_tpu.ops.pallas.pack.build_env_pool seeds it, so both packages
    draw the same pool for the same (seed, spp_base)."""
    rng = np.random.default_rng((int(seed) * 2654435761 + int(spp_base)) % 2**63)
    device = env.envmap.device
    u2 = torch.as_tensor(rng.random((POOL_N, 2), np.float32), device=device)
    _ux, _uy, pdf, w_i, le_texel = sample_environment_alias(env, u2)
    le = env.strength * le_texel
    return torch.cat([w_i, pdf[:, None], le, torch.zeros_like(pdf)[:, None]], dim=1).contiguous()


def build_params(ks: KernelScene, params: TraceParams, width: int, height: int,
                 spp_base: int, spp: int):
    """(pf, pi) host arrays for one dispatch of ``spp`` samples per pixel."""
    f32 = np.float32
    pf = np.zeros(PF_SIZE, f32)
    pf[PF_CAM_POS:PF_CAM_POS + 3] = params.cam_pos
    pf[PF_CAM_XFORM:PF_CAM_XFORM + 9] = np.asarray(params.cam_transform, f32).reshape(-1)
    pf[PF_ZCAM] = f32(-0.5) / np.tan(f32(0.5 * np.pi) * f32(params.cam_fov) / f32(180.0))
    pf[PF_BB_MIN:PF_BB_MIN + 3] = params.bb_min
    pf[PF_BB_MAX:PF_BB_MAX + 3] = params.bb_max
    pf[PF_MAJORANT] = params.majorant
    pf[PF_INV_MAJORANT] = params.inv_majorant
    pf[PF_ALBEDO:PF_ALBEDO + 3] = params.albedo
    pf[PF_PHASE_G] = params.phase_g
    pf[PF_DENSITY_SCALE] = params.density_scale
    pf[PF_INV_XFORM:PF_INV_XFORM + 16] = np.asarray(ks.inv_transform, f32).reshape(-1)
    pf[PF_ENV_INV:PF_ENV_INV + 9] = np.asarray(ks.env_inv, f32).reshape(-1)
    pf[PF_ENV_STRENGTH] = ks.env_strength
    pf[PF_IMP_AVG] = ks.imp_avg
    pf[PF_SHOW_ENV] = 1.0 if params.show_environment else 0.0
    if ks.tf is not None:
        pf[PF_TF_LEFT] = ks.tf.window_left
        pf[PF_TF_WIDTH] = ks.tf.window_width
    if ks.emi_atlas is not None:
        pf[PF_EMI_SCALE] = params.emission_scale
        pf[PF_EMI_NORM] = params.emission_norm
        pf[PF_EMI_X:PF_EMI_X + 16] = np.asarray(ks.emi_x, f32).reshape(-1)

    pi = np.zeros(PI_SIZE, np.int32)
    pi[PI_WIDTH] = width
    pi[PI_HEIGHT] = height
    pi[PI_SPP_BASE] = spp_base
    pi[PI_BOUNCES] = params.bounces
    pi[PI_SEED] = np.array(params.seed, np.uint32).view(np.int32)
    pi[PI_SPP] = spp
    pi[PI_N_BRICKS:PI_N_BRICKS + 3] = ks.n_bricks
    pi[PI_N_SLOTS] = ks.atlas.shape[0]
    pi[PI_ENV_H], pi[PI_ENV_W] = ks.env_hw
    pi[PI_MIP_DIMS:PI_MIP_DIMS + 12] = np.asarray(ks.mip_dims).reshape(-1)
    pi[PI_MIP_OFFSETS:PI_MIP_OFFSETS + 4] = ks.mip_offsets
    # the Pallas kernel's iteration cap (kernel._render_strips_jit), per pixel
    pi[PI_MAX_ITERS] = (2048 + 512 * spp) * 8
    if ks.tf is not None:
        pi[PI_TF_SIZE] = ks.tf.lut.shape[0]
    if ks.emi_atlas is not None:
        pi[PI_EMI_N_BRICKS:PI_EMI_N_BRICKS + 3] = ks.emi_n_bricks
        pi[PI_EMI_N_SLOTS] = ks.emi_atlas.shape[0]
    return pf, pi
