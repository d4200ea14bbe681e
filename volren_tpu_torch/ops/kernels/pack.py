"""The render kernel's inputs: one flat set of device tensors per scene,
the NEE sample pool, the per-dispatch parameter block, and the TF-baked
majorant table.

The counterpart of volren_tpu.ops.pallas.pack, without its TPU layout:
no (rows, 128) padding, no Morton slot order, no VMEM gate. Every table
stays in device memory as it is:

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

The packed tables, each optional, of the Pallas kernel's ``mip_u8``,
``env_rgbe`` and ``pool_rgbe`` modes (volren_tpu.renderer runs all three
by default):

  mip_u8   (M,) uint8         the baked majorant pyramid quantised up per
                              level (build_mip_u8), decoded lo + q * scale
                              with the per-level rows in ``mip_dq``, (2, 4)
                              float32 on the same device
  env_rgbe (H*W,) int32       the raw texels as shared-exponent words
                              (rgbe_encode)
  pool     (5 * POOL_N,) int32  POOL_N rows [wx, wy, wz, pdf] (float32
                              bits), then POOL_N RGBE words of the
                              radiance (build_env_pool(rgbe=True))

RGBE words are the bytes of volren_tpu.ops.pallas.pack.rgbe_encode, and
the u8 pyramid's bytes are its build_mip_u8 words' (little-endian).

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
# samples per pixel of one kernel dispatch (volren_tpu.renderer.Renderer.
# trace's fence); each dispatch draws its own NEE pool (build_env_pool)
DISPATCH_SPP = 64
# march substeps a sample may take before it ends with nothing added to its
# pixel: the iteration cap of a 1-spp dispatch of the Pallas kernel
# (kernel.py:2106, (2048 + 512 * spp) * 8 per strip), here per sample
STEP_BUDGET = (2048 + 512) * 8

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
PF_SIZE = 88

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
PI_MAX_ITERS = 28       # per-sample march-substep budget (STEP_BUDGET)
PI_TF_SIZE = 29         # LUT bins; 0 = no TF
PI_EMI_N_BRICKS = 30    # 3: emission grid bx, by, bz
PI_EMI_N_SLOTS = 33     # emission atlas slots; 0 = no emission
PI_ROW0 = 34            # the band of rows a dispatch traces: its first row
PI_ROWS = 35            # and its row count (0, height: the whole frame)
PI_MIP_U8 = 36          # 1: the march reads the u8 pyramid (KernelScene.mip_u8, mip_dq)
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
    # the packed tables (module docstring): the escape reads env_rgbe in
    # place of env when it is set (pack_scene(env_rgbe=True)); the march
    # reads mip_u8, decoded with mip_dq's (lo, scale) rows, (2, 4) float32
    # on the tables' device, in place of mip / mip_tf when it is set
    # (bake_mip_u8, per trace)
    env_rgbe: torch.Tensor | None = None
    mip_u8: torch.Tensor | None = None
    mip_dq: torch.Tensor | None = None


def pack_scene(grid: GridTables, env: EnvTables, tf: TFTables | None = None,
               emission: GridTables | None = None, env_rgbe: bool = False) -> KernelScene:
    """The kernel's tables for one frame. ``tf`` selects the TF variant
    (its majorant table is baked per trace: bake_tf_majorant); an
    ``emission`` grid selects the emission variant; ``env_rgbe`` adds the
    environment's RGBE table, the raw texels packed as
    volren_tpu.ops.pallas.pack.pack_scene packs them, which the escape then
    reads."""
    eh, ew = (int(v) for v in env.envmap.shape[:2])
    texels = env.envmap.reshape(eh * ew, 3).contiguous()
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
        env=texels,
        n_bricks=grid.n_bricks,
        mip_dims=grid.mip_dims,
        mip_offsets=grid.mip_offsets,
        env_hw=(eh, ew),
        inv_transform=grid.inv_transform,
        env_inv=env.inv_transform,
        env_strength=env.strength,
        imp_avg=env.imp_avg,
        tf=tf,
        env_rgbe=rgbe_encode(texels) if env_rgbe else None,
        **emi,
    )


# ---------------------------------------------------------------------------
# the packed tables: RGBE words and the u8 majorant pyramid, bitwise
# volren_tpu.ops.pallas.pack's as XLA computes them on the CPU
# ---------------------------------------------------------------------------

_F32 = np.float32
LN2_F32 = _F32(np.log(2.0))
INV_LN2_F32 = _F32(1.0) / LN2_F32      # jnp.log2's divisor, folded into a product


def _fma32(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32, a fused
    multiply-add. It runs in float64, where the product is exact; the sum's
    exact residual (two-sum) settles the one case a float64 sum rounds
    wrongly, a sum that lands halfway between two float32 values."""
    a, b, c = (t.double() for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    r = (p - (s - bv)) + (c - bv)
    f = s.float()
    g = torch.nextafter(f, torch.where(s > f.double(), float("inf"), float("-inf")))
    tie = (f.double() + g.double()) * 0.5 == s
    nudged = torch.where(r > 0, torch.maximum(f, g), torch.minimum(f, g))
    return torch.where(tie & (r != 0), nudged, f)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU, for positive normal x: the Cephes
    polynomial of xla/backends/cpu/codegen/polynomial_approximations.cc
    with its multiply-adds contracted to FMAs, as LLVM emits them there."""
    f32 = torch.float32

    def c(v):
        return torch.tensor(_F32(v), dtype=f32, device=x.device)

    one, half = c(1.0), c(0.5)
    t0 = torch.maximum(x.float(), c(np.int32(0x00800000).view(_F32)))
    bits = t0.view(torch.int32)
    emm0 = (bits >> 23) - 0x7F
    t0 = ((bits & ~0x7F800000) | 0x3F000000).view(f32)      # the mantissa in [0.5, 1)
    e = one + emm0.to(f32)
    small = t0 < c(0.707106781186547524)
    t1 = torch.where(small, t0, c(0.0))
    t0 = t0 - one
    e = e - torch.where(small, one, c(0.0))
    t0 = t0 + t1
    x2 = t0 * t0
    x3 = x2 * t0
    y = _fma32(t0, c(7.0376836292e-2), c(-1.1514610310e-1))
    y1 = _fma32(t0, c(-1.2420140846e-1), c(1.4249322787e-1))
    y2 = _fma32(t0, c(2.0000714765e-1), c(-2.4999993993e-1))
    y = _fma32(y, t0, c(1.1676998740e-1))
    y1 = _fma32(y1, t0, c(-1.6668057665e-1))
    y2 = _fma32(y2, t0, c(3.3333331174e-1))
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, c(-2.12194440e-4) * e)
    t0 = _fma32(-half, x2, t0)
    t0 = t0 + y
    return _fma32(c(0.693359375), e, t0)


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` on the CPU (the same file's Cephes polynomial,
    its multiply-adds contracted to FMAs)."""
    f32 = torch.float32

    def c(v):
        return torch.tensor(_F32(v), dtype=f32, device=x.device)

    x = torch.clamp(x.float(), -87.8, 88.8)
    n = torch.clamp(torch.floor(_fma32(x, c(1.44269504088896341), c(0.5))), -127.0, 127.0)
    x = _fma32(c(-0.693359375), n, x)
    x = _fma32(c(2.12194440e-4), n, x)
    z = _fma32(x, c(1.9875691500e-4), c(1.3981999507e-3))
    for p in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        z = _fma32(z, x, c(p))
    z = c(1.0) + _fma32(z, x * x, x)
    return z * ((n.to(torch.int32) + 127) << 23).view(f32)


def rgbe_encode(rgb: torch.Tensor) -> torch.Tensor:
    """(n, 3) float32 -> (n,) int32 RGBE words (rgbe_encode_plain) through
    megakernel.rgbe_encode: on a CUDA tensor one launch of the megakernel
    library's encode kernel, on a CPU tensor the plain version."""
    from .megakernel import rgbe_encode as encode_kernel   # it imports this module

    return encode_kernel(rgb)


def rgbe_encode_plain(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 -> (...,) int32 shared-exponent words: an 8-bit
    mantissa a channel and the max channel's exponent + 128 in the top
    byte, decoded as ``mantissa * 2^(top byte - 135)`` (rgbe_decode; 1/256
    relative on the max channel). Bitwise
    volren_tpu.ops.pallas.pack.rgbe_encode as XLA computes it on the CPU:
    ``jnp.log2`` is XLA's log times 1/ln 2 and ``jnp.exp2`` XLA's exp of
    x * ln 2 (_xla_log, _xla_exp), so an exponent taken next to a power of
    two, and a scale that is not a power of two, come out as there."""
    f32, i32 = torch.float32, torch.int32
    rgb = torch.clamp(rgb.to(f32), min=0.0)
    m = rgb.amax(dim=-1)
    log2 = _xla_log(torch.clamp(m, min=float(_F32(1e-37)))) * float(INV_LN2_F32)
    e = torch.clamp(torch.floor(log2).to(i32), -119, 119)
    scale = _xla_exp((7.0 - e.to(f32)) * float(LN2_F32))
    mi = torch.clamp(torch.round(rgb * scale[..., None]), max=255.0).to(torch.int64)
    word = mi[..., 0] | (mi[..., 1] << 8) | (mi[..., 2] << 16) | ((e.to(torch.int64) + 128) << 24)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(i32)
    return torch.where(m >= 2.0 ** -119, word, torch.zeros_like(word))


def rgbe_decode(word: torch.Tensor) -> torch.Tensor:
    """(...,) int32 RGBE words -> (..., 3) float32, volren_tpu's
    kernel._rgbe_decode: integer operations and the scale 2^(e - 135) built
    by placing e - 8 in a float32's exponent field. Exact; a word of 0
    decodes to -0.0."""
    w = word.to(torch.int32)
    e = (w >> 24) & 255
    scale = ((e - 8) * (1 << 23)).view(torch.float32)
    return torch.stack([(w & 255).to(torch.float32) * scale,
                        ((w >> 8) & 255).to(torch.float32) * scale,
                        ((w >> 16) & 255).to(torch.float32) * scale], dim=-1)


def mip_level_slices(mip_dims, mip_offsets) -> tuple:
    """Per-level (offset, count) of the flat majorant pyramid."""
    return tuple((int(off), int(np.prod(dims))) for dims, off in zip(mip_dims, mip_offsets))


def build_mip_u8(mip: torch.Tensor, mip_dims, mip_offsets):
    """Quantise the flat float32 majorant pyramid (fully baked: density_scale
    and any TF alpha applied) to one byte an entry, per level, ROUNDING UP:
    ``lo[m] + q * scale[m]`` is at least the true value, so every
    null-collision estimator stays unbiased (a looser majorant only adds
    null collisions), and an exact zero stays zero where the level's
    minimum is zero. Returns (q (M,) uint8, lo (4,) float32, scale (4,)
    float32), bitwise volren_tpu.ops.pallas.pack.build_mip_u8 on the CPU
    (its words are these bytes, little-endian): the scale is slightly
    inflated so that q = 255 reaches the maximum, and the safety bump
    compares ``lo + q * scale`` as XLA contracts it, one FMA."""
    f32 = torch.float32
    mip = mip.to(f32)
    q = torch.zeros(mip.shape[0], dtype=torch.uint8, device=mip.device)
    lo4, sc4 = [], []
    for off, n in mip_level_slices(mip_dims, mip_offsets):
        seg = mip[off:off + n]
        lo, hi = seg.min(), seg.max()
        sc = (hi - lo) * torch.tensor(_F32(1.0 / 254.99), dtype=f32, device=mip.device)
        qf = torch.where(sc > 0.0, torch.ceil((seg - lo) / torch.clamp(sc, min=float(_F32(1e-37)))),
                         torch.zeros_like(seg))
        qf = torch.clamp(qf, 0.0, 255.0)
        qf = torch.clamp(torch.where(_fma32(qf, sc, lo) < seg, qf + 1.0, qf), 0.0, 255.0)
        q[off:off + n] = qf.to(torch.uint8)
        lo4.append(lo)
        sc4.append(sc)
    return q, torch.stack(lo4), torch.stack(sc4)


def bake_mip_u8(ks: KernelScene, params: TraceParams) -> KernelScene:
    """``ks`` with the u8 majorant pyramid of this trace: build_mip_u8 of the
    TF-baked table (``ks.mip_tf``, bake_tf_majorant first) or, without a
    TF, of ``mip * density_scale``, as volren_tpu.renderer._render_pallas
    builds it; the march then reads it with no density_scale factor. On
    CUDA tables one launch of the megakernel library's build kernel
    (megakernel.build_mip_u8), which leaves the levels' (lo, scale) rows on
    the device: no host round trip."""
    from .megakernel import build_mip_u8 as build_kernel   # it imports this module

    if ks.tf is not None:
        if ks.mip_tf is None:
            raise ValueError("a TF scene's u8 pyramid is built from its baked table "
                             "(bake_tf_majorant first)")
        q, dq = build_kernel(ks.mip_tf, ks.mip_dims, ks.mip_offsets)
    else:
        q, dq = build_kernel(ks.mip, ks.mip_dims, ks.mip_offsets, scale=params.density_scale)
    return ks._replace(mip_u8=q, mip_dq=dq)


def bake_tf_majorant(ks: KernelScene, params: TraceParams) -> KernelScene:
    """``ks`` with ``mip_tf``: the raw majorant pyramid through the TF
    alpha, ``majorant * tf_alpha(density_scale * raw * inv_majorant)``, as
    volren_tpu.renderer._render_pallas bakes it. It depends on the trace's
    parameters, so it is baked once per trace; the kernel then reads it
    without a density_scale factor. On CUDA tables one launch of the
    megakernel library's bake kernel (megakernel.bake_tf_majorant), with
    no copy and no host sync; on CPU tables the plain version."""
    from .megakernel import bake_tf_majorant as bake_kernel   # it imports this module

    return ks._replace(mip_tf=bake_kernel(ks.mip, ks.tf, params))


def bake_tf_majorant_plain(mip: torch.Tensor, tf: TFTables, params) -> torch.Tensor:
    """The plain version of megakernel.bake_tf_majorant: the flat raw
    pyramid ``mip`` through ``tf``'s LUT alpha at ``params``'
    density_scale, inv_majorant and majorant, in torch ops on ``mip``'s
    device, in the operation order of volren_tpu.renderer._render_pallas.
    The window divides by a 0-d tensor, as the kernel divides (torch on a
    card turns a division by a Python float into a product with its
    reciprocal)."""
    f32 = torch.float32
    dev = mip.device

    def s(v):
        return torch.tensor(float(v), dtype=f32, device=dev)

    tf = tf._replace(window_left=s(tf.window_left), window_width=s(tf.window_width))
    d_norm = s(params.density_scale) * mip * s(params.inv_majorant)
    return (s(params.majorant) * tf_alpha_majorant(tf, d_norm)).contiguous()


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


def pool_uniforms(seed: int, spp_base: int, device) -> torch.Tensor:
    """The (POOL_N, 2) float32 uniforms of the NEE pool of (seed, spp_base)
    on ``device``: numpy's generator seeded exactly as
    volren_tpu.ops.pallas.pack.build_env_pool seeds it, so both packages
    draw the same pool. For a CUDA device they are drawn into a fresh
    pinned host buffer and copied with ``non_blocking``: no host sync (the
    caching host allocator keeps the buffer until its copy has run)."""
    rng = np.random.default_rng((int(seed) * 2654435761 + int(spp_base)) % 2**63)
    cuda = torch.device(device).type == "cuda"
    host = torch.empty(POOL_N, 2, dtype=torch.float32, pin_memory=cuda)
    rng.random(dtype=np.float32, out=host.numpy())
    return host.to(device, non_blocking=cuda)


def env_pool_plain(env: EnvTables, u2: torch.Tensor, rgbe: bool = False) -> torch.Tensor:
    """The plain version of megakernel.env_pool: the alias-table samples of
    the (n, 2) uniforms ``u2`` as the (n, 8) float32 pool [w, pdf,
    strength * texel radiance, 0], or with ``rgbe`` as the packed (5 n,)
    int32 pool (pack_pool_rgbe_plain), in torch ops on ``u2``'s device."""
    _ux, _uy, pdf, w_i, le_texel = sample_environment_alias(env, u2)
    le = env.strength * le_texel
    pool = torch.cat([w_i, pdf[:, None], le, torch.zeros_like(pdf)[:, None]], dim=1).contiguous()
    return pack_pool_rgbe_plain(pool) if rgbe else pool


def build_env_pool(env: EnvTables, seed: int, spp_base: int, rgbe: bool = False) -> torch.Tensor:
    """POOL_N alias-table environment samples as a (POOL_N, 8) float32
    table or, with ``rgbe``, as the packed (5 * POOL_N,) int32 table (the
    module docstring): the radiance as one word a sample,
    ``rgbe_encode(strength * texel)``, as volren_tpu's pool packs it
    (``"lergbe"``). The uniforms are pool_uniforms(seed, spp_base), the
    JAX package's; on CUDA tables one launch of the megakernel library's
    draw kernel writes either layout (megakernel.env_pool), with no host
    sync; on CPU tables the plain version."""
    from .megakernel import env_pool   # it imports this module

    return env_pool(env, pool_uniforms(seed, spp_base, env.alias_packed.device), rgbe)


def pack_pool_rgbe(pool: torch.Tensor) -> torch.Tensor:
    """A (POOL_N, 8) float32 pool as the packed (5 * POOL_N,) int32 one:
    its [wx, wy, wz, pdf] rows as they are, then rgbe_encode of its
    radiance columns. On a CUDA pool one launch of the encode kernel writes
    both (megakernel.pack_pool_rgbe); build_env_pool(rgbe=True) draws a
    packed pool directly."""
    if pool.is_cuda:
        from .megakernel import pack_pool_rgbe as pack_kernel   # it imports this module

        return pack_kernel(pool)
    return pack_pool_rgbe_plain(pool)


def pack_pool_rgbe_plain(pool: torch.Tensor) -> torch.Tensor:
    """pack_pool_rgbe in torch ops on the pool's device."""
    rows = pool[:, :4].contiguous().view(torch.int32).reshape(-1)
    return torch.cat([rows, rgbe_encode_plain(pool[:, 4:7])]).contiguous()


def build_params(ks: KernelScene, params: TraceParams, width: int, height: int,
                 spp_base: int, spp: int, row0: int = 0, rows: int | None = None):
    """(pf, pi) host arrays for one dispatch of ``spp`` samples per pixel
    of a ``width`` x ``height`` frame, over its ``rows`` rows from ``row0``
    (all of them by default)."""
    rows = height - row0 if rows is None else rows
    if row0 < 0 or rows < 0 or row0 + rows > height:
        raise ValueError(f"rows [{row0}, {row0 + rows}) are not rows of a {height}-row frame")
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
    pi[PI_MAX_ITERS] = STEP_BUDGET
    pi[PI_ROW0], pi[PI_ROWS] = row0, rows
    if ks.tf is not None:
        pi[PI_TF_SIZE] = ks.tf.lut.shape[0]
    if ks.emi_atlas is not None:
        pi[PI_EMI_N_BRICKS:PI_EMI_N_BRICKS + 3] = ks.emi_n_bricks
        pi[PI_EMI_N_SLOTS] = ks.emi_atlas.shape[0]
    pi[PI_MIP_U8] = ks.mip_u8 is not None
    return pf, pi
