"""Scene upload: host grids and environments -> device tensors.

The counterpart of volren_tpu.ops.scene. A brick grid becomes flat
per-brick tables (atlas slot, range min, range max) beside the u8 atlas and
the flat majorant pyramid; an environment becomes its RGB texture and the
alias table that samples its importance map; a transfer function becomes
its (S, 4) LUT and density window. ``SceneTables`` and ``TraceConfig``
are the oracle engine's scene and switches (volren_tpu.ops.scene's
``SceneDevice`` and ``TraceConfig``). The TPU-only tables of the JAX package
(one-hot majorants and the bf16 alpha pair table, pre-decoded dense grids,
quad rows) have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import spans


class GridTables(NamedTuple):
    """One brick grid on the device."""

    atlas: torch.Tensor          # (S, 512) uint8, voxel order (z, y, x) in a brick
    slot: torch.Tensor           # (bz*by*bx,) int32 atlas slot per brick, z-major
    lo: torch.Tensor             # (bz*by*bx,) float32 range min per brick
    hi: torch.Tensor             # (bz*by*bx,) float32 range max per brick
    mip_maj: torch.Tensor        # (M,) float32 majorant pyramid, levels 0..3 flat
    transform: np.ndarray        # (4, 4) float32 index -> world
    inv_transform: np.ndarray    # (4, 4) float32 world -> index
    n_bricks: tuple              # (bx, by, bz)
    mip_dims: tuple              # ((z, y, x),) * 4, level 0 = bricks
    mip_offsets: tuple           # (4,) flat offset of each level


class EnvTables(NamedTuple):
    """An environment map on the device."""

    envmap: torch.Tensor         # (H, W, 3) float32, rows in v-order
    alias_packed: torch.Tensor   # (D*D, 10) float32 alias rows (see upload_environment)
    imp_avg: float               # mean importance (the 1x1 top mip)
    transform: np.ndarray        # (3, 3) float32
    inv_transform: np.ndarray    # (3, 3) float32
    strength: float
    # the luminance importance pyramid that the oracle engine's
    # hierarchical warp walks: GL mip m is imp_mips[m], (512 >> m)^2
    # float32 rows in v-order, 512^2 down to 1^2; views into one flat
    # tensor, level after level (``imp_pyramid``)
    imp_mips: tuple = ()


class TFTables(NamedTuple):
    """A transfer function on the device."""

    lut: torch.Tensor            # (S, 4) float32 RGBA, alpha CDF-rewritten if needed
    window_left: float           # float32 values
    window_width: float


class SceneTables(NamedTuple):
    """The oracle engine's scene (volren_tpu.ops.scene.SceneDevice)."""

    density: GridTables
    emission: GridTables | None
    env: EnvTables
    tf: TFTables | None


class TraceConfig(NamedTuple):
    """The oracle engine's compile-time switches (volren_tpu.ops.scene.
    TraceConfig without its TPU-only ``use_onehot`` and
    ``env_nearest_nee``, both off where the JAX oracle runs on the CPU):
    DDA or global-majorant tracking, the TF, the emission grid, and the
    per-call iteration cap of every tracking loop."""

    use_dda: bool = True
    use_tf: bool = False
    has_emission: bool = False
    max_steps: int = 8192


class TraceParams(NamedTuple):
    """Per-dispatch scalars (uniforms of reference src/renderer.cpp:90-138),
    as numpy values; the field names follow volren_tpu.ops.scene.TraceParams."""

    cam_pos: np.ndarray          # (3,)
    cam_transform: np.ndarray    # (3, 3) view -> world rotation
    cam_fov: float               # degrees
    bb_min: np.ndarray           # (3,) world, clip planes applied
    bb_max: np.ndarray           # (3,)
    majorant: float              # global majorant * density_scale
    inv_majorant: float
    albedo: np.ndarray           # (3,)
    phase_g: float
    density_scale: float
    bounces: int
    show_environment: int
    seed: int                    # uint32
    emission_scale: float = 0.0  # emission grid scale (common.glsl:324-328)
    emission_norm: float = 1.0   # 1 / emission majorant


def mip_layout(n_bricks):
    """Per-level (z, y, x) dims (ceil-halving from the brick grid) and flat
    offsets of the 4-level majorant pyramid."""
    bx, by, bz = n_bricks
    dims = [(bz, by, bx)]
    for _ in range(3):
        z, y, x = dims[-1]
        dims.append((max(1, -(-z // 2)), max(1, -(-y // 2)), max(1, -(-x // 2))))
    offs = [0]
    for z, y, x in dims[:-1]:
        offs.append(offs[-1] + z * y * x)
    return tuple(dims), tuple(offs)


def upload_grid(brick_grid, volume_transform: np.ndarray, device) -> GridTables:
    """BrickGrid (host) -> GridTables on ``device``. ``volume_transform`` is
    the Volume's world transform, composed on top of the grid transform
    (reference src/renderer.cpp:112-113)."""
    t = np.asarray(volume_transform, np.float64) @ np.asarray(brick_grid.transform, np.float64)
    inv = np.linalg.inv(t)
    mips = brick_grid.range_mips
    dims, offs = mip_layout(brick_grid.n_bricks)
    if len(mips) < 3 or any(m.shape[:3] != d for m, d in zip(mips, dims[1:])):
        from ..voldata.brick import build_range_mips

        mips = build_range_mips(brick_grid.range)
    levels = [brick_grid.range[..., 1]] + [m[..., 1] for m in mips[:3]]
    mip_maj = np.concatenate([m.reshape(-1) for m in levels]).astype(np.float32)
    atlas = brick_grid.atlas.reshape(brick_grid.atlas.shape[0], 512)
    return GridTables(
        atlas=torch.as_tensor(np.ascontiguousarray(atlas), device=device),
        slot=torch.as_tensor(brick_grid.indirection.reshape(-1).astype(np.int32), device=device),
        lo=torch.as_tensor(np.ascontiguousarray(brick_grid.range[..., 0].reshape(-1)), device=device),
        hi=torch.as_tensor(np.ascontiguousarray(brick_grid.range[..., 1].reshape(-1)), device=device),
        mip_maj=torch.as_tensor(mip_maj, device=device),
        transform=t.astype(np.float32),
        inv_transform=inv.astype(np.float32),
        n_bricks=tuple(int(v) for v in brick_grid.n_bricks),
        mip_dims=dims,
        mip_offsets=offs,
    )


def imp_pyramid(levels, device) -> tuple:
    """The importance pyramid as views into one flat float32 tensor,
    level after level (the layout csrc/oracle.cu reads)."""
    levels = [np.asarray(m, np.float32) for m in levels]
    flat = torch.as_tensor(np.concatenate([m.reshape(-1) for m in levels]), device=device)
    out, off = [], 0
    for m in levels:
        out.append(flat[off:off + m.size].view(*m.shape))
        off += m.size
    return tuple(out)


def build_alias_table(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias method over flat nonnegative weights."""
    w = np.asarray(weights, np.float64).reshape(-1)
    n = w.size
    total = w.sum()
    if total <= 0.0:
        return np.ones(n, np.float32), np.arange(n, dtype=np.int32)
    p = w * (n / total)
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def upload_environment(env, device) -> EnvTables:
    """Environment (host) -> EnvTables on ``device``. Alias rows are
    [keep_prob, alias_idx, own_pdf, alias_pdf, own_rgb(3), alias_rgb(3)]:
    pdf = w / avg / 4pi (the solid-angle convention of common.glsl:143-145)
    and the rgb is each importance texel's box-filtered radiance."""
    with spans.span("volren_tpu_torch.alias"):
        prob, alias = build_alias_table(env.impmap_mips[0])
        w = np.asarray(env.impmap_mips[0], np.float32).reshape(-1)
        avg = float(env.impmap_mips[-1].reshape(()))
        pdf = w / max(avg, 1e-20) * (1.0 / (4.0 * np.pi))
        dim = int(np.asarray(env.impmap_mips[0]).shape[0])
        emap = np.asarray(env.envmap, np.float32)
        eh, ew = emap.shape[:2]
        fy, fx = eh // dim or 1, ew // dim or 1
        ph, pw = dim * fy - eh, dim * fx - ew
        if ph or pw:  # envmap smaller than the importance map: edge-pad
            emap = np.pad(emap, ((0, max(0, ph)), (0, max(0, pw)), (0, 0)), mode="edge")
        texel_rgb = (emap[: dim * fy, : dim * fx].reshape(dim, fy, dim, fx, 3)
                     .mean(axis=(1, 3)).reshape(dim * dim, 3))
        packed = np.concatenate(
            [np.stack([prob, alias.astype(np.float32), pdf, pdf[alias]], axis=-1),
             texel_rgb, texel_rgb[alias]], axis=-1).astype(np.float32)
        transform = np.asarray(env.transform, np.float32)
        return EnvTables(
            envmap=torch.as_tensor(np.array(env.envmap[..., :3], np.float32), device=device),
            alias_packed=torch.as_tensor(packed, device=device),
            imp_avg=avg,
            transform=transform,
            inv_transform=np.linalg.inv(transform.astype(np.float64)).astype(np.float32),
            strength=float(np.float32(env.strength)),
            imp_mips=imp_pyramid(env.impmap_mips, device),
        )


def upload_transferfunc(tf, device) -> TFTables:
    """TransferFunction (host) -> TFTables on ``device``: the LUT as the
    kernel reads it (``device_lut``, alpha CDF-rewritten iff not monotone)
    and the density window."""
    return TFTables(
        lut=torch.as_tensor(np.ascontiguousarray(tf.device_lut(), np.float32), device=device),
        window_left=float(np.float32(tf.window_left)),
        window_width=float(np.float32(tf.window_width)),
    )


class Reference(NamedTuple):
    """The JAX package's inputs in the port's form (``from_reference``)."""

    grid: GridTables
    env: EnvTables
    pool: torch.Tensor | None
    params: TraceParams | None
    tf: TFTables | None
    emission: GridTables | None
    mip_tf: torch.Tensor | None


def _grid_from_reference(atlas, brick_meta, mip_maj, transform, inv_transform, device):
    meta = np.asarray(brick_meta, np.float32)
    bz, by, bx = meta.shape[:3]
    dims, offs = mip_layout((bx, by, bz))
    return GridTables(
        atlas=torch.as_tensor(np.array(atlas, np.uint8).reshape(-1, 512), device=device),
        slot=torch.as_tensor(meta[..., 0].reshape(-1).astype(np.int32), device=device),
        lo=torch.as_tensor(np.array(meta[..., 1].reshape(-1)), device=device),
        hi=torch.as_tensor(np.array(meta[..., 2].reshape(-1)), device=device),
        mip_maj=torch.as_tensor(np.array(mip_maj, np.float32).reshape(-1), device=device),
        transform=np.asarray(transform, np.float32),
        inv_transform=np.asarray(inv_transform, np.float32),
        n_bricks=(bx, by, bz),
        mip_dims=dims,
        mip_offsets=offs,
    )


def from_reference(*, atlas, brick_meta, mip_maj, transform, inv_transform,
                   envmap, alias_packed, imp_avg, env_transform,
                   env_inv_transform, env_strength, pool=None, params=None,
                   tf_lut=None, tf_window=(0.0, 1.0), emission=None,
                   mip_tf=None, imp_mips=(), device="cpu") -> Reference:
    """The JAX package's scene, NEE pool and trace parameters, as numpy
    arrays, -> the port's ``Reference`` tables.

    ``atlas`` (S, 512) u8, ``brick_meta`` (bz, by, bx, 3) [slot, min, max],
    ``mip_maj`` flat and the (4, 4) transforms come from
    ``volren_tpu.ops.scene.GridDevice``; ``envmap`` (H, W, 3|4),
    ``alias_packed``, ``imp_avg`` and the (3, 3) transforms from its
    ``EnvDevice``; ``pool`` is the dict of ``pack.build_env_pool``;
    ``params`` maps the ``TraceParams`` field names (the emission ones
    included) to arrays. ``tf_lut`` (S, 4) and ``tf_window`` (left,
    width) come from its ``TFDevice``; ``emission`` is a dict with the
    emission ``GridDevice``'s ``atlas``, ``brick_meta``, ``mip_maj``,
    ``transform`` and ``inv_transform``; ``mip_tf`` is a pre-baked TF
    majorant table (``renderer._render_pallas``'s ``mip_override``),
    flat, cut to the pyramid's length; ``imp_mips`` is the
    ``EnvDevice``'s importance pyramid (GL mip order, 512^2 first). Tests
    feed both packages the same tables through this."""
    grid = _grid_from_reference(atlas, brick_meta, mip_maj, transform, inv_transform, device)
    env = EnvTables(
        envmap=torch.as_tensor(np.array(np.asarray(envmap)[..., :3], np.float32), device=device),
        alias_packed=torch.as_tensor(np.array(alias_packed, np.float32), device=device),
        imp_avg=float(np.asarray(imp_avg, np.float32).reshape(())),
        transform=np.asarray(env_transform, np.float32),
        inv_transform=np.asarray(env_inv_transform, np.float32),
        strength=float(np.asarray(env_strength, np.float32)),
        imp_mips=imp_pyramid(imp_mips, device) if len(imp_mips) else (),
    )
    pool_t = None
    if pool is not None:
        keys = ("wx", "wy", "wz", "pdf", "ler", "leg", "leb")
        cols = [np.asarray(pool[k], np.float32).reshape(-1) for k in keys]
        cols.append(np.zeros_like(cols[0]))
        pool_t = torch.as_tensor(np.stack(cols, axis=-1), device=device)
    tp = None
    if params is not None:
        f = lambda k: float(np.asarray(params[k], np.float32))  # noqa: E731
        v = lambda k: np.asarray(params[k], np.float32)  # noqa: E731
        tp = TraceParams(
            cam_pos=v("cam_pos").reshape(3),
            cam_transform=v("cam_transform").reshape(3, 3),
            cam_fov=f("cam_fov"),
            bb_min=v("bb_min").reshape(3),
            bb_max=v("bb_max").reshape(3),
            majorant=f("majorant"),
            inv_majorant=f("inv_majorant"),
            albedo=v("albedo").reshape(3),
            phase_g=f("phase_g"),
            density_scale=f("density_scale"),
            bounces=int(np.asarray(params["bounces"])),
            show_environment=int(np.asarray(params["show_environment"])),
            seed=int(np.asarray(params["seed"]).astype(np.uint32)),
            emission_scale=f("emission_scale") if "emission_scale" in params else 0.0,
            emission_norm=f("emission_norm") if "emission_norm" in params else 1.0,
        )
    tf = None
    if tf_lut is not None:
        tf = TFTables(lut=torch.as_tensor(np.array(tf_lut, np.float32), device=device),
                      window_left=float(np.asarray(tf_window[0], np.float32)),
                      window_width=float(np.asarray(tf_window[1], np.float32)))
    egrid = None
    if emission is not None:
        egrid = _grid_from_reference(device=device, **emission)
    mip = None
    if mip_tf is not None:
        n = grid.mip_maj.shape[0]
        mip = torch.as_tensor(np.array(mip_tf, np.float32).reshape(-1)[:n], device=device)
    return Reference(grid, env, pool_t, tp, tf, egrid, mip)
