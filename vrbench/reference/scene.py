"""The reference's scene: the render kernel's tables and parameter block,
worked out again from the benchmark's inputs (the ``.brick`` file, the sky
and the temperature grid as arrays, the settings, the camera).

A frozen copy of what the program derives from the same inputs, in the
same float32 and float64 operation order: the ``.brick`` reader and the
brick encoder (``voldata/brick_io.py``, ``voldata/brick.py``), the fit
into the unit cube (``Renderer.scale_and_move_to_unit_cube``), the grid
and sky upload (``ops/scene.py``), the importance pyramid
(``scene/environment.py``), the camera (``scene/camera.py``), the trace
parameters (``Renderer._trace_params``) and the parameter block
(``ops/kernels/pack.py`` ``build_params``). Numpy and torch only; it
imports nothing of the program.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

# the parameter block's slots (pack.py), the ones this reference reads
PF_CAM_POS, PF_CAM_XFORM, PF_ZCAM, PF_BB_MIN, PF_BB_MAX = 0, 3, 12, 13, 16
PF_MAJORANT, PF_INV_MAJORANT, PF_ALBEDO, PF_PHASE_G, PF_DENSITY_SCALE = 19, 20, 21, 24, 25
PF_INV_XFORM, PF_ENV_INV, PF_ENV_STRENGTH, PF_IMP_AVG, PF_SHOW_ENV = 26, 42, 51, 52, 53
PF_EMI_SCALE, PF_EMI_NORM, PF_EMI_X, PF_SIZE = 56, 57, 58, 88
# march substeps a sample may take before it ends with nothing added
STEP_BUDGET = (2048 + 512) * 8
# NEE pool rows a dispatch draws, and samples a dispatch traces at most
POOL_N = 16384
DISPATCH_SPP = 64
# importance map resolution and supersamples a texel per axis
IMP_DIMENSION, IMP_SAMPLES = 512, 8
_LUMA = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

class Brick(NamedTuple):
    indirection: np.ndarray      # (bz, by, bx) uint32 flat slot ids
    range: np.ndarray            # (bz, by, bx, 2) float32 (min, max)
    atlas: np.ndarray            # (n_slots, 8, 8, 8) uint8
    transform: np.ndarray        # (4, 4) float32 index -> world
    voxel_extent: np.ndarray     # (x, y, z)
    range_mips: list


def _buf_header(data, off):
    sx, sy, sz = struct.unpack_from("<3I", data, off)
    (n,) = struct.unpack_from("<Q", data, off + 12)
    return (sx, sy, sz), n, off + 20


def read_brick(path: str) -> Brick:
    """A ``.brick`` file (tag 1, transform, brick counts, 10-10-10-2
    indirection, f16 ranges, 3-D atlas, f16 range mips) as a Brick."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    if data[0] != 1:
        raise ValueError(f"{path}: not a brick grid")
    transform = np.frombuffer(data, np.float32, 16, 1).reshape(4, 4).T.copy()
    off = 65
    nb = struct.unpack_from("<3I", data, off)
    off += 28
    (sx, sy, sz), n, off = _buf_header(data, off)
    if (sx, sy, sz) != nb:
        raise ValueError(f"{path}: indirection extent {(sx, sy, sz)} is not {nb}")
    packed = np.frombuffer(data, "<u4", n, off).reshape(sz, sy, sx)
    off += n * 4
    (rx, ry, rz), n, off = _buf_header(data, off)
    range_ = np.frombuffer(data, "<f2", n * 2, off).astype(np.float32).reshape(rz, ry, rx, 2)
    off += n * 4
    (ax, ay, az), n, off = _buf_header(data, off)
    atlas3d = np.frombuffer(data, np.uint8, n, off).reshape(az, ay, ax)
    off += n
    (n_mips,) = struct.unpack_from("<Q", data, off)
    off += 8
    mips = []
    for _ in range(n_mips):
        (mx, my, mz), n, off = _buf_header(data, off)
        mips.append(np.frombuffer(data, "<f2", n * 2, off).astype(np.float32)
                    .reshape(mz, my, mx, 2))
        off += n * 4
    px = (packed >> 22).astype(np.int64)
    py = ((packed >> 12) & 1023).astype(np.int64)
    pz = ((packed >> 2) & 1023).astype(np.int64)
    nbx, nby, nbz = ax // 8, ay // 8, az // 8
    slots = (atlas3d.reshape(nbz, 8, nby, 8, nbx, 8).transpose(0, 2, 4, 1, 3, 5)
             .reshape(-1, 8, 8, 8).copy())
    slot_ids = pz * (nby * nbx) + py * nbx + px
    slot_ids = np.clip(slot_ids, 0, max(0, slots.shape[0] - 1)).astype(np.uint32)
    return Brick(slot_ids, np.ascontiguousarray(range_), slots, transform,
                 np.array([sx * 8, sy * 8, sz * 8], np.int64), mips or build_range_mips(range_))


def build_range_mips(range_: np.ndarray, n_mips: int = 3) -> list:
    """Min/max pyramid over the per-brick ranges, ceil-halving, the
    padding taking edge values."""
    mips, cur = [], range_
    for _ in range(n_mips):
        bz, by, bx = cur.shape[:3]
        nz, ny, nx = max(1, -(-bz // 2)), max(1, -(-by // 2)), max(1, -(-bx // 2))
        pad = np.empty((nz * 2, ny * 2, nx * 2, 2), dtype=np.float32)
        pad[:bz, :by, :bx] = cur
        pad[bz:, :by, :bx] = cur[-1:, :, :]
        pad[:, by:, :bx] = pad[:, by - 1:by, :bx]
        pad[:, :, bx:] = pad[:, :, bx - 1:bx]
        blocks = pad.reshape(nz, 2, ny, 2, nx, 2, 2)
        nxt = np.empty((nz, ny, nx, 2), dtype=np.float32)
        nxt[..., 0] = blocks[..., 0].min(axis=(1, 3, 5))
        nxt[..., 1] = blocks[..., 1].max(axis=(1, 3, 5))
        mips.append(nxt)
        cur = nxt
    return mips


def encode_bricks(dense: np.ndarray, transform: np.ndarray) -> Brick:
    """A dense (z, y, x) float32 array as 8^3 bricks: a slot for each brick
    with max > min, voxels as ((v - lo) * (255 / (hi - lo)) + 0.5) bytes."""
    dense = np.asarray(dense, dtype=np.float32)
    Z, Y, X = dense.shape
    bx, by, bz = -(-X // 8), -(-Y // 8), -(-Z // 8)
    padded = np.zeros((bz * 8, by * 8, bx * 8), dtype=np.float32)
    padded[:Z, :Y, :X] = dense
    blocks = padded.reshape(bz, 8, by, 8, bx, 8).transpose(0, 2, 4, 1, 3, 5).copy()
    bmin = blocks.min(axis=(3, 4, 5))
    bmax = blocks.max(axis=(3, 4, 5))
    occupied = bmax > bmin
    n_occ = int(occupied.sum())
    slot_ids = np.zeros((bz, by, bx), dtype=np.uint32)
    slot_ids[occupied] = np.arange(n_occ, dtype=np.uint32)
    if n_occ > 0:
        occ = blocks[occupied]
        omin = bmin[occupied][:, None, None, None]
        omax = bmax[occupied][:, None, None, None]
        scale = np.float32(255.0) / (omax - omin)
        atlas = ((occ - omin) * scale + np.float32(0.5)).astype(np.uint8)
    else:
        atlas = np.zeros((1, 8, 8, 8), dtype=np.uint8)
    range_ = np.stack([bmin, bmax], axis=-1).astype(np.float32)
    return Brick(slot_ids, range_, atlas, np.asarray(transform, np.float32),
                 np.array([X, Y, Z], np.int64), build_range_mips(range_))


def _corners_world(extent, m):
    ext = np.asarray(extent, dtype=np.float32)
    corners = np.array([[x, y, z, 1.0] for x in (0, ext[0]) for y in (0, ext[1])
                        for z in (0, ext[2])], dtype=np.float32)
    world = corners @ np.asarray(m, np.float32).T
    return world[:, :3].min(axis=0), world[:, :3].max(axis=0)


def fit_unit_cube(brick: Brick, density_scale: float):
    """(volume transform, density scale): the grid fitted into [-0.5,
    0.5]^3 and the density scaled by the size factor."""
    bb_min, bb_max = _corners_world(brick.voxel_extent, brick.transform)
    bb_min = np.minimum(np.full(3, np.finfo(np.float32).max), bb_min)
    bb_max = np.maximum(np.full(3, -np.finfo(np.float32).max), bb_max)
    extent = bb_max - bb_min
    size = float(extent.max())
    t = np.eye(4, dtype=np.float32)
    if size != 1.0:
        t[:3, :3] *= 1.0 / size
        t[:3, 3] = (-bb_min - 0.5 * extent) / size
        density_scale *= size
    return t, density_scale


def mip_layout(n_bricks):
    bx, by, bz = n_bricks
    dims = [(bz, by, bx)]
    for _ in range(3):
        z, y, x = dims[-1]
        dims.append((max(1, -(-z // 2)), max(1, -(-y // 2)), max(1, -(-x // 2))))
    offs = [0]
    for z, y, x in dims[:-1]:
        offs.append(offs[-1] + z * y * x)
    return tuple(dims), tuple(offs)


class Grid(NamedTuple):
    atlas: torch.Tensor          # (n_slots * 512,) uint8
    slot: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    mip: torch.Tensor
    transform: np.ndarray        # (4, 4) float32 index -> world
    inv_transform: np.ndarray
    n_bricks: tuple              # (bx, by, bz)
    n_slots: int
    mip_dims: tuple
    mip_offsets: tuple


def upload(brick: Brick, volume_transform: np.ndarray, device) -> Grid:
    t = np.asarray(volume_transform, np.float64) @ np.asarray(brick.transform, np.float64)
    inv = np.linalg.inv(t)
    bz, by, bx = brick.indirection.shape
    dims, offs = mip_layout((bx, by, bz))
    mips = brick.range_mips
    if len(mips) < 3 or any(m.shape[:3] != d for m, d in zip(mips, dims[1:])):
        mips = build_range_mips(brick.range)
    levels = [brick.range[..., 1]] + [m[..., 1] for m in mips[:3]]
    mip = np.concatenate([m.reshape(-1) for m in levels]).astype(np.float32)
    return Grid(
        atlas=torch.as_tensor(np.ascontiguousarray(brick.atlas.reshape(-1)), device=device),
        slot=torch.as_tensor(brick.indirection.reshape(-1).astype(np.int32), device=device),
        lo=torch.as_tensor(np.ascontiguousarray(brick.range[..., 0].reshape(-1)), device=device),
        hi=torch.as_tensor(np.ascontiguousarray(brick.range[..., 1].reshape(-1)), device=device),
        mip=torch.as_tensor(mip, device=device),
        transform=t.astype(np.float32), inv_transform=inv.astype(np.float32),
        n_bricks=(int(bx), int(by), int(bz)), n_slots=int(brick.atlas.shape[0]),
        mip_dims=dims, mip_offsets=offs)


# ---------------------------------------------------------------------------
# the sky
# ---------------------------------------------------------------------------

def _bilinear_wrap_u(img, u, v):
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0).astype(np.float32)[..., None]
    fy = (y - y0).astype(np.float32)[..., None]
    x0w, x1w = x0 % w, (x0 + 1) % w
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    top = img[y0c, x0w] * (1 - fx) + img[y0c, x1w] * fx
    bot = img[y1c, x0w] * (1 - fx) + img[y1c, x1w] * fx
    return top * (1 - fy) + bot * fy


def importance_pyramid(envmap_v: np.ndarray) -> list:
    """512^2 texels of the mean of 8x8 bilinear luma taps, then 2x2 means
    down to 1x1, rows in v-order."""
    n = IMP_DIMENSION * IMP_SAMPLES
    base = np.empty((IMP_DIMENSION, IMP_DIMENSION), dtype=np.float32)
    us = (np.arange(n, dtype=np.float32) + 0.5) / n
    for row0 in range(0, IMP_DIMENSION, 64):
        rows = slice(row0 * IMP_SAMPLES, (row0 + 64) * IMP_SAMPLES)
        vs = (np.arange(n, dtype=np.float32)[rows] + 0.5) / n
        uu, vv = np.meshgrid(us, vs)
        taps = _bilinear_wrap_u(envmap_v, uu, vv) @ _LUMA
        base[row0:row0 + 64] = taps.reshape(64, IMP_SAMPLES, IMP_DIMENSION,
                                            IMP_SAMPLES).mean(axis=(1, 3))
    mips, cur = [base], base
    while cur.shape[0] > 1:
        cur = cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2).mean(axis=(1, 3))
        mips.append(cur.astype(np.float32))
    return mips


def alias_table(weights: np.ndarray):
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
        l = large.pop()  # noqa: E741
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


class Sky(NamedTuple):
    texels: torch.Tensor         # (H*W, 3) float32, rows in v-order
    alias: torch.Tensor          # (D*D, 10) float32 alias rows
    hw: tuple
    imp_avg: float
    transform: np.ndarray        # (3, 3) float32
    inv_transform: np.ndarray
    strength: float


def sky_tables(image: np.ndarray, device, strength: float = 1.0) -> Sky:
    """An equirect (H, W, 3) sky in image order -> its texels in v-order,
    the alias rows [keep, alias, own pdf, alias pdf, own rgb, alias rgb]
    over its importance map, and its scalars (identity rotation)."""
    image = np.atleast_3d(np.asarray(image, dtype=np.float32))
    envmap = np.ascontiguousarray(image[::-1])
    mips = importance_pyramid(envmap)
    prob, alias = alias_table(mips[0])
    w = np.asarray(mips[0], np.float32).reshape(-1)
    avg = float(mips[-1].reshape(()))
    pdf = w / max(avg, 1e-20) * (1.0 / (4.0 * np.pi))
    dim = int(mips[0].shape[0])
    eh, ew = envmap.shape[:2]
    fy, fx = eh // dim or 1, ew // dim or 1
    ph, pw = dim * fy - eh, dim * fx - ew
    emap = envmap
    if ph or pw:
        emap = np.pad(emap, ((0, max(0, ph)), (0, max(0, pw)), (0, 0)), mode="edge")
    texel_rgb = (emap[:dim * fy, :dim * fx].reshape(dim, fy, dim, fx, 3)
                 .mean(axis=(1, 3)).reshape(dim * dim, 3))
    packed = np.concatenate([np.stack([prob, alias.astype(np.float32), pdf, pdf[alias]], -1),
                             texel_rgb, texel_rgb[alias]], axis=-1).astype(np.float32)
    transform = np.eye(3, dtype=np.float32)
    texels = np.array(envmap[..., :3], np.float32).reshape(eh * ew, 3)
    return Sky(torch.as_tensor(texels, device=device), torch.as_tensor(packed, device=device),
               (int(eh), int(ew)), avg, transform,
               np.linalg.inv(transform.astype(np.float64)).astype(np.float32),
               float(np.float32(strength)))


# ---------------------------------------------------------------------------
# the camera and the parameter block
# ---------------------------------------------------------------------------

def _normalize(v):
    return v / np.linalg.norm(v)


def camera_transform(pos, direction, up) -> np.ndarray:
    """View -> world rotation of lookAt(pos, pos + dir, up), float32."""
    f = _normalize(np.asarray(direction, np.float32).astype(np.float64))
    s = _normalize(np.cross(f, np.asarray(up, np.float32).astype(np.float64)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ np.asarray(pos, np.float32).astype(np.float64)
    return np.linalg.inv(m.astype(np.float32)[:3, :3]).astype(np.float32)


class Scene(NamedTuple):
    """What a dispatch reads besides its pool and its camera."""

    density: Grid
    emission: Grid | None
    emi_x: np.ndarray | None     # (4, 4) float32 density index -> emission index
    sky: Sky
    pf: np.ndarray               # (PF_SIZE,) float32, the camera's slots unset
    bounces: int


def build_scene(brick_path: str, sky_image: np.ndarray, settings: dict,
                temperature: np.ndarray | None, temperature_transform: np.ndarray | None,
                device) -> Scene:
    """The tables and the camera-free parameter block of a committed
    scene: ``settings`` holds bounces, albedo, phase, density_scale,
    emission_scale and show_environment."""
    f32 = np.float32
    brick = read_brick(brick_path)
    vol_t, density_scale = fit_unit_cube(brick, float(settings["density_scale"]))
    density = upload(brick, vol_t, device)
    emission = emi_x = None
    emission_norm = 1.0
    if temperature is not None:
        temp = encode_bricks(temperature, temperature_transform)
        emission = upload(temp, vol_t, device)
        majorant_emission = float(np.asarray(temperature, np.float32).max())
        emission_norm = float(f32(1.0 / max(majorant_emission, 1e-4)
                                  if majorant_emission > 0.0 else 1.0))
        emi_x = (np.asarray(emission.inv_transform, f32) @ np.asarray(density.transform, f32))
    sky = sky_tables(sky_image, device)
    bb_min, bb_max = _corners_world(brick.voxel_extent, vol_t @ brick.transform)
    extent = bb_max - bb_min
    mj = float(brick.range[..., 1].max())
    maj = max(mj * density_scale, 1e-20)
    albedo = np.broadcast_to(np.asarray(settings["albedo"], f32), (3,)).astype(f32)

    pf = np.zeros(PF_SIZE, f32)
    pf[PF_BB_MIN:PF_BB_MIN + 3] = (bb_min + np.zeros(3, f32) * extent).astype(f32)
    pf[PF_BB_MAX:PF_BB_MAX + 3] = (bb_min + np.ones(3, f32) * extent).astype(f32)
    pf[PF_MAJORANT] = float(f32(maj))
    pf[PF_INV_MAJORANT] = float(f32(1.0 / maj))
    pf[PF_ALBEDO:PF_ALBEDO + 3] = albedo
    pf[PF_PHASE_G] = float(f32(settings["phase"]))
    pf[PF_DENSITY_SCALE] = float(f32(density_scale))
    pf[PF_INV_XFORM:PF_INV_XFORM + 16] = np.asarray(density.inv_transform, f32).reshape(-1)
    pf[PF_ENV_INV:PF_ENV_INV + 9] = np.asarray(sky.inv_transform, f32).reshape(-1)
    pf[PF_ENV_STRENGTH] = sky.strength
    pf[PF_IMP_AVG] = sky.imp_avg
    pf[PF_SHOW_ENV] = 1.0 if settings["show_environment"] else 0.0
    if emission is not None:
        pf[PF_EMI_SCALE] = float(f32(settings["emission_scale"]))
        pf[PF_EMI_NORM] = emission_norm
        pf[PF_EMI_X:PF_EMI_X + 16] = np.asarray(emi_x, f32).reshape(-1)
    return Scene(density, emission, emi_x, sky, pf, int(settings["bounces"]))


def camera_slots(pos, direction, up, fov_degree) -> np.ndarray:
    """The parameter block's camera slots: position (3), the (3, 3) view ->
    world rotation row-major (9) and z_cam = -0.5 / tan(fov / 2)."""
    f32 = np.float32
    out = np.zeros(13, f32)
    out[0:3] = np.asarray(pos, f32)
    out[3:12] = camera_transform(pos, direction, up).reshape(-1)
    out[12] = f32(-0.5) / np.tan(f32(0.5 * np.pi) * f32(float(f32(fov_degree))) / f32(180.0))
    return out
