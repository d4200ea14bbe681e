"""Minimal COLMAP model writer/reader (text and binary): a copy of the
repo's scripts/colmap_model.py, which imports nothing of JAX.

Covers what datagen_colmap needs (cf. the reference's vendored
scripts/read_write_model.py, which handles both .txt and .bin):
cameras / images / points3D with SIMPLE_PINHOLE cameras. Written from
scratch against the public COLMAP text and binary format specs.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

# COLMAP camera model registry: name -> (model_id, num_params)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
CAMERA_MODEL_NAMES = {mid: (name, n) for name, (mid, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: list


@dataclass
class Image:
    id: int
    qvec: list  # (w, x, y, z)
    tvec: list  # (x, y, z)
    camera_id: int
    name: str
    xys: list = field(default_factory=list)
    point3D_ids: list = field(default_factory=list)


@dataclass
class Point3D:
    id: int
    xyz: list
    rgb: list
    error: float = 0.0
    image_ids: list = field(default_factory=list)
    point2D_idxs: list = field(default_factory=list)


def write_model(
    cameras: dict, images: dict, points3D: dict, path: str, ext: str = ".txt"
) -> None:
    if ext == ".bin":
        write_model_binary(cameras, images, points3D, path)
    else:
        write_model_text(cameras, images, points3D, path)


def read_model(path: str, ext: str | None = None):
    """Read a COLMAP model; autodetects .bin vs .txt when ext is None."""
    if ext is None:
        ext = ".bin" if os.path.exists(os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".bin":
        return read_model_binary(path)
    return read_model_text(path)


def write_model_text(cameras: dict, images: dict, points3D: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{float(x)!r} {float(y)!r} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(pts + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        f.write(f"# Number of points: {len(points3D)}\n")
        for pt in points3D.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            # rgb written via str() like the reference's vendored writer —
            # datagen_colmap smuggles the float AABB max through this field
            # (reference datagen_colmap.py:69-73), so ints must not be forced
            rgb = " ".join(
                str(int(v)) if float(v) == int(v) and 0 <= v <= 255 else repr(float(v))
                for v in pt.rgb
            )
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(pt.image_ids, pt.point2D_idxs)
            )
            f.write(f"{pt.id} {xyz} {rgb} {pt.error!r} {track}\n")


def read_model_text(path: str):
    cameras, images, points = {}, {}, {}
    with open(os.path.join(path, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cameras[int(parts[0])] = Camera(
                id=int(parts[0]),
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=[float(p) for p in parts[4:]],
            )
    with open(os.path.join(path, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#")]
    for head, pts in zip(lines[0::2], lines[1::2]):
        p = head.split()
        im = Image(
            id=int(p[0]),
            qvec=[float(v) for v in p[1:5]],
            tvec=[float(v) for v in p[5:8]],
            camera_id=int(p[8]),
            name=p[9],
        )
        toks = pts.split()
        im.xys = [(float(toks[i]), float(toks[i + 1])) for i in range(0, len(toks), 3)]
        im.point3D_ids = [int(toks[i + 2]) for i in range(0, len(toks), 3)]
        images[im.id] = im
    with open(os.path.join(path, "points3D.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            points[int(p[0])] = Point3D(
                id=int(p[0]),
                xyz=[float(v) for v in p[1:4]],
                rgb=[float(v) for v in p[4:7]],
                error=float(p[7]),
                image_ids=[int(v) for v in p[8::2]],
                point2D_idxs=[int(v) for v in p[9::2]],
            )
    return cameras, images, points


# ---------------------------------------------------------------------------
# Binary model format. Little-endian, layout per the public COLMAP spec:
#   cameras.bin:  u64 n; per camera: i32 id, i32 model_id, u64 w, u64 h,
#                 f64 params[num_params(model)]
#   images.bin:   u64 n; per image: i32 id, f64 qvec[4], f64 tvec[3],
#                 i32 camera_id, name bytes until NUL, u64 n_pts2D,
#                 then per point: f64 x, f64 y, i64 point3D_id
#   points3D.bin: u64 n; per point: i64 id, f64 xyz[3], u8 rgb[3],
#                 f64 error, u64 track_len, per elem: i32 image_id, i32 idx
# NOTE: rgb is u8 in binary — the float-AABB-through-rgb trick used by
# datagen_colmap only survives the TEXT format (same limitation as the
# reference's vendored writer).
# ---------------------------------------------------------------------------


def write_model_binary(cameras: dict, images: dict, points3D: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, n_params = CAMERA_MODELS[cam.model]
            if len(cam.params) != n_params:
                raise ValueError(
                    f"camera {cam.id}: model {cam.model} takes {n_params} "
                    f"params, got {len(cam.params)}"
                )
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{n_params}d", *[float(p) for p in cam.params]))
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *[float(v) for v in im.qvec]))
            f.write(struct.pack("<3d", *[float(v) for v in im.tvec]))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pt in points3D.values():
            f.write(struct.pack("<q", pt.id))
            f.write(struct.pack("<3d", *[float(v) for v in pt.xyz]))
            rgb = [max(0, min(255, int(round(float(v))))) for v in pt.rgb]
            f.write(struct.pack("<3B", *rgb))
            f.write(struct.pack("<d", float(pt.error)))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for i, j in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))


def _read_exact(f, n):
    buf = f.read(n)
    if len(buf) != n:
        raise EOFError(f"truncated COLMAP binary file (wanted {n} bytes)")
    return buf


def read_model_binary(path: str):
    cameras, images, points = {}, {}, {}
    with open(os.path.join(path, "cameras.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", _read_exact(f, 8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", _read_exact(f, 24))
            name, n_params = CAMERA_MODEL_NAMES[model_id]
            params = list(struct.unpack(f"<{n_params}d", _read_exact(f, 8 * n_params)))
            cameras[cid] = Camera(id=cid, model=name, width=w, height=h, params=params)
    with open(os.path.join(path, "images.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", _read_exact(f, 8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", _read_exact(f, 4))
            qvec = list(struct.unpack("<4d", _read_exact(f, 32)))
            tvec = list(struct.unpack("<3d", _read_exact(f, 24)))
            (cam_id,) = struct.unpack("<i", _read_exact(f, 4))
            name_bytes = bytearray()
            while (c := _read_exact(f, 1)) != b"\x00":
                name_bytes += c
            (n_pts,) = struct.unpack("<Q", _read_exact(f, 8))
            im = Image(
                id=iid,
                qvec=qvec,
                tvec=tvec,
                camera_id=cam_id,
                name=name_bytes.decode("utf-8"),
            )
            for _ in range(n_pts):
                x, y, pid = struct.unpack("<ddq", _read_exact(f, 24))
                im.xys.append((x, y))
                im.point3D_ids.append(pid)
            images[iid] = im
    with open(os.path.join(path, "points3D.bin"), "rb") as f:
        (n,) = struct.unpack("<Q", _read_exact(f, 8))
        for _ in range(n):
            (pid,) = struct.unpack("<q", _read_exact(f, 8))
            xyz = list(struct.unpack("<3d", _read_exact(f, 24)))
            rgb = list(struct.unpack("<3B", _read_exact(f, 3)))
            (error,) = struct.unpack("<d", _read_exact(f, 8))
            (track,) = struct.unpack("<Q", _read_exact(f, 8))
            pt = Point3D(id=pid, xyz=xyz, rgb=rgb, error=error)
            for _ in range(track):
                i, j = struct.unpack("<ii", _read_exact(f, 8))
                pt.image_ids.append(i)
                pt.point2D_idxs.append(j)
            points[pid] = pt
    return cameras, images, points
