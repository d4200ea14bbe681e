"""COLMAP dataset generator (the port of scripts/datagen_colmap.py).

Renders ``--views`` views of a volume through volren_tpu_torch.volpy from
Sobol-QMC camera positions on its bounding sphere, saves
``view_%06d.png`` with alpha, and writes a COLMAP text model
(SIMPLE_PINHOLE; the world AABB stored as Point3D id 0, pos = bb_min,
rgb = bb_max -- datagen_colmap.py:69-73).

By default it renders the in-repo ``.scene_cache/cloud512.brick`` under
``procedural_sky``; ``--volume`` and ``--envmap`` take other files. The
JAX script's ``DATAGEN_*`` environment variables are flags here, with the
same defaults: ``--out`` (DATAGEN_OUT), ``--views`` (N_VIEWS), ``--spp``,
``--res`` and ``--shard k/n``. The renders run on the card unless
``--device cpu``.
"""

import argparse
import math
import os

import numpy as np

from .. import volpy
from ..renderer import Renderer
from ..scene.environment import procedural_sky
from . import colmap_model as colmap
from .datagen_denoise import CLOUD

ALBEDO = np.array([0.9, 0.9, 0.9], np.float32)
PHASE = 0.5
DENSITY_SCALE = 1.0
ENV_STRENGTH = 2.0
BOUNCES = 128
FOVY = 70
SEED = 42
BACKGROUND = True
TONEMAPPING = True


def sample_unit_sphere(sample):
    z = 1.0 - 2.0 * sample[0]
    r = math.sqrt(max(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * sample[1]
    return np.array([r * math.cos(phi), r * math.sin(phi), z], np.float32)


def main(argv=None):
    from scipy.stats import qmc

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="colmap", help="output folder (DATAGEN_OUT)")
    p.add_argument("--views", type=int, default=256, help="views (DATAGEN_N_VIEWS)")
    p.add_argument("--spp", type=int, default=1 << 12, help="samples per view (DATAGEN_SPP)")
    p.add_argument("--res", type=int, default=1024, help="resolution (DATAGEN_RES)")
    p.add_argument("--shard", default="0/1",
                   help="k/n: render only the views with index %% n == k (DATAGEN_SHARD)")
    p.add_argument("--volume", default=CLOUD, help="the volume (DATAGEN_VOLUME)")
    p.add_argument("--envmap", default=None,
                   help="an .hdr environment map (DATAGEN_ENVMAP; default: procedural_sky)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    shard_k, shard_n = (int(v) for v in args.shard.split("/"))
    if not 0 <= shard_k < shard_n:
        raise SystemExit("--shard must be k/n with 0 <= k < n")

    volpy.bind_renderer(Renderer(device=args.device))
    renderer = volpy.Renderer()
    renderer.init(args.res, args.res)
    os.makedirs(args.out, exist_ok=True)

    renderer.seed = SEED
    renderer.bounces = BOUNCES
    renderer.volume = volpy.Volume(args.volume)
    renderer.albedo = ALBEDO
    renderer.phase = PHASE
    renderer.density_scale = DENSITY_SCALE
    env = volpy.Environment(procedural_sky(1024, 512, 0) if args.envmap is None
                            else args.envmap)
    env.strength = ENV_STRENGTH
    renderer.environment = env
    renderer.show_environment = BACKGROUND
    renderer.tonemapping = TONEMAPPING
    renderer.scale_and_move_to_unit_cube()
    renderer.commit()

    cameras, images, points3D = {}, {}, {}

    bb_min, bb_max = (np.asarray(v) for v in renderer.volume.AABB("density"))
    # world AABB smuggled as a Point3D (pos=bb_min, rgb=bb_max)
    points3D[0] = colmap.Point3D(id=0, xyz=list(bb_min), rgb=list(bb_max))

    res = renderer.resolution()
    cameras[0] = colmap.Camera(
        id=0,
        model="SIMPLE_PINHOLE",
        width=int(res.x),
        height=int(res.y),
        params=[renderer.colmap_focal_length(), int(res.x) // 2, int(res.y) // 2],
    )

    sampler_out = qmc.Sobol(d=2, seed=SEED + 1)
    sampler_in = qmc.Sobol(d=2, seed=SEED + 2)

    for i in range(args.views):
        center = bb_min + (bb_max - bb_min) * 0.5
        radius = float(np.linalg.norm(bb_max - center))
        pos = center + sample_unit_sphere(sampler_out.random()[0, 0:2]) * radius
        aim = center + sample_unit_sphere(sampler_in.random()[0, 0:2]) * radius * 0.1
        if i % shard_n != shard_k:
            continue  # Sobol draws above keep the view stream aligned
        print(f"rendering {i + 1}/{args.views}..")
        renderer.cam_pos = pos
        d = aim - np.asarray(renderer.cam_pos)
        renderer.cam_dir = d / np.linalg.norm(d)
        renderer.cam_fov = FOVY
        renderer.render(args.spp)
        filename = f"view_{i:06}.png"
        renderer.save_with_alpha(os.path.join(args.out, filename))
        q = renderer.colmap_view_rot()
        images[i] = colmap.Image(
            id=i,
            qvec=[q.w, q.x, q.y, q.z],
            tvec=list(np.asarray(renderer.colmap_view_trans())),
            camera_id=0,
            name=filename,
        )

    print("--------------------")
    print("#cameras:", len(cameras))
    print("#images:", len(images))
    print("#points3D:", len(points3D))
    model_path = args.out if shard_n == 1 else os.path.join(
        args.out, f"model_shard{shard_k}of{shard_n}"
    )
    colmap.write_model(cameras, images, points3D, path=model_path)


if __name__ == "__main__":
    main()
