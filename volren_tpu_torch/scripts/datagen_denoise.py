"""Denoising dataset generator (the port of scripts/datagen_denoise.py).

Renders ``--count`` randomised scenes twice through volren_tpu_torch.volpy,
noisy (1-32 spp) and converged (``--spp`` samples), into two ``.npz``
files, ``<output>_input.npz`` and ``<output>_target.npz``, each holding
``color`` (N, 3, H, W) float16 in image row order (the layout of the
reference's HDF5 datasets, datagen_denoise.py:49-52).

The scene parameters come from Python's ``random`` seeded with 42, drawn
for every index as the JAX script draws them, so scene i is the same
whatever the shard layout. By default the volumes are the in-repo
``.scene_cache/cloud512.brick`` and the environment is
``procedural_sky``; ``--volpath`` / ``--envpath`` take folders of
.brick / .vdb volumes and .hdr maps instead. The JAX script's
``DATAGEN_*`` environment variables are flags here, with the same
defaults: ``--count`` (N_IMAGES), ``--spp`` (SPP_TARGET), ``--res``,
``--shard k/n``, ``--resume``, ``--random-tf`` and ``--output``
(H5_NAME). A resumed run keeps the first ``--resume`` scenes of the
existing files. The renders run on the card unless ``--device cpu``.
"""

import argparse
import copy
import math
import os
import random
import time

import numpy as np

from .. import volpy
from ..renderer import DISPATCH_SPP, Renderer
from ..scene.environment import procedural_sky

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")
SKY = "procedural_sky"   # the in-repo environment's name in the env list
SEED = 42
SAVE_EVERY = 8           # scenes between writes of the two .npz files


def glob_directory(root, ext=".hdr"):
    entries = []
    for dirname, _, files in os.walk(root):
        for fname in files:
            if os.path.splitext(fname)[1] == ext:
                entries.append(os.path.join(dirname, fname))
    return sorted(entries)


def uniform_sample_sphere():
    z = 1.0 - 2.0 * random.random()
    r = math.sqrt(max(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * random.random()
    return np.array([r * math.cos(phi), r * math.sin(phi), z], np.float32)


def randomize_parameters(volumes, envmaps):
    """Parameter ranges from the reference (datagen_denoise.py:60-80)."""
    return {
        "samples": random.randint(1, 32 + 1),
        "max_bounces": random.randint(1, 128 + 1),
        "seed_input": random.randint(0, 2**31),
        "seed_target": random.randint(0, 2**31),
        "env_path": random.choice(envmaps),
        "env_strength": 0.5 + random.random() * 10,
        "env_show": random.random() < 0.1,
        "lut_n_bins": random.randint(2, 32 + 1),
        "lut_window_left": random.random() * 0.25,
        "lut_window_width": random.random(),
        "vol_path": random.choice(volumes),
        "vol_albedo": np.array(
            [random.random(), random.random(), random.random()], np.float32
        ),
        "vol_phase": -0.9 + (random.random() * 1.8),
        "vol_density_scale": 0.01 + random.random() * 5,
        "cam_pos_sample": uniform_sample_sphere(),
        "cam_dir_sample": uniform_sample_sphere(),
        "cam_fov": 25 + (random.random() * 70),
    }


def fbo_to_dataset(fbo):
    """(H, W, 3) float framebuffer -> (3, H, W) float16, image row order."""
    return np.transpose(np.flip(fbo, axis=0).astype(np.float16), (2, 0, 1))


_ENVS: dict = {}


def environment(path):
    """A fresh Environment of an env-list entry, an .hdr file or the in-repo
    sky; each map's importance pyramid is built once."""
    if path not in _ENVS:
        _ENVS[path] = volpy.Environment(procedural_sky(1024, 512, 0) if path == SKY else path)
    return copy.copy(_ENVS[path])


def _save(path, color):
    np.savez(path, color=color)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--count", type=int, default=256, help="scenes (DATAGEN_N_IMAGES)")
    p.add_argument("--spp", type=int, default=1 << 12,
                   help="samples of a converged render (DATAGEN_SPP_TARGET)")
    p.add_argument("--res", type=int, default=1024, help="resolution (DATAGEN_RES)")
    p.add_argument("--shard", default="0/1",
                   help="k/n: render only the scenes with index %% n == k (DATAGEN_SHARD)")
    p.add_argument("--resume", type=int, default=0,
                   help="keep the first RESUME owned scenes of the existing files")
    p.add_argument("--random-tf", action="store_true", help="a random LUT per scene")
    p.add_argument("--output", default="dataset", help="output stem (DATAGEN_H5_NAME)")
    p.add_argument("--volpath", default=None, help="folder of .brick / .vdb volumes")
    p.add_argument("--envpath", default=None, help="folder of .hdr environment maps")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    shard_k, shard_n = (int(v) for v in args.shard.split("/"))
    if not 0 <= shard_k < shard_n:
        raise SystemExit("--shard must be k/n with 0 <= k < n")

    volpy.bind_renderer(Renderer(device=args.device))
    renderer = volpy.Renderer()
    renderer.init(args.res, args.res)
    random.seed(SEED)

    volumes = ([CLOUD] if args.volpath is None
               else glob_directory(args.volpath, ".brick") + glob_directory(args.volpath, ".vdb"))
    envmaps = [SKY] if args.envpath is None else glob_directory(args.envpath, ".hdr")
    print("#volumes:", len(volumes))
    print("#envmaps:", len(envmaps))
    if not volumes or not envmaps:
        raise SystemExit("no volumes or envmaps found")

    size = renderer.resolution()
    h, w = int(size.y), int(size.x)
    owned = [i for i in range(args.count) if i % shard_n == shard_k]
    stem = args.output + (f"_shard{shard_k}of{shard_n}" if shard_n > 1 else "")
    paths = (stem + "_input.npz", stem + "_target.npz")
    data = [np.zeros((len(owned), 3, h, w), np.float16) for _ in paths]
    if args.resume:
        for path, arr in zip(paths, data):
            with np.load(path) as old:
                arr[:args.resume] = old["color"][:args.resume]

    def render_hb(spp, tag):
        """render() with a per-dispatch heartbeat line."""
        renderer.reset()
        done = 0
        t_hb = time.time()
        while done < spp:
            n = min(DISPATCH_SPP, spp - done)
            renderer._core.trace(n)
            float(renderer._core.framebuffer()[..., 0].sum())
            done += n
            print(f"@HB {tag} {done}/{spp} {done / (time.time() - t_hb):.2f}spp/s", flush=True)

    j = -1
    for i in range(args.count):
        params = randomize_parameters(volumes, envmaps)
        if i % shard_n != shard_k:
            continue  # params drawn above keep the scene stream aligned
        j += 1
        if j < args.resume:
            continue
        print(f"rendering {i + 1}/{args.count}..", flush=True)
        renderer.volume = volpy.Volume(params["vol_path"])
        renderer.commit()
        renderer.albedo = params["vol_albedo"]
        renderer.phase = params["vol_phase"]
        renderer.density_scale = params["vol_density_scale"]
        env = environment(params["env_path"])
        env.strength = params["env_strength"]
        renderer.environment = env
        renderer.show_environment = params["env_show"]
        if args.random_tf:
            tf = volpy.TransferFunction()
            tf.randomize(params["lut_n_bins"])
            tf.window_left = params["lut_window_left"]
            tf.window_width = params["lut_window_width"]
            renderer.transferfunc = tf
        else:
            renderer.transferfunc = None
        # camera on the volume's bounding sphere
        bb_min, bb_max = renderer.volume.AABB("density")
        bb_min, bb_max = np.asarray(bb_min), np.asarray(bb_max)
        center = bb_min + (bb_max - bb_min) * 0.5
        radius = float(np.linalg.norm(bb_max - center))
        renderer.cam_pos = center + params["cam_pos_sample"] * radius
        d = center + params["cam_dir_sample"] * radius * 0.1 - np.asarray(renderer.cam_pos)
        renderer.cam_dir = d / np.linalg.norm(d)
        renderer.cam_fov = params["cam_fov"]
        # noisy
        renderer.seed = params["seed_input"]
        renderer.bounces = params["max_bounces"]
        t0 = time.time()
        render_hb(params["samples"], "noisy")
        data[0][j] = fbo_to_dataset(renderer.fbo_data())
        t1 = time.time()
        print(f"@SCENE {j} noisy {params['samples']}spp {t1 - t0:.1f}s", flush=True)
        # converged
        renderer.seed = params["seed_target"]
        renderer.bounces = params["max_bounces"]
        render_hb(args.spp, "clean")
        data[1][j] = fbo_to_dataset(renderer.fbo_data())
        print(f"@SCENE {j} clean {args.spp}spp {time.time() - t1:.1f}s", flush=True)
        if (j + 1) % SAVE_EVERY == 0:
            for path, arr in zip(paths, data):
                _save(path, arr)

    for path, arr in zip(paths, data):
        _save(path, arr)
    print(f"{paths[0]} / {paths[1]} written.")


if __name__ == "__main__":
    main()
