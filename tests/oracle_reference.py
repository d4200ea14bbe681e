"""Shared set-up of the oracle-engine tests of volren_tpu_torch against
volren_tpu (tests/test_torch_{oracle,tracking}.py).

The renderer-level case is the scene of tests/test_render.py: the random
16^3 grid in the unit cube under ``Environment.white(0.5)``, 24x24, 16
bounces, 8 passes of the oracle engine, in both packages from the same
settings. Optionally the CLI's ``--fau`` LUT classifies the density, and
the radial flame of tests/test_torch_emission.py (emission_scale 30,
albedo 0.6) glows. The JAX oracle at a second seed gives the seed-to-seed
noise of the statistical bar.

Both packages follow the GLSL control flow draw for draw, so the bar is
per pixel: every pixel within 1e-4, as
tests/test_torch_megakernel.py::test_plain_matches_pallas_kernel_per_pixel
holds the render kernel. One pixel is known to miss it, because XLA fuses
the JAX oracle's multiply-adds (an FMA contraction) where the port rounds
each operation (``KNOWN_FMA_FLIPS``).
"""

import numpy as np

from volren_tpu.ops import scene as jscene_mod
from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.scene.environment import Environment as JEnvironment
from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu.voldata import Volume as JVolume
from volren_tpu_torch.cli import FAU_LUT
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.voldata import DenseGrid, Volume

RES, BOUNCES, SPP, SEED = 24, 16, 8, 42

# Pixels (y, x) of the 8-pass image that differ from the JAX oracle by more
# than 1e-4 in a configuration (use_dda, use_tf, has_emission), and why.
# (19, 10), DDA without TF or emission: XLA contracts the origin updates
# ``org + t * direction`` of earlier bounces into FMAs, so in pass 4 the
# JAX path's origin at bounce 9 lies about 5e-7 away from the port's (and
# from JAX's own un-fused ops, which the port matches bitwise there). In
# that bounce's NEE transmittance_dda call, the second null-collision test
# then takes another stochastic-tricubic tap -- the comparison
# ``r < w / max(1e-3, sum_wt)`` of grid.stochastic_tricubic_filter flips
# -- so d is 20.51 instead of 7.94 and ``u_cls * maj < d`` (16.32) becomes
# a real collision. The pixel moves by 9.8e-4. With XLA held to SSE4.2 (no
# FMA instructions) the JAX pixel equals the port's bitwise.
KNOWN_FMA_FLIPS = {(True, False, False): {(19, 10)}}
# the most pixels the per-pixel bar may miss: 0.5% of the image
MAX_FLIPPED = int(0.005 * RES * RES)


def flame() -> np.ndarray:
    zz, yy, xx = np.meshgrid(*([np.arange(16)] * 3), indexing="ij")
    dist = np.sqrt((xx - 8) ** 2 + (yy - 8) ** 2 + (zz - 8) ** 2)
    return np.clip(1.0 - dist / 8.0, 0.0, 1.0).astype(np.float32)


def _setup(r, grid, dda, tf, emission, seed, volume_cls, grid_cls, env_cls, tf_cls):
    r.volume = volume_cls(grid_cls(16, 16, 16, grid))
    r.scale_and_move_to_unit_cube()
    r.set_environment(env_cls.white(0.5))
    r.bounces = BOUNCES
    r.seed = seed
    if tf:
        r.set_transferfunc(tf_cls(FAU_LUT))
    if emission:
        r.volume.update_grid_frame(0, grid_cls(16, 16, 16, flame()), "flame")
        r.emission_scale = 30.0
        r.albedo = np.full(3, 0.6, np.float32)
    r.init(RES, RES)
    r.commit()
    r.engine = "oracle"
    r._use_dda = dda
    return r


def jax_renderer(grid, dda, tf, emission, seed=SEED):
    return _setup(JRenderer(), grid, dda, tf, emission, seed, JVolume, JDenseGrid,
                  JEnvironment, JTransferFunction)


def port_renderer(grid, dda, tf, emission, seed=SEED):
    return _setup(Renderer(device="cpu"), grid, dda, tf, emission, seed, Volume, DenseGrid,
                  Environment, TransferFunction)


def oracle_case(grid, dda, tf, emission):
    """8 passes of both packages' oracle engines, the JAX one at two seeds."""
    j = jax_renderer(grid, dda, tf, emission)
    cfg = j._config()
    assert (cfg.use_dda, cfg.use_tf, cfg.has_emission) == (dda, tf, emission)
    j.render(SPP)
    jax_img = np.asarray(j.framebuffer())
    j.seed = SEED + 1
    j.render(SPP)
    other = np.asarray(j.framebuffer())
    p = port_renderer(grid, dda, tf, emission)
    p.render(SPP)
    assert p.last_engine == "torch_oracle"
    port = p.framebuffer().numpy()
    return {"jax": jax_img, "port": port, "noise": rmse(other, jax_img),
            "key": (dda, tf, emission)}


def rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def mean_rel(a, b):
    return abs(a[..., :3].mean() - b[..., :3].mean()) / max(b[..., :3].mean(), 1e-9)


def check_per_pixel(case):
    """Every pixel within 1e-4 of the JAX oracle but for the configuration's
    known FMA flips (at most MAX_FLIPPED); the statistical bars on every
    pixel: RMSE below 1.5x the seed-to-seed noise, mean within 5%."""
    got, ref = case["port"], case["jax"]
    assert got.shape == (RES, RES, 4) and np.isfinite(got).all()
    err = np.abs(got - ref).max(-1)
    off = {tuple(int(v) for v in p) for p in np.argwhere(err > 1e-4)}
    known = KNOWN_FMA_FLIPS.get(case["key"], set())
    assert off <= known and len(off) <= MAX_FLIPPED, (sorted(off), float(err.max()))
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def _grid_arrays(g):
    return dict(atlas=np.asarray(g.atlas), brick_meta=np.asarray(g.brick_meta),
                mip_maj=np.asarray(g.mip_maj), transform=np.asarray(g.transform),
                inv_transform=np.asarray(g.inv_transform))


def port_scene(scene, params=None, device="cpu"):
    """A JAX SceneDevice (env and tf optional) and TraceParams in the
    port, through ``ops.scene.from_reference``: (SceneTables, TraceParams)."""
    e, tf = scene.env, scene.tf
    if e is None:
        e = jscene_mod.upload_environment(JEnvironment.white(0.5))
    ref = tscene.from_reference(
        **_grid_arrays(scene.density), envmap=np.asarray(e.envmap),
        alias_packed=np.asarray(e.alias_packed), imp_avg=np.asarray(e.imp_mips[-1]),
        env_transform=np.asarray(e.transform), env_inv_transform=np.asarray(e.inv_transform),
        env_strength=np.asarray(e.strength), imp_mips=[np.asarray(m) for m in e.imp_mips],
        params=None if params is None else {k: np.asarray(v)
                                            for k, v in params._asdict().items()},
        tf_lut=None if tf is None else np.asarray(tf.lut),
        tf_window=(0.0, 1.0) if tf is None else (np.asarray(tf.window_left),
                                                 np.asarray(tf.window_width)),
        emission=None if scene.emission is None else _grid_arrays(scene.emission),
        device=device)
    return tscene.SceneTables(ref.grid, ref.emission, ref.env, ref.tf), ref.params
