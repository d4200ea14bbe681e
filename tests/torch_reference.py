"""Shared set-up of the render-kernel tests of volren_tpu_torch against
volren_tpu (tests/test_torch_{megakernel,tf,emission,packs}.py).

A JAX ``Renderer`` describes the scene. Its device tables, NEE pool, trace
parameters and (for a TF scene) its own baked TF majorant table go through
``ops.scene.from_reference`` into the port, so both packages render the
same numbers. The references are the Pallas kernel in interpret mode with
f32 tables (``mip_u8=False, env_rgbe=False, pool_rgbe=False``, the TF
``mip_override`` built as ``renderer._render_pallas`` builds it) and the
chunked XLA engine at two seeds, whose difference is the seed-to-seed
noise of the bar.
"""

import numpy as np

from volren_tpu.ops.megakernel import render_wavefront_chunked
from volren_tpu.ops.pallas import pack_scene as jpack_scene
from volren_tpu.ops.pallas.kernel import render_strips
from volren_tpu.ops.pallas.pack import build_env_pool as jbuild_env_pool
from volren_tpu.ops.pallas.pack import build_mip_u8 as jbuild_mip_u8
from volren_tpu.ops.pallas.pack import build_params_rows
from volren_tpu.ops.transfer import tf_alpha_majorant as jtf_alpha_majorant
from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.scene.environment import Environment as JEnvironment
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu.voldata import Volume as JVolume
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack

SPP, RES, SEED = 8, 32, 123


def rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def mean_rel(a, b):
    return abs(a[:, :3].mean() - b[:, :3].mean()) / max(b[:, :3].mean(), 1e-9)


def jax_renderer(random_grid16):
    """The scene of tests/test_pallas.py: the random 16^3 grid, a white 0.7
    sky, 16 bounces, seed 123, 32x32. Not committed yet."""
    r = JRenderer()
    r.volume = JVolume(JDenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.set_environment(JEnvironment.white(0.7))
    r.bounces = 16
    r.seed = SEED
    r.init(RES, RES)
    return r


def jax_tf_majorant(packed, scene, params):
    """renderer._render_pallas's TF majorant table (``mip_override``)."""
    raw = packed.mip_maj
    d_norm = params.density_scale * raw * params.inv_majorant
    return params.majorant * jtf_alpha_majorant(
        scene.tf, d_norm.reshape(-1), onehot=False).reshape(raw.shape)


def _grid_arrays(g):
    return dict(atlas=np.asarray(g.atlas), brick_meta=np.asarray(g.brick_meta),
                mip_maj=np.asarray(g.mip_maj), transform=np.asarray(g.transform),
                inv_transform=np.asarray(g.inv_transform))


def port_inputs(scene, params, pool, mip_tf=None):
    """The JAX scene, trace parameters, NEE pool and baked TF majorant
    table in the port: (Reference, KernelScene, pf, pi) of one dispatch of
    SPP samples at RES x RES."""
    e, tf = scene.env, scene.tf
    ref = tscene.from_reference(
        **_grid_arrays(scene.density), envmap=np.asarray(e.envmap),
        alias_packed=np.asarray(e.alias_packed), imp_avg=np.asarray(e.imp_mips[-1]),
        env_transform=np.asarray(e.transform), env_inv_transform=np.asarray(e.inv_transform),
        env_strength=np.asarray(e.strength), pool={k: np.asarray(v) for k, v in pool.items()},
        params={k: np.asarray(v) for k, v in params._asdict().items()},
        tf_lut=None if tf is None else np.asarray(tf.lut),
        tf_window=(0.0, 1.0) if tf is None else (np.asarray(tf.window_left),
                                                 np.asarray(tf.window_width)),
        emission=None if scene.emission is None else _grid_arrays(scene.emission),
        mip_tf=None if mip_tf is None else np.asarray(mip_tf))
    ks = tpack.pack_scene(ref.grid, ref.env, tf=ref.tf, emission=ref.emission)
    ks = ks._replace(mip_tf=ref.mip_tf)
    tpf, tpi = tpack.build_params(ks, ref.params, RES, RES, 0, SPP)
    return ref, ks, tpf, tpi


def chunked_images(scene, params, cfg):
    """The chunked XLA engine's images at two seeds (sample bases 0 and
    SPP), as reference_case renders them."""
    ccfg = cfg._replace(use_onehot=False, env_nearest_nee=True)
    return [np.asarray(render_wavefront_chunked(scene, params, ccfg, RES, RES, SPP, base))
            .reshape(-1, 4) / SPP for base in (0, SPP)]


def reference_case(r):
    """Reference images of the committed JAX renderer ``r`` and the same
    inputs in the port, with the plain version's image."""
    scene, params, cfg = r._scene_device(), r._trace_params(), r._config()
    pool = jbuild_env_pool(scene, SEED, 0)
    pf, pi = build_params_rows(scene, params, RES, RES, 0)
    packed = jpack_scene(scene, use_tf=cfg.use_tf, use_emission=cfg.has_emission)
    mip_tf = jax_tf_majorant(packed, scene, params) if cfg.use_tf else None
    pallas = np.asarray(render_strips(
        packed, pool, pf, pi, RES * RES, RES, SPP, interpret=True, queue_items=1024,
        env_rgbe=False, pool_rgbe=False, mip_u8=False, mip_override=mip_tf)) / SPP
    chunked = chunked_images(scene, params, cfg)
    ref, ks, tpf, tpi = port_inputs(scene, params, pool, mip_tf)
    return {"pallas": pallas, "chunked": chunked,
            "noise": rmse(chunked[1], chunked[0]),
            "inputs": (ks, ref.pool, tpf, tpi), "reference": ref,
            "plain": megakernel.render(ks, ref.pool, tpf, tpi).numpy() / SPP}


def packed_case(r, mip_u8, env_rgbe, pool_rgbe):
    """The committed JAX renderer ``r``'s dispatch of SPP samples through
    the Pallas kernel in interpret mode with its packed tables on as
    asked (the u8 pyramid built as renderer._render_pallas builds it, its
    dequantisation rows in pf), and the port's plain version on the same
    float32 tables, packed by the port (``env_rgbe`` from the texels, the
    u8 pyramid from the baked table, the pool's radiance words from the
    carried pool). The Pallas kernel runs 128 lanes, one march substep
    and one test a step, one serve round (sublanes = k_march = unroll =
    test_every = escape_every = resolve_rounds = escape_rounds = 1): the
    same samples as its defaults (a sample's draws do not depend on the
    schedule), compiled in a third of the time.
    Returns the two (RES*RES, 4) images over SPP and the port's inputs."""
    scene, params, cfg = r._scene_device(), r._trace_params(), r._config()
    pool = jbuild_env_pool(scene, SEED, 0)
    packed = jpack_scene(scene, use_tf=cfg.use_tf, use_emission=cfg.has_emission)
    mip_tf = jax_tf_majorant(packed, scene, params) if cfg.use_tf else None
    mip_override, mip_dq = mip_tf, None
    if mip_u8:
        base = mip_tf if mip_tf is not None else packed.mip_maj * params.density_scale
        mip_override, lo4, sc4 = jbuild_mip_u8(base, packed.meta)
        mip_dq = (lo4, sc4)
    pf, pi = build_params_rows(scene, params, RES, RES, 0, mip_dq=mip_dq)
    pallas = np.asarray(render_strips(
        packed, pool, pf, pi, RES * RES, RES, SPP, interpret=True, queue_items=1024,
        env_rgbe=env_rgbe, pool_rgbe=pool_rgbe, mip_u8=mip_u8, mip_override=mip_override,
        sublanes=1, k_march=1, unroll=1, test_every=1, escape_every=1, resolve_rounds=1,
        escape_rounds=1)) / SPP
    ref, ks, _pf, _pi = port_inputs(scene, params, pool, mip_tf)
    if env_rgbe:
        ks = ks._replace(env_rgbe=tpack.rgbe_encode(ks.env))
    if mip_u8:
        ks = tpack.bake_mip_u8(ks, ref.params)
    tpool = tpack.pack_pool_rgbe(ref.pool) if pool_rgbe else ref.pool
    tpf, tpi = tpack.build_params(ks, ref.params, RES, RES, 0, SPP)
    plain = megakernel.render(ks, tpool, tpf, tpi).numpy() / SPP
    return {"pallas": pallas, "plain": plain, "inputs": (ks, tpool, tpf, tpi),
            "reference": ref, "jax": (scene, params, cfg, packed, pool)}
