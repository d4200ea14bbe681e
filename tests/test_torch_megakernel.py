"""The render megakernel of volren_tpu_torch against volren_tpu.

The plain torch version (what ``megakernel.render`` runs on CPU tensors)
gets the JAX scene, NEE pool and trace parameters through
``ops.scene.from_reference`` and is held against the Pallas kernel
(``render_strips`` in interpret mode, f32 tables) and the chunked XLA
engine with the bar of tests/test_pallas.py: RMSE below 1.5x the chunked
engine's seed-to-seed noise, mean within 5%, bitwise run to run. Against
the Pallas kernel, which draws in the same order, every pixel must also
agree to 1e-4. The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

from volren_tpu.ops.megakernel import render_wavefront_chunked
from volren_tpu.ops.pallas import pack_scene as jpack_scene
from volren_tpu.ops.pallas.kernel import render_strips
from volren_tpu.ops.pallas.pack import build_env_pool as jbuild_env_pool
from volren_tpu.ops.pallas.pack import build_params_rows
from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.scene.environment import Environment as JEnvironment
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu.voldata import Volume as JVolume
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack

SPP, RES, SEED = 8, 32, 123


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def _mean_rel(a, b):
    return abs(a[:, :3].mean() - b[:, :3].mean()) / max(b[:, :3].mean(), 1e-9)


@pytest.fixture(scope="module")
def case(random_grid16):
    """The JAX scene of test_pallas (random 16^3 grid, white 0.7 sky,
    16 bounces), its reference images, and the same inputs in the port."""
    r = JRenderer()
    r.volume = JVolume(JDenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.set_environment(JEnvironment.white(0.7))
    r.bounces = 16
    r.seed = SEED
    r.init(RES, RES)
    r.commit()
    scene, params = r._scene_device(), r._trace_params()
    pool = jbuild_env_pool(scene, SEED, 0)
    pf, pi = build_params_rows(scene, params, RES, RES, 0)
    pallas = np.asarray(render_strips(
        jpack_scene(scene), pool, pf, pi, RES * RES, RES, SPP, interpret=True,
        queue_items=1024, env_rgbe=False, pool_rgbe=False, mip_u8=False)) / SPP
    cfg = r._config()._replace(use_onehot=False, env_nearest_nee=True)
    chunked = [np.asarray(render_wavefront_chunked(scene, params, cfg, RES, RES, SPP, base))
               .reshape(-1, 4) / SPP for base in (0, SPP)]

    g, e = scene.density, scene.env
    grid, env, pool_t, tp = tscene.from_reference(
        atlas=np.asarray(g.atlas), brick_meta=np.asarray(g.brick_meta),
        mip_maj=np.asarray(g.mip_maj), transform=np.asarray(g.transform),
        inv_transform=np.asarray(g.inv_transform), envmap=np.asarray(e.envmap),
        alias_packed=np.asarray(e.alias_packed), imp_avg=np.asarray(e.imp_mips[-1]),
        env_transform=np.asarray(e.transform), env_inv_transform=np.asarray(e.inv_transform),
        env_strength=np.asarray(e.strength), pool={k: np.asarray(v) for k, v in pool.items()},
        params={k: np.asarray(v) for k, v in params._asdict().items()})
    ks = tpack.pack_scene(grid, env)
    tpf, tpi = tpack.build_params(ks, tp, RES, RES, 0, SPP)
    return {"pallas": pallas, "chunked": chunked,
            "noise": _rmse(chunked[1], chunked[0]),
            "inputs": (ks, pool_t, tpf, tpi),
            "plain": megakernel.render(ks, pool_t, tpf, tpi).numpy() / SPP}


def test_plain_matches_pallas_kernel(case):
    got, ref = case["plain"], case["pallas"]
    assert got.shape == (RES * RES, 4) and np.isfinite(got).all()
    assert _rmse(got, ref) < 1.5 * case["noise"], (_rmse(got, ref), case["noise"])
    assert _mean_rel(got, ref) < 0.05


def test_plain_matches_pallas_kernel_per_pixel(case):
    """Both draw the same random numbers in the same order and differ only
    in f32 rounding (atan2f/acosf against the Pallas minimax versions), so
    every pixel agrees to 1e-4; a change of draw order or of a constant
    moves pixels by the noise, about 1e-1."""
    err = np.abs(case["plain"] - case["pallas"]).max()
    assert err < 1e-4, err


def test_plain_matches_chunked_engine(case):
    got, ref = case["plain"], case["chunked"][0]
    assert _rmse(got, ref) < 1.5 * case["noise"], (_rmse(got, ref), case["noise"])
    assert _mean_rel(got, ref) < 0.05


def test_plain_is_deterministic_and_counts_no_launch(case):
    before = megakernel.render.launches
    again = megakernel.render(*case["inputs"]).numpy() / SPP
    assert np.array_equal(again, case["plain"])
    assert megakernel.render.launches == before


def test_render_rejects_other_devices(case):
    ks, pool, pf, pi = case["inputs"]
    meta = ks._replace(atlas=ks.atlas.to("meta"))
    with pytest.raises(ValueError):
        megakernel.render(meta, pool, pf, pi)
