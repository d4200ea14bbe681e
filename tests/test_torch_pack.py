"""Scene upload and kernel tables of volren_tpu_torch against volren_tpu:
decoded density, majorant pyramid, alias table and the NEE pool."""

import numpy as np
import pytest
import torch

from volren_tpu.ops import scene as jscene
from volren_tpu.ops.pallas import pack as jpack
from volren_tpu.scene.environment import Environment as JEnvironment
from volren_tpu.voldata.brick import build_brick_grid as jbuild
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.scene.environment import Environment, procedural_sky
from volren_tpu_torch.voldata.brick import build_brick_grid


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(9)
    dense = rng.random((20, 24, 40)).astype(np.float32) * 3.0
    dense[:, :8] = 0.0
    xform = np.diag([0.5, 0.5, 0.5, 1.0]).astype(np.float32)
    ours = tscene.upload_grid(build_brick_grid(dense), xform, "cpu")
    theirs = jscene.upload_grid(jbuild(dense, use_native=False), xform)
    return ours, theirs


@pytest.fixture(scope="module")
def envs():
    img = procedural_sky(64, 32, seed=4)
    ours = tscene.upload_environment(Environment(img), "cpu")
    jenv = JEnvironment(img)
    jenv.strength = 1.0
    theirs = jscene.upload_environment(jenv)
    return ours, theirs


def test_grid_tables_match(grids):
    ours, theirs = grids
    meta = np.asarray(theirs.brick_meta)
    assert np.array_equal(ours.slot.numpy(), meta[..., 0].reshape(-1).astype(np.int32))
    assert np.array_equal(ours.lo.numpy(), meta[..., 1].reshape(-1))
    assert np.array_equal(ours.hi.numpy(), meta[..., 2].reshape(-1))
    assert np.array_equal(ours.mip_maj.numpy(), np.asarray(theirs.mip_maj))
    assert np.array_equal(ours.atlas.numpy(), np.asarray(theirs.atlas))
    assert np.array_equal(ours.inv_transform, np.asarray(theirs.inv_transform))
    assert ours.n_bricks == tuple(theirs.n_bricks)
    assert [tuple(d) for d in ours.mip_dims] == [tuple(d) for d in theirs.mip_dims]
    assert list(ours.mip_offsets) == list(theirs.mip_offsets)


def test_decoded_density_matches_dense_decode(grids, envs):
    ours, theirs = grids
    ks = tpack.pack_scene(ours, envs[0])
    bx, by, bz = ours.n_bricks
    ref, _ = jscene._decode_dense_jit(theirs.atlas, theirs.brick_meta, bz, by, bx, False)
    assert np.array_equal(tpack.decode_dense(ks).numpy(), np.asarray(ref))


def test_alias_table_bitwise():
    rng = np.random.default_rng(3)
    w = rng.random(4096) ** 4
    w[::7] = 0.0
    for weights in (w, np.zeros(16), np.ones(9)):
        p1, a1 = tscene.build_alias_table(weights)
        p2, a2 = jscene.build_alias_table(weights)
        assert np.array_equal(p1, p2) and np.array_equal(a1, a2)


def test_environment_tables_match(envs):
    ours, theirs = envs
    assert np.array_equal(ours.alias_packed.numpy(), np.asarray(theirs.alias_packed))
    assert np.array_equal(ours.envmap.numpy(), np.asarray(theirs.envmap)[..., :3])
    assert ours.imp_avg == float(np.asarray(theirs.imp_mips[-1]).reshape(()))
    assert np.array_equal(ours.inv_transform, np.asarray(theirs.inv_transform))


@pytest.mark.parametrize("seed,spp_base", [(123, 0), (7, 64)])
def test_env_pool_matches(envs, seed, spp_base):
    ours, theirs = envs
    scene = jscene.SceneDevice(density=None, emission=None, env=theirs, tf=None)
    ref = jpack.build_env_pool(scene, seed, spp_base)
    pool = tpack.build_env_pool(ours, seed, spp_base).numpy()
    assert pool.shape == (tpack.POOL_N, 8)
    assert np.array_equal(pool[:, 3], np.asarray(ref["pdf"]).reshape(-1))
    for col, key in enumerate(("wx", "wy", "wz")):
        assert np.allclose(pool[:, col], np.asarray(ref[key]).reshape(-1), rtol=0, atol=1e-6)
    for col, key in zip((4, 5, 6), ("ler", "leg", "leb")):
        assert np.allclose(pool[:, col], np.asarray(ref[key]).reshape(-1), rtol=1e-6, atol=0)
    assert not pool[:, 7].any()


def test_params_block_layout(grids, envs):
    ks = tpack.pack_scene(grids[0], envs[0])
    tp = tscene.TraceParams(
        cam_pos=np.array([1, 0, 1], np.float32), cam_transform=np.eye(3, dtype=np.float32),
        cam_fov=70.0, bb_min=np.full(3, -0.5, np.float32), bb_max=np.full(3, 0.5, np.float32),
        majorant=2.0, inv_majorant=0.5, albedo=np.full(3, 0.9, np.float32), phase_g=0.3,
        density_scale=4.0, bounces=12, show_environment=1, seed=0xDEADBEEF)
    pf, pi = tpack.build_params(ks, tp, 48, 32, 5, 3)
    assert pf.dtype == np.float32 and pf.shape == (tpack.PF_SIZE,)
    assert pi.dtype == np.int32 and pi.shape == (tpack.PI_SIZE,)
    assert np.asarray(pi[tpack.PI_SEED]).view(np.uint32) == 0xDEADBEEF
    assert pf[tpack.PF_ZCAM] == pytest.approx(-0.5 / np.tan(np.radians(35.0)), rel=1e-6)
    assert tuple(pi[tpack.PI_N_BRICKS:tpack.PI_N_BRICKS + 3]) == ks.n_bricks
    assert pi[tpack.PI_MAX_ITERS] == tpack.STEP_BUDGET == (2048 + 512) * 8
    assert torch.equal(ks.env, envs[0].envmap.reshape(-1, 3))


@pytest.fixture(scope="module")
def tf_emission_scene(random_grid16):
    """A JAX scene with a transfer function (moved window) and an emission
    grid on another index grid, and the same scene in the port."""
    from torch_reference import jax_renderer, port_inputs

    from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
    from volren_tpu.voldata import DenseGrid as JDenseGrid

    r = jax_renderer(random_grid16)
    tf = JTransferFunction([(0.9, 0.2, 0.1, 0.3), (0.2, 0.9, 0.6, 0.1), (1.0, 1.0, 1.0, 0.9)])
    tf.window_left, tf.window_width = 0.2, 0.6
    r.set_transferfunc(tf)
    temp = np.random.default_rng(4).random((8, 8, 8)).astype(np.float32) * 2.0
    r.volume.update_grid_frame(0, JDenseGrid(8, 8, 8, temp, np.diag([2, 2, 2, 1])), "temperature")
    r.emission_scale = 7.0
    r.commit()
    scene, params = r._scene_device(), r._trace_params()
    pool = jpack.build_env_pool(scene, 5, 0)
    return scene, params, port_inputs(scene, params, pool)


def test_from_reference_takes_tf_and_emission(tf_emission_scene):
    scene, params, (ref, ks, _pf, _pi) = tf_emission_scene
    assert np.array_equal(ref.tf.lut.numpy(), np.asarray(scene.tf.lut))
    assert (ref.tf.window_left, ref.tf.window_width) == (
        float(np.float32(0.2)), float(np.float32(0.6)))
    assert (np.diff(ref.tf.lut.numpy()[:, 3]) >= 0).all()   # the CDF rewrite
    e, meta = ref.emission, np.asarray(scene.emission.brick_meta)
    assert np.array_equal(e.atlas.numpy(), np.asarray(scene.emission.atlas))
    assert np.array_equal(e.slot.numpy(), meta[..., 0].reshape(-1).astype(np.int32))
    assert np.array_equal(e.hi.numpy(), meta[..., 2].reshape(-1))
    assert e.n_bricks == tuple(scene.emission.n_bricks) == ks.emi_n_bricks == (1, 1, 1)
    assert ref.params.emission_scale == 7.0
    assert ref.params.emission_norm == float(np.asarray(params.emission_norm)) != 1.0
    assert ref.mip_tf is None and ks.mip_tf is None


def test_params_slots_of_tf_and_emission_match_reference(tf_emission_scene):
    """build_params' TF and emission slots against build_params_rows' row:
    the window, the emission scale and norm, and the composed
    density-index -> emission-index transform (here diag(1/2))."""
    scene, params, (_ref, ks, pf, pi) = tf_emission_scene
    jpf = np.asarray(jpack.build_params_rows(scene, params, 32, 32, 0)[0]).reshape(-1)
    for ours, theirs in ((tpack.PF_TF_LEFT, jpack.PF_TF_LEFT),
                         (tpack.PF_TF_WIDTH, jpack.PF_TF_WIDTH),
                         (tpack.PF_EMI_SCALE, jpack.PF_EMI_SCALE),
                         (tpack.PF_EMI_NORM, jpack.PF_EMI_NORM),
                         (tpack.PF_MAJORANT, jpack.PF_MAJORANT),
                         (tpack.PF_INV_MAJORANT, jpack.PF_INV_MAJORANT)):
        assert pf[ours] == jpf[theirs], ours
    emi_x = pf[tpack.PF_EMI_X:tpack.PF_EMI_X + 16]
    assert np.array_equal(emi_x, jpf[jpack.PF_EMI_X:jpack.PF_EMI_X + 16])
    assert np.array_equal(emi_x.reshape(4, 4)[:3, :3], np.eye(3) * 0.5)
    assert pi[tpack.PI_TF_SIZE] == 3
    assert tuple(pi[tpack.PI_EMI_N_BRICKS:tpack.PI_EMI_N_BRICKS + 3]) == (1, 1, 1)
    assert pi[tpack.PI_EMI_N_SLOTS] == scene.emission.atlas.shape[0] == ks.emi_atlas.shape[0]
