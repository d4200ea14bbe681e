"""The TF variant of the render kernel (volren_tpu kernel.py:635, K2) in
volren_tpu_torch against volren_tpu.

A transfer function classifies the exact trilinear density through the
LUT alpha, tints the NEE throughput by the LUT colour, and bends the
majorant pyramid through the LUT alpha once per trace. The plain torch
version gets the JAX scene, its LUT and its own baked majorant table
through ``ops.scene.from_reference`` (a 1-ulp difference in that table
changes the free-flight steps and with them whole paths), and is held to
the Pallas kernel in interpret mode and the chunked engine with the bar
of tests/test_pallas.py::test_tf_kernel_matches_chunked. The port's own
bake is held to the JAX table separately. The CUDA kernel runs only on
the card: tests/test_torch_cuda.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_reference import SPP, jax_renderer, mean_rel, reference_case, rmse

from volren_tpu.ops.scene import TFDevice as JTFDevice
from volren_tpu.ops.transfer import tf_alpha_majorant as jtf_alpha_majorant
from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.ops.scene import TFTables

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

# the LUT of tests/test_pallas.py::test_tf_kernel_matches_chunked
LUT = [(0.9, 0.2, 0.1, 0.0), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 1.0)]


@pytest.fixture(scope="module")
def case(random_grid16):
    r = jax_renderer(random_grid16)
    r.set_transferfunc(JTransferFunction(LUT))
    r.commit()
    assert r._config().use_tf
    return reference_case(r)


def test_tf_plain_matches_pallas_kernel(case):
    got, ref = case["plain"], case["pallas"]
    assert got.shape == (32 * 32, 4) and np.isfinite(got).all()
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_tf_plain_matches_pallas_kernel_per_pixel(case):
    """The TF resolve makes no tricubic draws, so both versions draw the
    same numbers in the same order and differ only in f32 rounding: every
    pixel agrees to 1e-4. One misplaced draw moves pixels by the noise."""
    err = np.abs(case["plain"] - case["pallas"]).max()
    assert err < 1e-4, err


def test_tf_plain_matches_chunked_engine(case):
    got, ref = case["plain"], case["chunked"][0]
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_tf_plain_is_deterministic_and_counts_no_launch(case):
    before = megakernel.render.launches
    again = megakernel.render(*case["inputs"]).numpy() / SPP
    assert np.array_equal(again, case["plain"])
    assert megakernel.render.launches == before


def test_tf_majorant_bake_within_one_ulp(case):
    """pack.bake_tf_majorant repeats renderer._render_pallas's operation
    order; XLA may contract its multiply-adds, so the bar is 1 ulp."""
    ks, _pool, _pf, _pi = case["inputs"]
    ref = case["reference"]
    ours = tpack.bake_tf_majorant(ks._replace(mip_tf=None), ref.params).mip_tf.numpy()
    theirs = ref.mip_tf.numpy()
    assert ours.shape == theirs.shape and (theirs > 0).any()
    ulp = np.spacing(np.maximum(np.abs(theirs), np.finfo(np.float32).tiny))
    assert (np.abs(ours - theirs) <= ulp).all(), np.abs(ours - theirs).max()


def test_tf_render_needs_its_baked_table(case):
    ks, pool, pf, pi = case["inputs"]
    with pytest.raises(ValueError, match="baked"):
        megakernel.render(ks._replace(mip_tf=None), pool, pf, pi)
    with pytest.raises(ValueError, match="variant"):
        megakernel.render(ks._replace(tf=None), pool, pf, pi)


# a 4-bin LUT under the window [0.25, 0.75): its bin edges lie at densities
# 0.25 + k / 8, exact in binary
EDGE_LUT = np.array([(0.9, 0.2, 0.1, 0.1), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 0.4),
                     (0.5, 0.5, 0.5, 0.9)], np.float32)
EDGE_WINDOW = (0.25, 0.5)


def _edge_table(random_grid16, density_scale, inv_majorant):
    """The random 16^3 grid's values after EDGE_D's raw values: for each
    density d of EDGE_D (below, at and above the window's ends, every bin
    edge) the float32 raw value nearest d / (density_scale * inv_majorant)
    whose ``density_scale * raw * inv_majorant`` lands on d, where one
    does. Returns the table and the densities its first entries reach."""
    ds, inv = np.float32(density_scale), np.float32(inv_majorant)
    raw = []
    for d in EDGE_D:
        r = np.float32(np.float64(d) / (np.float64(ds) * np.float64(inv)))
        near, up, down = [r], r, r
        for _ in range(4):
            up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
            near += [up, down]
        raw.append(next((x for x in near if ds * x * inv == d), r))
    raw = np.array(raw, np.float32)
    return np.concatenate([raw, random_grid16.reshape(-1) / 3.0]).astype(np.float32), ds * raw * inv


EDGE_D = np.array([0.0, 0.1, 0.25, 0.375, 0.5, 0.625, 0.75, 0.9, 2.0, 1e-30, 0.7499999],
                  np.float32)


@pytest.mark.parametrize("density_scale,majorant", [(1.0, 1.0), (0.5, 1.0), (2.0, 4.0),
                                                    (2.75, 5.5)],
                         ids=["scale1", "scale0.5", "scale2", "scale2.75"])
def test_tf_majorant_bake_bitwise_at_the_window_edges(random_grid16, density_scale, majorant):
    """pack.bake_tf_majorant_plain against renderer._render_pallas's bake
    (``majorant * tf_alpha_majorant(tf, density_scale * raw * inv_majorant,
    onehot=False)``) on a table whose entries fall below, on and above the
    window's ends and on every bin edge, at four density_scales: bitwise.
    The wrapper on CPU tensors is the plain version and launches nothing."""
    ds, maj = np.float32(density_scale), np.float32(majorant)
    inv = np.float32(1.0) / maj
    raw, d = _edge_table(random_grid16, ds, inv)
    if majorant in (1.0, 4.0):      # powers of two: every density is reached exactly
        assert np.array_equal(d, EDGE_D)
    left, width = (np.float32(v) for v in EDGE_WINDOW)
    jtf = JTFDevice(lut=jnp.asarray(EDGE_LUT), window_left=jnp.float32(left),
                    window_width=jnp.float32(width), alpha_oh=None)
    jp = SimpleNamespace(density_scale=jnp.float32(ds), majorant=jnp.float32(maj),
                         inv_majorant=jnp.float32(inv))
    theirs = np.asarray(jp.majorant * jtf_alpha_majorant(
        jtf, jp.density_scale * jnp.asarray(raw) * jp.inv_majorant, onehot=False))
    tf = TFTables(lut=torch.as_tensor(EDGE_LUT), window_left=float(left),
                  window_width=float(width))
    params = SimpleNamespace(density_scale=float(ds), majorant=float(maj),
                             inv_majorant=float(inv))
    ours = tpack.bake_tf_majorant_plain(torch.as_tensor(raw), tf, params)
    assert ours.dtype == torch.float32 and np.array_equal(ours.numpy(), theirs), \
        np.abs(ours.numpy() - theirs).max()
    alpha = EDGE_LUT[:, 3] * maj
    # below and at the left end: bin 0; above the right end: the last bin;
    # on an edge: that bin's own alpha
    for k, a in ((0, alpha[0]), (2, alpha[0]), (8, alpha[3]), (3, alpha[1]), (4, alpha[2]),
                 (5, alpha[3])):
        if d[k] == EDGE_D[k]:
            assert ours[k] == a, (k, float(ours[k]), a)
    before = megakernel.bake_tf_majorant.launches
    got = megakernel.bake_tf_majorant(torch.as_tensor(raw), tf, params)
    assert torch.equal(got, ours) and megakernel.bake_tf_majorant.launches == before


def test_tf_majorant_bake_wrapper_on_the_cpu_is_the_plain_version(case):
    """pack.bake_tf_majorant on CPU tables is the plain version of the
    frame's raw pyramid, and megakernel.bake_tf_majorant launches nothing."""
    ks, _pool, _pf, _pi = case["inputs"]
    params = case["reference"].params
    before = megakernel.bake_tf_majorant.launches
    baked = tpack.bake_tf_majorant(ks._replace(mip_tf=None), params)
    want = tpack.bake_tf_majorant_plain(ks.mip, ks.tf, params)
    assert torch.equal(baked.mip_tf, want) and torch.equal(
        megakernel.bake_tf_majorant(ks.mip, ks.tf, params), want)
    assert megakernel.bake_tf_majorant.launches == before
