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

import numpy as np
import pytest
import torch
from torch_reference import SPP, jax_renderer, mean_rel, reference_case, rmse

from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack

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
