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
import torch
from torch_reference import SPP, jax_renderer, mean_rel, reference_case, rmse

from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels.pack import PI_SPP, PI_SPP_BASE

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(random_grid16):
    """The JAX scene of test_pallas (random 16^3 grid, white 0.7 sky,
    16 bounces), its reference images, and the same inputs in the port."""
    r = jax_renderer(random_grid16)
    r.commit()
    return reference_case(r)


def test_plain_matches_pallas_kernel(case):
    got, ref = case["plain"], case["pallas"]
    assert got.shape == (32 * 32, 4) and np.isfinite(got).all()
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_plain_matches_pallas_kernel_per_pixel(case):
    """Both draw the same random numbers in the same order and differ only
    in f32 rounding (atan2f/acosf against the Pallas minimax versions), so
    every pixel agrees to 1e-4; a change of draw order or of a constant
    moves pixels by the noise, about 1e-1."""
    err = np.abs(case["plain"] - case["pallas"]).max()
    assert err < 1e-4, err


def test_plain_matches_chunked_engine(case):
    got, ref = case["plain"], case["chunked"][0]
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_plain_is_deterministic_and_counts_no_launch(case):
    before = megakernel.render.launches
    again = megakernel.render(*case["inputs"]).numpy() / SPP
    assert np.array_equal(again, case["plain"])
    assert megakernel.render.launches == before


def test_dispatch_is_the_in_order_sum_of_one_spp_dispatches(case):
    """A sample's draws depend only on (pixel, spp_base + sample), and a
    pixel's sum adds its samples in sample order from 0.0: a 4-spp
    dispatch is bitwise the float32 sum, in order, of 4 1-spp dispatches
    with spp_base 0..3 on the same pool. The CUDA kernel's schedule, which
    traces a pixel's samples on different lanes, rests on this."""
    ks, pool, pf, pi = case["inputs"]
    spp = 4
    four = pi.copy()
    four[PI_SPP] = spp
    full = megakernel.render_plain(ks, pool, pf, four)
    acc = torch.zeros_like(full)
    for k in range(spp):
        one = pi.copy()
        one[PI_SPP], one[PI_SPP_BASE] = 1, k
        acc = acc + megakernel.render_plain(ks, pool, pf, one)
    assert torch.equal(full, acc)


def test_render_rejects_other_devices(case):
    ks, pool, pf, pi = case["inputs"]
    meta = ks._replace(atlas=ks.atlas.to("meta"))
    with pytest.raises(ValueError):
        megakernel.render(meta, pool, pf, pi)
