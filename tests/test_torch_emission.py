"""The emission variant of the render kernel (volren_tpu kernel.py:636,
K3) in volren_tpu_torch against volren_tpu.

A frame's ``flame`` grid glows: after the density fetch and before the
classification draw, every extend lane's null-collision test takes a
stochastic-tricubic tap (9 draws) of the emission brick grid, reached
from the density index through the composed transform ``PF_EMI_X``, and
adds ``th * (1 - albedo) * emission_scale * (t^2, t^4, t^8) * d /
majorant`` to the path radiance. The scene is
tests/test_pallas.py::test_emission_kernel_matches_chunked's radial
flame, emission_scale 30, albedo 0.6. The plain torch version is held to
the Pallas kernel in interpret mode and to the chunked engine; the CUDA
kernel runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch_reference import SPP, jax_renderer, mean_rel, reference_case, rmse

from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(random_grid16):
    r = jax_renderer(random_grid16)
    zz, yy, xx = np.meshgrid(*([np.arange(16)] * 3), indexing="ij")
    dist = np.sqrt((xx - 8) ** 2 + (yy - 8) ** 2 + (zz - 8) ** 2)
    temp = np.clip(1.0 - dist / 8.0, 0.0, 1.0).astype(np.float32)
    r.volume.update_grid_frame(0, JDenseGrid(16, 16, 16, temp), "flame")
    r.commit()
    assert r._config().has_emission
    r.emission_scale = 30.0
    r.albedo = np.full(3, 0.6, np.float32)
    return reference_case(r)


def test_emission_plain_matches_pallas_kernel(case):
    got, ref = case["plain"], case["pallas"]
    assert got.shape == (32 * 32, 4) and np.isfinite(got).all()
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_emission_plain_matches_pallas_kernel_per_pixel(case):
    """Both versions draw the 9 emission draws at the same place in each
    stream and differ only in f32 rounding: every pixel agrees to 1e-4.
    A draw out of place moves pixels by the noise, about 1e-1."""
    err = np.abs(case["plain"] - case["pallas"]).max()
    assert err < 1e-4, err


def test_emission_plain_matches_chunked_engine(case):
    got, ref = case["plain"], case["chunked"][0]
    assert rmse(got, ref) < 1.5 * case["noise"], (rmse(got, ref), case["noise"])
    assert mean_rel(got, ref) < 0.05


def test_emission_plain_is_deterministic_and_counts_no_launch(case):
    before = megakernel.render.launches
    again = megakernel.render(*case["inputs"]).numpy() / SPP
    assert np.array_equal(again, case["plain"])
    assert megakernel.render.launches == before


def test_emission_glows(case):
    """The flame adds light, redder than bluer ((t^2, t^4, t^8) with t <=
    1). Under the white sky with a grey albedo the scene without its
    emission grid renders grey: red equals blue in every pixel."""
    ks, pool, pf, pi = case["inputs"]
    dark_ks = ks._replace(emi_atlas=None, emi_slot=None, emi_lo=None, emi_hi=None)
    dark_pf, dark_pi = pf.copy(), pi.copy()
    dark_pi[tpack.PI_EMI_N_SLOTS] = 0
    dark = megakernel.render(dark_ks, pool, dark_pf, dark_pi).numpy() / SPP
    assert np.array_equal(dark[:, 0], dark[:, 2])
    glow = case["plain"][:, 0] - case["plain"][:, 2]
    assert (glow >= 0).all() and glow.max() > 0.1
