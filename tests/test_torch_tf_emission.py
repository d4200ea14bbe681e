"""The TF + emission variant of the render kernel (volren_tpu kernel.py:635
and :636 together, the port's <1,1>) in volren_tpu_torch against
volren_tpu.

``--turbo`` on a VDB frame with a temperature grid reaches this variant
from the CLI. The scene is the radial flame of tests/test_torch_emission.py
(emission_scale 30, albedo 0.6) classified through the CLI's ``--fau``
LUT: the null-collision test classifies the exact trilinear density
through the LUT alpha (no tricubic draws), extend lanes then take the
emission grid's 9-draw tricubic tap, and the NEE tints the throughput by
the LUT colour. The plain torch version is held per pixel to the Pallas
kernel in interpret mode, and both to the chunked engine, with the bars of
tests/test_torch_{tf,emission}.py. The CUDA kernel runs only on the card:
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch_reference import SPP, jax_renderer, mean_rel, reference_case, rmse

from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu_torch.cli import FAU_LUT
from volren_tpu_torch.ops.kernels import megakernel

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(random_grid16):
    r = jax_renderer(random_grid16)
    zz, yy, xx = np.meshgrid(*([np.arange(16)] * 3), indexing="ij")
    dist = np.sqrt((xx - 8) ** 2 + (yy - 8) ** 2 + (zz - 8) ** 2)
    temp = np.clip(1.0 - dist / 8.0, 0.0, 1.0).astype(np.float32)
    r.volume.update_grid_frame(0, JDenseGrid(16, 16, 16, temp), "flame")
    r.set_transferfunc(JTransferFunction(FAU_LUT))
    r.commit()
    cfg = r._config()
    assert cfg.use_tf and cfg.has_emission
    r.emission_scale = 30.0
    r.albedo = np.full(3, 0.6, np.float32)
    return reference_case(r)


def test_tf_emission_plain_matches_pallas_kernel_per_pixel(case):
    """The TF resolve makes no draws and the emission tap's 9 draws sit at
    the same place of each stream in both versions: they differ only in f32
    rounding, and every pixel agrees to 1e-4. A draw out of place moves
    pixels by the noise, about 1e-1."""
    got, ref = case["plain"], case["pallas"]
    assert got.shape == (32 * 32, 4) and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err < 1e-4, err


def test_tf_emission_plain_and_pallas_match_chunked_engine(case):
    """Both the plain version and the Pallas kernel agree with the chunked
    engine within 1.5x its seed-to-seed noise, with the mean within 5%."""
    ref = case["chunked"][0]
    for name in ("plain", "pallas"):
        got = case[name]
        assert rmse(got, ref) < 1.5 * case["noise"], (name, rmse(got, ref), case["noise"])
        assert mean_rel(got, ref) < 0.05, (name, mean_rel(got, ref))


def test_tf_emission_glows_and_is_deterministic(case):
    """The flame adds light, redder than bluer; a second run of the plain
    version is bitwise the first and launches nothing."""
    ks, pool, pf, pi = case["inputs"]
    assert ks.tf is not None and ks.emi_atlas is not None
    before = megakernel.render.launches
    again = megakernel.render(*case["inputs"]).numpy() / SPP
    assert np.array_equal(again, case["plain"]) and megakernel.render.launches == before
    glow = case["plain"][:, 0] - case["plain"][:, 2]
    assert glow.max() > 0.05, glow.max()
