"""The CUDA megakernel on the card. Every test here skips without a CUDA
device. The module imports no JAX, so it also runs where JAX is absent,
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment, procedural_sky
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.voldata import DenseGrid, Volume

pytestmark = pytest.mark.cuda
SPP, RES = 8, 32


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grid16():
    rng = np.random.default_rng(7)
    dense = rng.random((16, 16, 16)).astype(np.float32) * 3.0
    dense[:4] = 0.0
    return dense


def _renderer(device, seed=123, tf=False, emission=False):
    """The 16^3 test scene; ``tf`` adds a non-monotone LUT with a moved
    window, ``emission`` a radial temperature grid at half resolution."""
    r = Renderer(device=device)
    r.volume = Volume(DenseGrid(16, 16, 16, _grid16()))
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(procedural_sky(64, 32, seed=4)))
    r.bounces = 16
    r.seed = seed
    if tf:
        lut = TransferFunction([(0.9, 0.2, 0.1, 0.1), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 0.4)])
        lut.window_left, lut.window_width = 0.05, 0.8
        r.set_transferfunc(lut)
    if emission:
        zz, yy, xx = np.meshgrid(*([np.arange(8)] * 3), indexing="ij")
        hot = np.clip(1.0 - np.sqrt((xx - 4) ** 2 + (yy - 4) ** 2 + (zz - 4) ** 2) / 4.0, 0, 1)
        r.volume.update_grid_frame(0, DenseGrid(8, 8, 8, hot ** 2, np.diag([2, 2, 2, 1])),
                                   "temperature")
        r.emission_scale = 30.0
    r.init(RES, RES)
    r.commit()
    return r


def _inputs(r, spp=SPP):
    ks = r._kernel_scene()
    pool = build_env_pool(r._env_device, r.seed, 0)
    pf, pi = build_params(ks, r._trace_params(), RES, RES, 0, spp)
    return ks, pool, pf, pi


def test_kernel_matches_plain_version():
    """Kernel vs plain version on the same CUDA tensors. The kernel is
    built without multiply-add contraction and repeats the plain
    version's operation order, so the two agree bitwise; the kernel is
    also bitwise identical run to run."""
    dev = _cuda()
    inputs = _inputs(_renderer(dev))
    before = megakernel.render.launches
    a = megakernel.render(*inputs)
    b = megakernel.render(*inputs)
    assert megakernel.render.launches == before + 2
    assert torch.equal(a, b)
    plain = megakernel.render_plain(*inputs)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, plain), float((a - plain).abs().max())


@pytest.mark.parametrize("tf,emission", [(True, False), (False, True), (True, True)],
                         ids=["tf", "emission", "tf+emission"])
def test_kernel_variant_matches_plain_version(tf, emission):
    """The TF, emission and TF+emission instantiations against the plain
    version on the same CUDA tensors (the TF one with its baked majorant
    table): bitwise, and bitwise run to run."""
    dev = _cuda()
    inputs = _inputs(_renderer(dev, tf=tf, emission=emission))
    before = dict(megakernel.render.launches_by_variant)
    a = megakernel.render(*inputs)
    b = megakernel.render(*inputs)
    after = megakernel.render.launches_by_variant
    assert after[(tf, emission)] == before.get((tf, emission), 0) + 2
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    plain = megakernel.render_plain(*inputs)
    assert torch.equal(a, plain), float((a - plain).abs().max())


@pytest.mark.parametrize("tf,emission", [(True, False), (False, True)], ids=["tf", "emission"])
def test_variant_renderer_on_card_launches_the_kernel(tf, emission):
    r = _renderer(_cuda(), tf=tf, emission=emission)
    before = megakernel.render.launches
    r.trace(3)
    assert r.last_engine == "cuda_kernel"
    assert megakernel.render.launches == before + 1
    fb = r.framebuffer()
    assert fb.is_cuda and bool(torch.isfinite(fb).all()) and float(fb[..., :3].mean()) > 0


def test_renderer_on_card_launches_the_kernel():
    r = _renderer(_cuda())
    before = megakernel.render.launches
    r.trace(3)
    assert r.last_engine == "cuda_kernel"
    assert megakernel.render.launches == before + 1
    fb = r.framebuffer()
    assert fb.is_cuda and bool(torch.isfinite(fb).all()) and float(fb[..., :3].mean()) > 0


def test_kernel_wrapper_rejects_bad_tables():
    ks, pool, pf, pi = _inputs(_renderer(_cuda()))
    with pytest.raises(ValueError):
        megakernel.render(ks._replace(lo=ks.lo.double()), pool, pf, pi)
    with pytest.raises(ValueError):
        megakernel.render(ks, pool[:, :7].contiguous(), pf, pi)
    with pytest.raises(ValueError):
        megakernel.render(ks._replace(slot=ks.slot.cpu()), pool, pf, pi)
    ks, pool, pf, pi = _inputs(_renderer(_cuda(), tf=True, emission=True))
    with pytest.raises(ValueError):
        megakernel.render(ks._replace(mip_tf=None), pool, pf, pi)
    with pytest.raises(ValueError):
        megakernel.render(ks._replace(emi_lo=ks.emi_lo[:-1].contiguous()), pool, pf, pi)
    with pytest.raises(ValueError):
        megakernel.render(ks._replace(tf=ks.tf._replace(lut=ks.tf.lut.double())), pool, pf, pi)
