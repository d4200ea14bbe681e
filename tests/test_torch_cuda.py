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


def _renderer(device, seed=123):
    r = Renderer(device=device)
    r.volume = Volume(DenseGrid(16, 16, 16, _grid16()))
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(procedural_sky(64, 32, seed=4)))
    r.bounces = 16
    r.seed = seed
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
