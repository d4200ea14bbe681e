"""The render kernel's per-sample step budget in its plain torch version
(``megakernel.render_plain``), on the CPU.

A sample that takes ``pi[PI_MAX_ITERS]`` march substeps without ending is
capped: it ends, adds nothing to its pixel's sum, and is counted in
``stats["capped"]``. The CUDA kernel caps the same samples
(tests/test_torch_cuda.py holds it to this version bitwise with the cap
binding). The Pallas kernel caps iterations per strip instead
(ROADMAP Queue 3).
"""

import pytest
import torch

from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment
from volren_tpu_torch.voldata import DenseGrid, Volume

RES, SPP, BUDGET = 16, 2, 12


@pytest.fixture(scope="module")
def scene(random_grid16):
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment.white(0.7))
    r.bounces = 8
    r.seed = 123
    r.init(RES, RES)
    r.commit()
    ks = r._kernel_scene()
    pool = tpack.build_env_pool(r._env_device, r.seed, 0)
    return ks, pool, r._trace_params()


def _render(scene, spp, spp_base=0, budget=None, stats=None):
    ks, pool, tp = scene
    pf, pi = tpack.build_params(ks, tp, RES, RES, spp_base, spp)
    if budget is not None:
        pi[tpack.PI_MAX_ITERS] = budget
    return megakernel.render_plain(ks, pool, pf, pi, stats=stats)


def test_step_budget_is_per_sample(scene):
    """Every dispatch gets the same budget, whatever its spp, no smaller
    than the Pallas kernel's cap of a 1-spp dispatch, (2048 + 512) * 8."""
    assert tpack.STEP_BUDGET >= (2048 + 512) * 8
    ks, _pool, tp = scene
    for spp in (1, 3, 64):
        _pf, pi = tpack.build_params(ks, tp, RES, RES, 0, spp)
        assert pi[tpack.PI_MAX_ITERS] == tpack.STEP_BUDGET


def test_capped_samples_are_counted_and_add_nothing(scene):
    """With a budget of 12 substeps, the samples that would run longer end
    with nothing added: each 1-spp dispatch equals the uncapped one except
    at its capped pixels, which stay exactly 0; the capped pixels are the
    ones counted; and the 2-spp dispatch is the in-order sum of its 1-spp
    dispatches."""
    stats = {}
    full = _render(scene, SPP, budget=BUDGET, stats=stats)
    assert stats["capped"] > 0
    acc = torch.zeros_like(full)
    n_capped = 0
    for k in range(SPP):
        capped = _render(scene, 1, spp_base=k, budget=BUDGET)
        free = _render(scene, 1, spp_base=k)
        differ = (capped != free).any(dim=1)
        assert bool((capped[differ] == 0).all())
        n_capped += int(differ.sum())
        acc = acc + capped
    assert n_capped == stats["capped"]
    assert torch.equal(full, acc)


def test_default_budget_caps_nothing(scene):
    stats = {}
    out = _render(scene, SPP, stats=stats)
    assert stats["capped"] == 0
    assert bool(torch.isfinite(out).all()) and float(out[:, 3].max()) == SPP
