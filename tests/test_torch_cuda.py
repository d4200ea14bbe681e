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


# ---- the probe kernels (volren_tpu_torch/csrc/probes.cu) against their
# plain versions on the same CUDA tensors: bitwise, except row_scan (a
# parallel scan adds in another order: rtol 1e-5)

def _probe_cases(dev):
    from volren_tpu_torch.ops.kernels import probes as K

    rng = np.random.default_rng(11)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tab_f = t(rng.random((3584, 128)).astype(np.float32))
    tab_i = t(rng.integers(0, 2 ** 20, (3584, 128)).astype(np.int32))
    x = t(rng.random((256, 512)).astype(np.float32))
    r = t(rng.integers(0, 3584, (8, 128)).astype(np.int32))
    c = t(rng.integers(0, 128, (8, 128)).astype(np.int32))
    u = t(rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32).astype(np.int64))
    v = t(rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32).astype(np.int64))
    big = t(rng.integers(0, 2 ** 31 - 1, (65536, 128)).astype(np.int32))
    base = t(rng.integers(0, 65536, (128,)).astype(np.int32))
    n_dev = t(np.array([37], np.int32))
    flat = t(np.arange(16384, dtype=np.float32) * 0.5)
    pos = t(rng.random((8, 128)).astype(np.float32))
    return {
        "affine_loop": (lambda f: f(x, 100, 1.0000001, 1e-6), K.affine_loop, K.affine_loop_plain),
        "affine_loop_dev": (lambda f: f(x, 0, 1.0000001, 1e-6, n_dev), K.affine_loop,
                            K.affine_loop_plain),
        "gather_rc_f32": (lambda f: f(tab_f, r, c), K.gather, K.gather_plain),
        "gather_rc_i32": (lambda f: f(tab_i, r, c), K.gather, K.gather_plain),
        "gather_1d_mod": (lambda f: f(flat, r, None, 2048), K.gather, K.gather_plain),
        "gather_rows": (lambda f: f(tab_f, r[:, :1].contiguous()), K.gather, K.gather_plain),
        "gather_cols": (lambda f: f(tab_f, None, c), K.gather, K.gather_plain),
        "lcg_row": (lambda f: f(tab_f, "row", (3584, 128), 5, 42, 7919), K.lcg_gather_sum,
                    K.lcg_gather_sum_plain),
        "lcg_rc_i32": (lambda f: f(tab_i, "rc", (8, 128), 9, 42, 7919), K.lcg_gather_sum,
                       K.lcg_gather_sum_plain),
        "lcg_flat": (lambda f: f(tab_f[:74].contiguous(), "flat", (8, 128), 9, 42, 7919),
                     K.lcg_gather_sum, K.lcg_gather_sum_plain),
        "carry30": (lambda f: f(tab_f[:74].contiguous(), 1, 40, (8, 128)), K.carry30,
                    K.carry30_plain),
        "march": (lambda f: f(tab_f, pos, u, 64), K.march, K.march_plain),
        "rounds_staged": (lambda f: f(base, big, "staged", 300, 128, False), K.row_gather_rounds,
                          K.row_gather_rounds_plain),
        "rounds_staged_n8": (lambda f: f(base, big, "staged", 300, 8, True), K.row_gather_rounds,
                             K.row_gather_rounds_plain),
        "rounds_direct": (lambda f: f(base, big, "direct", 300, 128, True), K.row_gather_rounds,
                          K.row_gather_rounds_plain),
        "rounds_stage": (lambda f: f(base, big, "stage", 300, 128, True), K.row_gather_rounds,
                         K.row_gather_rounds_plain),
        "rounds_ids": (lambda f: f(base, big, "ids", 300, 128, True), K.row_gather_rounds,
                       K.row_gather_rounds_plain),
        "rounds_stale": (lambda f: f(base, big, "stale", 300, 128, True), K.row_gather_rounds,
                         K.row_gather_rounds_plain),
        "transpose": (lambda f: f(x, "transpose"), K.index_copy, K.index_copy_plain),
        "tile_rows": (lambda f: f(x, "tile_rows", 4), K.index_copy, K.index_copy_plain),
        "roll_cols": (lambda f: f(x, "roll_cols", 3), K.index_copy, K.index_copy_plain),
        "broadcast_row0": (lambda f: f(x, "broadcast_row0", 3584), K.index_copy,
                           K.index_copy_plain),
        "iota_plus": (lambda f: f(x, "iota_plus", 3584), K.index_copy, K.index_copy_plain),
        "tea8": (lambda f: f(u, v), K.tea8, K.tea8_plain),
    }


PROBE_CASES = ("affine_loop", "affine_loop_dev", "gather_rc_f32", "gather_rc_i32",
               "gather_1d_mod", "gather_rows", "gather_cols", "lcg_row", "lcg_rc_i32",
               "lcg_flat", "carry30", "march", "rounds_staged", "rounds_staged_n8",
               "rounds_direct", "rounds_stage", "rounds_ids", "rounds_stale", "transpose",
               "tile_rows", "roll_cols", "broadcast_row0", "iota_plus", "tea8")


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_kernel_matches_plain_version(case):
    dev = _cuda()
    call, wrapper, plain = _probe_cases(dev)[case]
    before = wrapper.launches
    got = call(wrapper)
    assert wrapper.launches == before + 1
    want = call(plain)
    if isinstance(got, tuple):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert got.is_cuda and torch.equal(got, want), float((got.double() - want.double()).abs().max())


def test_probe_row_scan_matches_cumsum():
    from volren_tpu_torch.ops.kernels import probes as K

    x = torch.from_numpy(np.random.default_rng(0).random((8, 128), np.float32)).to(_cuda())
    before = K.row_scan.launches
    got = K.row_scan(x)
    assert K.row_scan.launches == before + 1
    torch.testing.assert_close(got, K.row_scan_plain(x), rtol=1e-5, atol=0)
