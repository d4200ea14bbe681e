"""The CUDA megakernel on the card. Every test here skips without a CUDA
device. The module imports no JAX, so it also runs where JAX is absent,
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels.pack import (PI_MAX_ITERS, PI_ROW0, PI_ROWS, build_env_pool,
                                               build_params)
from volren_tpu_torch.renderer import DISPATCH_SPP, Renderer
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


def _renderer(device, seed=123, tf=False, emission=False, width=RES, height=RES, env=None,
              dense=None):
    """The 16^3 test scene; ``tf`` adds a non-monotone LUT with a moved
    window, ``emission`` a radial temperature grid at half resolution.
    ``env``: the scene's sky, Environment(procedural_sky(64, 32, seed=4)),
    if made already; ``dense``: a 16^3 density grid in place of the
    random one."""
    r = Renderer(device=device)
    r.volume = Volume(DenseGrid(16, 16, 16, _grid16() if dense is None else dense))
    r.scale_and_move_to_unit_cube()
    r.set_environment(env or Environment(procedural_sky(64, 32, seed=4)))
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
    r.init(width, height)
    r.commit()
    return r


def _inputs(r, spp=SPP):
    ks = r._kernel_scene()
    pool = build_env_pool(r._env_device, r.seed, 0)
    pf, pi = build_params(ks, r._trace_params(), r._width, r._height, 0, spp)
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


VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["plain", "tf", "emission", "tf+emission"]


@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
def test_kernel_matches_plain_version_with_the_cap_binding(tf, emission):
    """A budget of 40 march substeps a sample caps many samples of the 16^3
    scene: the kernel still equals the plain version bitwise (a capped
    sample adds nothing in both), and its STATS instantiation counts the
    capped samples the plain version counts."""
    ks, pool, pf, pi = _inputs(_renderer(_cuda(), tf=tf, emission=emission))
    pi = pi.copy()
    pi[PI_MAX_ITERS] = 40
    got = megakernel.render(ks, pool, pf, pi)
    stats = {}
    plain = megakernel.render_plain(ks, pool, pf, pi, stats=stats)
    assert stats["capped"] > 0
    assert torch.equal(got, plain), float((got - plain).abs().max())
    again, counters = megakernel.render_stats(ks, pool, pf, pi)
    assert torch.equal(again, got)
    assert {k: counters[k] for k in stats} == stats
    assert counters["regen"] == RES * RES * SPP


@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("spp", [1, 3, 4, 16, 33, 64, 130])
def test_kernel_matches_plain_version_at_ragged_shapes(spp, tf, emission):
    """37 x 23 pixels cut every group tile at the image's edge; 1, 3, 4
    and 16 spp spread several pixels over a warp (16: a 2 x 1 tile), 33 and
    64 one pixel, 64 (the main path's dispatch) fills the warp's result
    slots in one round and 130 takes three rounds. Every variant, bitwise
    equal to the plain version and bitwise identical run to run."""
    r = _renderer(_cuda(), tf=tf, emission=emission, width=37, height=23)
    inputs = _inputs(r, spp=spp)
    a = megakernel.render(*inputs)
    b = megakernel.render(*inputs)
    assert a.shape == (37 * 23, 4) and torch.equal(a, b)
    plain = megakernel.render_plain(*inputs)
    assert torch.equal(a, plain), float((a - plain).abs().max())


# the packed tables of a dispatch, (mip_u8, env_rgbe, pool_rgbe): each
# alone and the u8 pyramid with either RGBE read (the RGBE reads are flags
# of the <MIP_U8> and the f32-pyramid instantiations) and all three (both
# RGBE reads at compile time)
PACK_SETS = [(True, False, False), (False, True, False), (False, False, True),
             (True, True, False), (True, False, True), (True, True, True)]
PACK_IDS = ["u8", "env_rgbe", "pool_rgbe", "u8_env_rgbe", "u8_pool_rgbe", "all"]


def _packed_inputs(r, packs, spp=SPP):
    """The renderer's dispatch with its packed-table switches set to
    ``packs``: the tables, the pool and the parameter block of a trace."""
    r.pallas_mip_u8 = "1" if packs[0] else "0"
    r.pallas_env_rgbe, r.pallas_pool_rgbe = packs[1], packs[2]
    ks = r._kernel_scene()
    pf, pi = build_params(ks, r._trace_params(), r._width, r._height, 0, spp)
    return ks, r._env_pool(0), pf, pi


@pytest.mark.parametrize("packs", PACK_SETS, ids=PACK_IDS)
@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("spp", [3, 70])
def test_packed_kernel_matches_plain_version_at_ragged_shapes(spp, tf, emission, packs):
    """Every packed instantiation, with each of its RGBE flags, in every
    variant, at 37 x 23 with 3 spp (several pixels a warp) and 70 (two
    rounds of a warp's slots), the u8 pyramid's (lo, scale) read from the
    device buffer its build kernel wrote: the image bitwise the plain
    version's and bitwise run to run, launched as its own instantiation;
    its STATS twin renders the same image and counts the events (and on a
    u8 pyramid the march substeps at each level) the plain version counts."""
    r = _renderer(_cuda(), tf=tf, emission=emission, width=37, height=23)
    inputs = _packed_inputs(r, packs, spp)
    key = (tf, emission) + packs
    before = megakernel.render.launches_by_packs.get(key, 0)
    a = megakernel.render(*inputs)
    b = megakernel.render(*inputs)
    assert megakernel.render.launches_by_packs[key] == before + 2
    assert a.shape == (37 * 23, 4) and torch.equal(a, b) and bool(torch.isfinite(a).all())
    stats = {}
    plain = megakernel.render_plain(*inputs, stats=stats)
    assert torch.equal(a, plain), float((a - plain).abs().max())
    again, counters = megakernel.render_stats(*inputs)
    assert torch.equal(again, a) and {k: counters[k] for k in stats} == stats
    levels = [k for k in megakernel.LEVEL_COUNTS if k in counters]
    assert levels == (list(megakernel.LEVEL_COUNTS) if packs[0] else [])
    assert sum(counters[k] for k in levels) == (counters["march"] if packs[0] else 0)


def _ragged_levels(dev, rng):
    """A flat pyramid of 4 levels of ragged sizes, with a level of one
    value and a level of zeros (dims, offsets): every case of the build."""
    dims = ((7, 5, 13), (4, 3, 7), (2, 2, 4), (1, 1, 2))
    counts = [int(np.prod(d)) for d in dims]
    offs = tuple(int(v) for v in np.cumsum([0] + counts[:-1]))
    mip = (rng.random(sum(counts)) ** 3 * 40.0).astype(np.float32)
    mip[offs[1]:offs[1] + 9] = 0.0            # exact zeros where the level's minimum is 0
    mip[offs[2]:offs[3]] = 2.5                # a level of one value: scale 0
    mip[offs[3]:] = 0.0                       # a level of zeros
    return torch.as_tensor(mip, device=dev), dims, offs


def _build_cases(dev):
    """(label, mip, dims, offsets, scale) at ragged level sizes, the random
    16^3 scene's pyramid (density_scale and TF-baked) and cloud512's."""
    rng = np.random.default_rng(5)
    ragged = _ragged_levels(dev, rng)
    yield "ragged", *ragged, None
    yield "ragged x0.7", *ragged, 0.7
    tiny = torch.as_tensor(rng.random(4).astype(np.float32), device=dev)
    yield "one entry a level", tiny, ((1, 1, 1),) * 4, (0, 1, 2, 3), None
    for tf in (False, True):
        r = _renderer(dev, tf=tf)
        ks, tp = r._kernel_scene(), r._trace_params()
        if tf:
            yield "random16 TF-baked", ks.mip_tf, ks.mip_dims, ks.mip_offsets, None
        else:
            yield "random16", ks.mip, ks.mip_dims, ks.mip_offsets, tp.density_scale
    r = _cloud512(dev)
    ks, tp = r._kernel_scene(), r._trace_params()
    yield "cloud512", ks.mip, ks.mip_dims, ks.mip_offsets, tp.density_scale
    # a view 4 bytes past an allocation: the build's loads cannot be 16 bytes wide
    shifted = torch.empty(ks.mip.numel() + 1, dtype=torch.float32, device=dev)[1:]
    shifted.copy_(ks.mip)
    yield "cloud512, an unaligned view", shifted, ks.mip_dims, ks.mip_offsets, tp.density_scale
    # a 1024 x 1024 x 512 volume's pyramid: more entries than the build's
    # cluster holds in registers
    dims = ((64, 128, 128), (32, 64, 64), (16, 32, 32), (8, 16, 16))
    counts = [int(np.prod(d)) for d in dims]
    offs = tuple(int(v) for v in np.cumsum([0] + counts[:-1]))
    large = torch.as_tensor((rng.random(sum(counts)) ** 4 * 12.0).astype(np.float32), device=dev)
    yield "1,198,080 entries", large, dims, offs, None
    yield "1,198,080 entries x0.7", large, dims, offs, 0.7


def _cloud512(dev, tf=False):
    """cloud512 in a committed 16 x 16 Renderer (the --fau LUT with ``tf``)."""
    import os

    from volren_tpu_torch.cli import FAU_LUT

    cloud = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         ".scene_cache", "cloud512.brick")
    r = Renderer(device=dev)
    r.volume = Volume(cloud)
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(procedural_sky(64, 32, seed=4)))
    if tf:
        r.set_transferfunc(TransferFunction(FAU_LUT))
    r.init(16, 16)
    r.commit()
    return r


def test_device_build_mip_u8_is_the_plain_build():
    """The u8 pyramid's build kernel against pack.build_mip_u8 (torch ops on
    the same CUDA tensors) at ragged level sizes (offsets no multiples of
    4), with a level of one value (scale 0), a level of zeros and exact
    zeros, one entry a level, with and without a density_scale factor, on
    the test scene's pyramid and its TF-baked one, on cloud512's (also from
    an unaligned view) and on a pyramid of 1,198,080 entries: bytes and
    (lo, scale) rows bitwise, one launch each, the rows left on the card."""
    from volren_tpu_torch.ops.kernels.pack import build_mip_u8

    dev = _cuda()
    for label, mip, dims, offs, scale in _build_cases(dev):
        before = megakernel.build_mip_u8.launches
        q, dq = megakernel.build_mip_u8(mip, dims, offs, scale)
        assert megakernel.build_mip_u8.launches == before + 1, label
        base = mip if scale is None else mip * torch.tensor(float(scale), device=dev)
        want_q, lo, sc = build_mip_u8(base, dims, offs)
        assert q.device == dq.device == mip.device and dq.shape == (2, 4)
        assert torch.equal(q, want_q), (label, int((q != want_q).sum()))
        assert torch.equal(dq, torch.stack([lo, sc])), (label, dq, lo, sc)


def test_bake_mip_u8_makes_no_host_sync():
    """A trace with pallas_mip_u8 = "1" bakes the u8 pyramid with one launch
    of the build kernel and no host sync (torch's sync debug mode raises on
    one), for the plain and the TF scene, and renders as the plain version."""
    from volren_tpu_torch.ops.kernels import pack

    dev = _cuda()
    for tf in (False, True):
        r = _renderer(dev, tf=tf)
        r.pallas_mip_u8 = "1"
        r._kernel_scene()                     # the frame's tables, packed once
        tp, ks = r._trace_params(), r._packed[1]
        if tf:
            ks = pack.bake_tf_majorant(ks, tp)
        torch.cuda.synchronize()
        before = megakernel.build_mip_u8.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            baked = pack.bake_mip_u8(ks, tp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert megakernel.build_mip_u8.launches == before + 1
        assert baked.mip_dq.is_cuda and baked.mip_u8.is_cuda
        r.trace(3)
        assert megakernel.build_mip_u8.launches == before + 2
        inputs = _packed_inputs(r, (True, False, False), 3)
        assert torch.equal(megakernel.render(*inputs), megakernel.render_plain(*inputs))


def test_build_mip_u8_allocates_only_its_outputs():
    """A build allocates its bytes and its (2, 4) rows and nothing else (no
    scratch), and makes no host sync."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    mip, dims, offs = _ragged_levels(dev, rng)
    megakernel.build_mip_u8(mip, dims, offs)            # the library, loaded
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        megakernel.build_mip_u8(mip, dims, offs, 0.7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] - before == 2


# the bake's cases: cloud512 and the random 16^3 grid, the --fau LUT or a
# 4-bin LUT under the window [0.25, 0.75), whose ends clamp entries of both
BAKE_SCENES = ["cloud512", "random16"]
BAKE_LUTS = ["fau", "edge window"]


def _bake_case(dev, scene, lut):
    from volren_tpu_torch.ops import scene as tscene

    r = _cloud512(dev, tf=True) if scene == "cloud512" else _renderer(dev, tf=True)
    ks, tp = r._kernel_scene(), r._trace_params()
    tf = ks.tf
    if lut == "edge window":
        edge = TransferFunction([(0.9, 0.2, 0.1, 0.1), (0.2, 0.9, 0.6, 0.7),
                                 (1.0, 1.0, 1.0, 0.4), (0.5, 0.5, 0.5, 0.9)])
        edge.window_left, edge.window_width = 0.25, 0.5
        tf = tscene.upload_transferfunc(edge, dev)
    return ks.mip, tf, tp


@pytest.mark.parametrize("lut", BAKE_LUTS)
@pytest.mark.parametrize("scene", BAKE_SCENES)
def test_bake_tf_majorant_kernel_is_the_plain_version(scene, lut):
    """The TF majorant's bake kernel against pack.bake_tf_majorant_plain
    (torch ops on the same CUDA tensors, the window divided as the kernel
    divides): bitwise, one launch; with the edge window some entries clamp
    at its upper end and, on cloud512 (whose empty bricks' majorant is 0),
    at its lower end (the random grid's 11 entries all lie above it)."""
    from volren_tpu_torch.ops.kernels import pack
    from volren_tpu_torch.ops.transfer import WINDOW_MAX

    dev = _cuda()
    mip, tf, tp = _bake_case(dev, scene, lut)
    before = megakernel.bake_tf_majorant.launches
    got = megakernel.bake_tf_majorant(mip, tf, tp)
    assert megakernel.bake_tf_majorant.launches == before + 1
    want = pack.bake_tf_majorant_plain(mip, tf, tp)
    assert got.shape == mip.shape and got.is_cuda and bool(torch.isfinite(got).all())
    assert torch.equal(got, want), float((got - want).abs().max())
    if lut == "edge window":
        d = (mip * float(tp.density_scale) * float(tp.inv_majorant) - tf.window_left) \
            / tf.window_width
        assert bool((d >= WINDOW_MAX).any()) and (scene != "cloud512" or bool((d <= 0.0).any()))


@pytest.mark.parametrize("mip_u8", ["0", "1"])
def test_bake_tf_majorant_once_a_trace_with_no_host_sync(mip_u8):
    """A TF trace bakes its majorant table with one launch of the bake
    kernel (and, with the u8 pyramid, one of the build kernel) and no host
    sync: the kernel scene of a trace is set up under torch's sync debug
    mode "error". A trace(3) then launches each once, and the baked table
    is the plain version's."""
    from volren_tpu_torch.ops.kernels import pack

    dev = _cuda()
    r = _renderer(dev, tf=True)
    r.pallas_mip_u8 = mip_u8
    r._kernel_scene()                     # the frame's tables, packed once
    torch.cuda.synchronize()
    bakes, builds = megakernel.bake_tf_majorant.launches, megakernel.build_mip_u8.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        ks = r._kernel_scene()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    u8 = mip_u8 == "1"
    assert megakernel.bake_tf_majorant.launches == bakes + 1
    assert megakernel.build_mip_u8.launches == builds + u8
    assert torch.equal(ks.mip_tf, pack.bake_tf_majorant_plain(ks.mip, ks.tf, r._trace_params()))
    r.trace(3)
    assert megakernel.bake_tf_majorant.launches == bakes + 2
    assert megakernel.build_mip_u8.launches == builds + 2 * u8


def test_device_pack_pool_rgbe_is_the_plain_pack():
    """The packed pool from one launch of the encode kernel (its [w, pdf]
    rows and its radiance words) against the plain version's rows and
    words, bitwise."""
    from volren_tpu_torch.ops.kernels import pack

    dev = _cuda()
    pool = build_env_pool(_renderer(dev)._env_device, 3, 64)
    before = megakernel.rgbe_encode.launches
    got = pack.pack_pool_rgbe(pool)
    assert megakernel.rgbe_encode.launches == before + 1
    n = pack.POOL_N
    rows = pool[:, :4].contiguous().view(torch.int32).reshape(-1)
    assert got.dtype == torch.int32 and got.shape == (5 * n,)
    assert torch.equal(got[:4 * n], rows)
    assert torch.equal(got[4 * n:], pack.rgbe_encode_plain(pool[:, 4:7]))


def _rotated_sky(strength=2.75):
    """The test sky under a rotation that mixes all three axes, at a
    strength other than 1."""
    a, b, c = np.radians([30.0, -50.0, 75.0])
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    env = Environment(procedural_sky(64, 32, seed=4))
    env.transform, env.strength = (rz @ ry @ rx).astype(np.float32), strength
    return env


@pytest.mark.parametrize("rgbe", [False, True], ids=["f32", "packed"])
@pytest.mark.parametrize("seed,spp_base", [(123, 0), (7, 64), (2024, 192)])
def test_env_pool_kernel_is_the_plain_version(seed, spp_base, rgbe):
    """The NEE pool's draw kernel against its plain version
    (pack.env_pool_plain, torch ops) on the same CUDA uniforms, under a
    rotated sky at strength 2.75, bitwise, in one launch; build_env_pool
    is the same pool."""
    from volren_tpu_torch.ops.kernels import pack

    dev = _cuda()
    env = _renderer(dev, env=_rotated_sky())._env_device
    u2 = pack.pool_uniforms(seed, spp_base, dev)
    before = megakernel.env_pool.launches
    got = megakernel.env_pool(env, u2, rgbe)
    assert megakernel.env_pool.launches == before + 1
    want = pack.env_pool_plain(env, u2, rgbe)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(build_env_pool(env, seed, spp_base, rgbe), got)
    if rgbe:
        assert torch.equal(got, pack.pack_pool_rgbe(pack.env_pool_plain(env, u2)))


@pytest.mark.parametrize("pool_rgbe", [False, True], ids=["f32", "packed"])
def test_env_pool_one_launch_per_dispatch(pool_rgbe):
    """trace() draws each dispatch's pool in one launch of the draw kernel;
    with pallas_pool_rgbe on, the encode kernel is not launched for it."""
    r = _renderer(_cuda())
    r.pallas_pool_rgbe = pool_rgbe
    r.trace(1)
    pools, encodes = megakernel.env_pool.launches, megakernel.rgbe_encode.launches
    dispatches = megakernel.render.launches
    r.trace(2 * DISPATCH_SPP + 3)
    assert megakernel.render.launches == dispatches + 3
    assert megakernel.env_pool.launches == pools + 3
    assert megakernel.rgbe_encode.launches == encodes


def test_env_pool_makes_no_host_sync():
    """A dispatch's pool, f32 and packed, is built with no host sync
    (torch's sync debug mode raises on one) and equals the pool built
    without the mode."""
    r = _renderer(_cuda(), env=_rotated_sky())

    def pools():
        out = {}
        for rgbe in (False, True):
            r.pallas_pool_rgbe = rgbe
            out[rgbe] = r._env_pool(64)
        return out

    want = pools()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pools()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for rgbe in (False, True):
        assert torch.equal(got[rgbe], want[rgbe])


def test_trace_with_the_pool_kernel_is_the_trace_with_plain_pools(monkeypatch):
    """trace(128) of the plain path with the draw kernel's pools is
    bitwise the same trace fed its plain version's pools."""
    from volren_tpu_torch import renderer as renderer_module
    from volren_tpu_torch.ops.kernels import pack

    dev = _cuda()
    a = _renderer(dev, env=_rotated_sky())
    a.trace(2 * DISPATCH_SPP)
    plain_pools = []

    def plain_pool(env, seed, spp_base, rgbe=False):
        plain_pools.append(spp_base)
        return pack.env_pool_plain(env, pack.pool_uniforms(seed, spp_base, dev), rgbe)

    monkeypatch.setattr(renderer_module, "build_env_pool", plain_pool)
    b = _renderer(dev, env=_rotated_sky())
    before = megakernel.env_pool.launches
    b.trace(2 * DISPATCH_SPP)
    assert plain_pools == [0, DISPATCH_SPP] and megakernel.env_pool.launches == before
    assert torch.equal(a.framebuffer(), b.framebuffer())


def test_packed_f32_instantiation_is_the_f32_dispatch():
    """With every switch off the tables are the float32 ones, and the
    dispatch is the f32 instantiation's image."""
    r = _renderer(_cuda())
    ks, pool, pf, pi = _packed_inputs(r, (False, False, False))
    assert ks.mip_u8 is None and ks.env_rgbe is None and pool.dtype == torch.float32
    assert torch.equal(megakernel.render(ks, pool, pf, pi),
                       megakernel.render(*_inputs(_renderer(_cuda()))))


def test_packed_kernel_with_scale_zero_levels():
    """A grid of one value makes every level of the u8 pyramid hi == lo
    (scale 0, every byte 0): the kernel decodes each to its value and
    matches the plain version bitwise, in the plain and the TF variant."""
    dense = np.full((16, 16, 16), 1.3, np.float32)
    for tf in (False, True):
        r = _renderer(_cuda(), tf=tf, dense=dense)
        inputs = _packed_inputs(r, (True, True, True))
        ks = inputs[0]
        assert (ks.mip_dq[1] == 0.0).all() and int(ks.mip_u8.max()) == 0
        got = megakernel.render(*inputs)
        assert torch.equal(got, megakernel.render_plain(*inputs))


def test_packed_renderer_on_card_launches_the_packed_kernel():
    """trace() with all three switches on launches the packed
    instantiation, once a dispatch, and draws an RGBE pool."""
    r = _renderer(_cuda())
    r.pallas_mip_u8, r.pallas_env_rgbe, r.pallas_pool_rgbe = "1", True, True
    key = (False, False, True, True, True)
    before = megakernel.render.launches_by_packs.get(key, 0)
    r.trace(DISPATCH_SPP + 3)
    assert megakernel.render.launches_by_packs[key] == before + 2
    fb = r.framebuffer()
    assert bool(torch.isfinite(fb).all()) and float(fb[..., :3].mean()) > 0


def test_device_rgbe_encode_is_the_plain_encode():
    """The library's encode kernel against pack.rgbe_encode_plain (XLA's
    log and exp emulated in float64) on the same CUDA tensors: 2^24 random
    rows over 2^-80 .. 2^80, the values next to every power of two, zeros,
    negatives, and a strided view (a pool's radiance columns), bitwise;
    one launch each."""
    from volren_tpu_torch.ops.kernels.pack import rgbe_encode_plain

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(11)
    rgb = (torch.rand(1 << 24, 3, device=dev, generator=gen) ** 3
           * torch.exp2(torch.rand(1 << 24, 1, device=dev, generator=gen) * 160 - 80))
    k = torch.arange(-125, 126, device=dev, dtype=torch.float64)[:, None]
    near = (torch.exp2(k) * torch.tensor([1 - 2.0 ** -24, 1.0, 1 + 2.0 ** -23], device=dev,
                                         dtype=torch.float64)).float().reshape(-1, 1)
    rgb = torch.cat([rgb, near * torch.tensor([[1.0, 0.5, 0.999]], device=dev),
                     torch.zeros(4, 3, device=dev), -torch.ones(4, 3, device=dev)])
    before = megakernel.rgbe_encode.launches
    for chunk in rgb.split(1 << 22):
        assert torch.equal(megakernel.rgbe_encode(chunk), rgbe_encode_plain(chunk))
    pool = build_env_pool(_renderer(dev)._env_device, 3, 0)
    assert torch.equal(megakernel.rgbe_encode(pool[:, 4:7]), rgbe_encode_plain(pool[:, 4:7]))
    assert megakernel.rgbe_encode.launches == before + len(rgb.split(1 << 22)) + 1


def test_device_rgbe_decode_is_the_plain_decode_on_every_word():
    """The kernel's RGBE decode against pack.rgbe_decode on all 2^32 words,
    in chunks of 2^26, bitwise (NaN and infinity bit patterns included)."""
    from volren_tpu_torch.ops.kernels.pack import rgbe_decode

    dev = _cuda()
    chunk = 1 << 26
    before = megakernel.rgbe_decode.launches
    for start in range(0, 1 << 32, chunk):
        w = torch.arange(start, start + chunk, dtype=torch.int64, device=dev)
        w = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
        got = megakernel.rgbe_decode(w)
        want = rgbe_decode(w)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), start
    assert megakernel.rgbe_decode.launches == before + (1 << 32) // chunk


@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("spp", [4, 64])
def test_kernel_row_bands_are_the_whole_dispatch(spp, tf, emission):
    """37 x 23 over 2, 3 (8, 8, 7 rows) and 4 (6, 6, 6, 5) row bands: each
    band's tiles and output cover its rows only, its pixels keep the whole
    frame's seeds and rays, so the bands concatenated are bitwise the whole
    dispatch, in the kernel and in its STATS instantiation; and a band
    equals the plain version's band bitwise."""
    from volren_tpu_torch.parallel.sharding import band_rows

    r = _renderer(_cuda(), tf=tf, emission=emission, width=37, height=23)
    ks, pool, pf, pi = _inputs(r, spp=spp)
    whole = megakernel.render(ks, pool, pf, pi)
    for n in (2, 3, 4):
        parts, stats_parts = [], []
        for t in range(n):
            row0, rows = band_rows(23, n, t)
            _pf, bpi = build_params(ks, r._trace_params(), 37, 23, 0, spp, row0, rows)
            parts.append(megakernel.render(ks, pool, pf, bpi))
            stats_parts.append(megakernel.render_stats(ks, pool, pf, bpi)[0])
        assert torch.equal(torch.cat(parts), whole), n
        assert torch.equal(torch.cat(stats_parts), whole), n
    # the last split's second band, rows 6-11
    band = pi.copy()
    band[PI_ROW0], band[PI_ROWS] = 6, 6
    assert torch.equal(parts[1], megakernel.render_plain(ks, pool, pf, band))


def test_stats_instantiation_counts_the_dispatch():
    """The STATS instantiation renders the same image as the kernel and
    counts the events render_plain counts; render does not launch it."""
    inputs = _inputs(_renderer(_cuda(), emission=True))
    before = megakernel.render_stats.launches
    a = megakernel.render(*inputs)
    assert megakernel.render_stats.launches == before
    b, st = megakernel.render_stats(*inputs)
    assert megakernel.render_stats.launches == before + 1
    assert torch.equal(a, b)
    stats = {}
    megakernel.render_plain(*inputs, stats=stats)
    assert {k: st[k] for k in stats} == stats
    assert st["regen"] == RES * RES * SPP and st["capped"] == 0
    assert 0.0 < st["simt_march"] <= 1.0 and 0.0 < st["simt_loop"] <= 1.0
    assert st["march"] >= st["regen"] and st["max_steps"] > 0
    assert 0.0 <= st["tail_ms"] <= st["span_ms"] and st["blocks"] > 0


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


@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
def test_checkpoint_resume_equals_straight_trace_on_card(tf, emission, tmp_path):
    """128 spp, a checkpoint, a new Renderer, 128 more = trace(256), bitwise
    (the dispatches cut at the same 64-spp fences)."""
    dev = _cuda()
    first = _renderer(dev, tf=tf, emission=emission)
    first.trace(128)
    first.save_checkpoint(str(tmp_path / "c.npz"))
    resumed = _renderer(dev, tf=tf, emission=emission)
    resumed.load_checkpoint(str(tmp_path / "c.npz"))
    assert resumed.framebuffer().is_cuda
    before = megakernel.render.launches
    resumed.trace(128)
    assert megakernel.render.launches == before + 2
    straight = _renderer(dev, tf=tf, emission=emission)
    straight.trace(256)
    assert resumed.sample == 256 and torch.equal(resumed.framebuffer(), straight.framebuffer())


def test_hot_reload_swaps_in_a_rebuilt_library(tmp_path):
    """An edited copy of megakernel.cu is rebuilt (a new library: its own
    resident block counts and group counter) and swapped in; every variant
    then renders as before, bitwise, at two group shapes; a source that
    does not compile keeps the loaded library."""
    from volren_tpu_torch.utils.hotreload import KernelWatcher

    dev = _cuda()
    scenes = [(_inputs(_renderer(dev, tf=tf, emission=emission), spp))
              for tf, emission in VARIANTS for spp in (4, 64)]
    before = [megakernel.render(*inputs) for inputs in scenes]
    old = megakernel._lib()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "megakernel.cu"
    with open(megakernel.SOURCE) as f:
        src.write_text(f.read())
    watcher = KernelWatcher(str(csrc))
    src.write_text(src.read_text() + "\n// edited\n")
    try:
        assert watcher.reload_modified_kernels()
        assert megakernel._LIB is not old and megakernel._LIB._name != old._name
        for inputs, want in zip(scenes, before):
            assert torch.equal(megakernel.render(*inputs), want)
            assert torch.equal(megakernel.render(*inputs), want)
        swapped = megakernel._LIB
        src.write_text(src.read_text() + "\nthis is not C++\n")
        assert not watcher.reload_modified_kernels()
        assert megakernel._LIB is swapped
    finally:
        with megakernel._LIB_LOCK:
            megakernel._LIB = old


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
    env = _renderer(_cuda())._env_device
    u2 = torch.rand(64, 2, device=env.alias_packed.device)
    with pytest.raises(ValueError):
        megakernel.env_pool(env, u2.double())
    with pytest.raises(ValueError):
        megakernel.env_pool(env, u2.t())
    with pytest.raises(ValueError):
        megakernel.env_pool(env._replace(alias_packed=env.alias_packed[:, :9].contiguous()), u2)


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
    cases = {
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
    # the transpose's 16-byte path at W4's shapes, its word-by-word path on
    # ragged shapes and on a column slice (a pitch of 1029 words, 12 bytes in)
    for h, w in TRANSPOSE_SHAPES:
        for kind in ("f32", "i32"):
            a = t(rng.random((h, w)).astype(np.float32) if kind == "f32" else
                  rng.integers(-2 ** 31, 2 ** 31, (h, w)).astype(np.int32))
            cases[f"transpose_{h}x{w}_{kind}"] = (lambda f, a=a: f(a, "transpose"),
                                                  K.index_copy, K.index_copy_plain)
    wide = t(rng.random((37, 1029)).astype(np.float32))
    cases["transpose_column_slice"] = (lambda f: f(wide[:, 3:1026], "transpose"), K.index_copy,
                                       K.index_copy_plain)
    # the affine loop's short kernel (1-4 steps), its loop kernel (100 steps,
    # a device trip count, an unaligned x) on sizes around a whole quad
    for n in AFFINE_SIZES:
        xn = t(rng.random(n).astype(np.float32) * 4.0 - 2.0)
        for steps in AFFINE_STEPS:
            cases[f"affine_{steps}_{n}"] = (
                lambda f, xn=xn, steps=steps: f(xn, steps, 1.0000001, 1e-6), K.affine_loop,
                K.affine_loop_plain)
        cases[f"affine_dev_{n}"] = (lambda f, xn=xn: f(xn, 0, 1.0000001, 1e-6, n_dev),
                                    K.affine_loop, K.affine_loop_plain)
    cases["affine_x2_8x128"] = (lambda f: f(pos, 1, 2.0, 0.0), K.affine_loop,
                                K.affine_loop_plain)
    cases["affine_unaligned"] = (lambda f: f(flat[1:], 3, 1.0000001, 1e-6), K.affine_loop,
                                 K.affine_loop_plain)
    return cases


TRANSPOSE_SHAPES = ((128, 1024), (1024, 128), (8, 1024), (1, 1), (37, 1029), (33, 31),
                    (1029, 37))
AFFINE_SIZES = (1, 1023, 1024, 1025)
AFFINE_STEPS = (1, 2, 3, 4, 100)
PROBE_CASES = ("affine_loop", "affine_loop_dev", "gather_rc_f32", "gather_rc_i32",
               "gather_1d_mod", "gather_rows", "gather_cols", "lcg_row", "lcg_rc_i32",
               "lcg_flat", "carry30", "march", "rounds_staged", "rounds_staged_n8",
               "rounds_direct", "rounds_stage", "rounds_ids", "rounds_stale", "transpose",
               "tile_rows", "roll_cols", "broadcast_row0", "iota_plus", "tea8",
               *(f"transpose_{h}x{w}_{kind}" for h, w in TRANSPOSE_SHAPES
                 for kind in ("f32", "i32")),
               "transpose_column_slice",
               *(f"affine_{steps}_{n}" for n in AFFINE_SIZES for steps in AFFINE_STEPS),
               *(f"affine_dev_{n}" for n in AFFINE_SIZES), "affine_x2_8x128", "affine_unaligned")


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


@pytest.mark.parametrize("shape", [(37, 23), (256, 512)], ids=["37x23", "256x512"])
def test_probe_affine_loop_matches_plain_version_at_ragged_counts(shape):
    """The loop kernel (blocks of AFFINE_U steps written out, then the rest)
    at counts around a block and P4's, P1's and P2's 64 and 4096 steps, the
    count from the host and read on the device, bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    x = torch.from_numpy((np.random.default_rng(19).random(shape) * 4.0 - 2.0)
                         .astype(np.float32)).to(dev)
    u = K.AFFINE_U
    for count in sorted({0, 1, u - 1, u, u + 1, 64, 4095, 4096, 4097}):
        want = K.affine_loop_plain(x, count, 1.0000001, 1e-6)
        n_dev = torch.tensor([count], dtype=torch.int32, device=dev)
        for got in (K.affine_loop(x, count, 1.0000001, 1e-6),
                    K.affine_loop(x, 0, 1.0000001, 1e-6, n_dev)):
            assert got.is_cuda and torch.equal(got, want), count


ROUND_MODES = ("ids", "direct", "stage", "staged", "stale")
ROUND_LANES = (0, 1, 8, 31, 32, 33, 127, 128)
ROUND_COUNTS = (0, 1, 2, 3, 300)


@pytest.mark.parametrize("use_mask", [False, True], ids=["mod_rows", "mask"])
@pytest.mark.parametrize("mode", ROUND_MODES)
def test_probe_row_gather_rounds_matches_plain_version(mode, use_mask):
    """Every mode, at lane counts around a warp's edges and round counts
    around the per-warp mbarriers' first phases, both index forms (65537
    rows: % rows is no power of two), bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(13)
    tab = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (65537, 128)).astype(np.int32)).to(dev)
    base = torch.from_numpy(rng.integers(0, 65537, (128,)).astype(np.int32)).to(dev)
    for n in ROUND_LANES:
        for rounds in ROUND_COUNTS:
            before = K.row_gather_rounds.launches
            got = K.row_gather_rounds(base, tab, mode, rounds, n, use_mask)
            assert K.row_gather_rounds.launches == before + 1
            want = K.row_gather_rounds_plain(base, tab, mode, rounds, n, use_mask)
            assert got.is_cuda and torch.equal(got, want), (n, rounds)


@pytest.mark.parametrize("rows,use_mask", [(7, False), (7919, False), (7920, False),
                                           (65536, False), (65536, True), (65537, False),
                                           (65537, True)])
def test_probe_direct_rounds_match_plain_version_at_ragged_rounds(rows, use_mask):
    """The direct mode (rows advanced without a division, DIRECT_INFLIGHT
    rounds' loads in flight, then the rest) on tables of 7 to 65537 rows,
    negative base ids too, at rounds around a batch and n around the lanes'
    edges, bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(17)
    tab = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (rows, 128), dtype=np.int64)
                           .astype(np.int32)).to(dev)
    base = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (128,), dtype=np.int32)).to(dev)
    d = K.DIRECT_INFLIGHT
    for rounds in (0, 1, d - 1, d, d + 1, 512, 513):
        for n in (0, 1, 37, 128):
            before = K.row_gather_rounds.launches
            got = K.row_gather_rounds(base, tab, "direct", rounds, n, use_mask)
            assert K.row_gather_rounds.launches == before + 1
            want = K.row_gather_rounds_plain(base, tab, "direct", rounds, n, use_mask)
            assert got.is_cuda and torch.equal(got, want), (rounds, n)


def test_probe_staged_rounds_refuse_a_misaligned_table():
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    flat = torch.zeros(65536 * 128 + 4, dtype=torch.int32, device=dev)
    offset = flat[1:65536 * 128 + 1].view(65536, 128)
    base = torch.zeros(128, dtype=torch.int32, device=dev)
    before = K.row_gather_rounds.launches
    for mode in ("stage", "staged"):
        with pytest.raises(ValueError):
            K.row_gather_rounds(base, offset, mode, 3)
    assert K.row_gather_rounds.launches == before


def _lcg_iters():
    from volren_tpu_torch.ops.kernels import probes as K

    return (0, 1, K.LCG_UNROLL - 1, K.LCG_UNROLL, K.LCG_UNROLL + 1, 64)


LCG_LANES = ((1, 1), (3, 37), (8, 16384))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("mode", ["row", "rc", "flat"])
def test_probe_lcg_gather_sum_matches_plain_version(mode, dtype):
    """Every mode and table type, at iteration counts around the loads in
    flight (LCG_UNROLL) and its remainder loop, on ragged lane blocks (one
    lane, 3 x 37, 8 x 16384: the block-size plan's edges) and tables of
    100 (no power of two) and 128 columns, bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(17)
    for h, w in LCG_LANES:
        for cols in (100, 128):
            rows = h if mode == "row" else 74
            tn = (rng.integers(-2 ** 20, 2 ** 20, (rows, cols)).astype(np.int32) if dtype == "i32"
                  else rng.random((rows, cols)).astype(np.float32))
            t = torch.from_numpy(tn).to(dev)
            for iters in _lcg_iters():
                before = K.lcg_gather_sum.launches
                got = K.lcg_gather_sum(t, mode, (h, w), iters, 42)
                assert K.lcg_gather_sum.launches == before + 1
                want = K.lcg_gather_sum_plain(t, mode, (h, w), iters, 42, 7919)
                assert got.is_cuda and torch.equal(got, want), ((h, w), cols, iters)


# every (r_mode, c_mode) the gather kernel is instantiated for: a 1-D table
# (rows of the output's shape), a 2-D table with rows only (of the output's
# shape, or (H, 1): the row fetch), with cols only, or with both
GATHER_MODES = {"1d": ("rows", None), "rows": ("rows", None), "row_fetch": ("row", None),
                "cols": (None, "cols"), "rows_cols": ("rows", "cols"),
                "row_cols": ("row", "cols")}
GATHER_LAYOUTS = ("contiguous", "unaligned", "strided")


@pytest.mark.parametrize("four", [False, True], ids=["planned", "four_words"])
@pytest.mark.parametrize("has_mod", [False, True], ids=["", "mod"])
@pytest.mark.parametrize("mode", list(GATHER_MODES))
def test_probe_gather_instantiation_matches_plain_version(mode, has_mod, four, monkeypatch):
    """Each <R_MODE, C_MODE, MOD, N> instantiation of the gather kernel, at
    the wrapper's words a thread and at 4 wherever the arrays allow (the
    design comparison's plan): ragged and whole widths (127, 128, 130),
    index arrays contiguous, one column in (4 bytes off alignment) and rows
    of a wider array, 1, 2 and 3 tables of f32 and i32 in one launch; with
    has_mod, the modulo by 32 (MOD_MASK) and by 37 (MOD_PY), both with
    Python's sign rule on negative rows; bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    if four:
        monkeypatch.setattr(K, "gather_words",
                            lambda r_mode, c_mode, vec_ok, w: 4 if vec_ok and w % 4 == 0 else 1)
    rng = np.random.default_rng(19)
    h, n_rows = 9, 64
    one_d = mode == "1d"
    for w in (127, 128, 130):
        n_cols = -(-(w + 3) // 4) * 4
        shape = (4096,) if one_d else (n_rows, n_cols)
        tables = [torch.from_numpy(rng.random(shape).astype(np.float32)
                                   if k != 1 else rng.integers(-2 ** 31, 2 ** 31, shape)
                                   .astype(np.int32)).to(dev) for k in range(3)]
        for layout in GATHER_LAYOUTS:
            def index(lo, hi, width):
                a = torch.from_numpy(rng.integers(lo, hi, (h, width + 7)).astype(np.int32)).to(dev)
                return {"contiguous": a[:, :width].contiguous(), "unaligned": a[:, 1:width + 1],
                        "strided": a[:, :width]}[layout]
            for row_mod in ((32, 37) if has_mod else (0,)):
                lo, hi = (-2000, 2000) if row_mod else (0, 4096 if one_d else n_rows)
                arrays = {"rows": index(lo, hi, w), "row": index(lo, hi, 1),
                          "cols": index(0, n_cols, w)}
                rows, cols = (arrays[k] if k else None for k in GATHER_MODES[mode])
                for n_tables in (1, 2, 3):
                    arg = tables[0] if n_tables == 1 else tuple(tables[:n_tables])
                    before = K.gather.launches
                    got = K.gather(arg, rows, cols, row_mod)
                    assert K.gather.launches == before + 1
                    want = K.gather_plain(arg, rows, cols, row_mod)
                    got, want = (got, want) if n_tables > 1 else ((got,), (want,))
                    for a, b in zip(got, want):
                        assert a.is_cuda and torch.equal(a, b), (w, layout, row_mod, n_tables)


@pytest.mark.parametrize("lanes", [(3, 37), (8, 128)], ids=["3x37", "8x128"])
def test_probe_carry30_matches_plain_version_at_ragged_steps(lanes):
    """carry30's pipeline at step counts around its blocks of CARRY_U steps
    and around X3's 512, on lanes whose threads fill no whole warp (3 x 37)
    and on X3's, from tables with no power-of-two side (37 x 100) and X3's
    (74 x 128), bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(23)
    u = K.CARRY_U
    steps = (0, 1, u - 1, u, u + 1, 511, 512, 513) if lanes == (3, 37) else (u + 1, 512)
    for shape in ((37, 100), (74, 128)):
        t = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        for iters in steps:
            before = K.carry30.launches
            got = K.carry30(t, 11, iters, lanes)
            assert K.carry30.launches == before + 1
            want = K.carry30_plain(t, 11, iters, lanes)
            assert got.is_cuda and torch.equal(got, want), (shape, iters)


MARCH_WIDTHS = (1, 3, 127, 129, 1000)
MARCH_STEPS = (0, 1, 63, 64, 65, 1000)
MARCH_ROWS = (1, 17, 4096)


@pytest.mark.parametrize("w", MARCH_WIDTHS)
def test_probe_march_matches_plain_version_at_ragged_shapes(w):
    """The march kernel (one thread a (row, column), march_plan's grid) at
    widths that fill no whole warp or block, at step counts around Q6's 64
    and past it, on tables of 1, 17 and 4096 rows, from positions below 0
    and above R / 16 (both clamps bind), bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(29 + w)
    for rows_t in MARCH_ROWS:
        t, x, s = (torch.from_numpy(a).to(dev) for a in (
            rng.random((rows_t, w), np.float32),
            (rng.random((8, w)) * (rows_t / 16 + 2) - 1).astype(np.float32),
            rng.integers(0, 2 ** 32, (8, w), dtype=np.uint32).astype(np.int64)))
        # row 0's position picks the cell: column 0 below 0, then past R / 16
        for pos0 in (-0.5, rows_t / 16 + 0.5):
            x[0, 0] = pos0
            for iters in MARCH_STEPS:
                before = K.march.launches
                got = K.march(t, x, s, iters)
                assert K.march.launches == before + 1
                want = K.march_plain(t, x, s, iters)
                assert got.is_cuda and torch.equal(got, want), (rows_t, pos0, iters)


IC_WIDTHS = (1, 3, 5, 127, 128, 129)
IC_CASES = [(op, kind) for op in ("tile_rows", "roll_cols", "broadcast_row0", "iota_plus")
            for kind in ("f32", "i32") if (op, kind) != ("iota_plus", "i32")]


@pytest.mark.parametrize("op,kind", IC_CASES, ids=[f"{op}-{kind}" for op, kind in IC_CASES])
def test_probe_index_copy_matches_plain_version_at_ragged_shapes(op, kind):
    """Q3's index_copy ops (index_copy_plan's segments, 16-byte stores where
    the row is whole quads, word stores otherwise) at ragged widths, one and
    three rows, tile counts 1-5, roll shifts negative and past W, up to
    3584 rows, from an aligned array and from views 4 bytes past a 16-byte
    boundary, bitwise."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(31)
    args = {"tile_rows": (1, 2, 3, 4, 5), "broadcast_row0": (1, 37, 3584),
            "iota_plus": (1, 37, 3584)}
    for w in IC_WIDTHS:
        for h in (1, 3):
            a = (rng.random(h * w + 1).astype(np.float32) if kind == "f32" else
                 rng.integers(-2 ** 31, 2 ** 31, h * w + 1).astype(np.int32))
            flat = torch.from_numpy(a).to(dev)
            aligned, unaligned = flat[:-1].view(h, w), flat[1:].view(h, w)
            assert aligned.data_ptr() % 16 == 0 and unaligned.data_ptr() % 16 == 4
            for x in (aligned, unaligned):
                for arg in args.get(op, (3, -1, -w - 2, w, w + 3, 2 * w + 1)):
                    before = K.index_copy.launches
                    got = K.index_copy(x, op, arg)
                    assert K.index_copy.launches == before + 1
                    want = K.index_copy_plain(x, op, arg)
                    assert got.is_cuda and torch.equal(got, want), (w, h, x.data_ptr() % 16, arg)


def test_probe_row_scan_matches_cumsum():
    from volren_tpu_torch.ops.kernels import probes as K

    x = torch.from_numpy(np.random.default_rng(0).random((8, 128), np.float32)).to(_cuda())
    before = K.row_scan.launches
    got = K.row_scan(x)
    assert K.row_scan.launches == before + 1
    torch.testing.assert_close(got, K.row_scan_plain(x), rtol=1e-5, atol=0)


TEA8_SIZES = (1, 3, 4, 1023, 1024, 1025, 2 ** 20 + 3)
ROW_SCAN_SHAPES = [(h, w) for h in (1, 8, 1000) for w in (1, 3, 31, 32, 33, 127, 128, 129, 1000,
                                                          1024)]


@pytest.mark.parametrize("n", TEA8_SIZES)
def test_probe_tea8_matches_plain_version_at_ragged_sizes(n):
    """tea8 at sizes around a quad and a 256-thread block, from int64
    values and from int32 bits, aligned and one element past a 16-byte
    boundary, bitwise tea8_plain, one launch a call."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    rng = np.random.default_rng(n)
    a64, b64 = (torch.from_numpy(rng.integers(0, 2 ** 32, n + 1, dtype=np.uint32)
                                 .astype(np.int64)).to(dev) for _ in range(2))
    a32, b32 = K.u32_bits(a64), K.u32_bits(b64)
    assert a32.data_ptr() % 16 == 0 and a32[1:].data_ptr() % 16 == 4
    cases = {"int64": (a64[:-1], b64[:-1]), "int64 offset": (a64[1:], b64[1:]),
             "int32": (a32[:-1], b32[:-1]), "int32 offset": (a32[1:], b32[1:])}
    for label, (a, b) in cases.items():
        before = K.tea8.launches
        got = K.tea8(a, b)
        assert K.tea8.launches == before + 1
        want = K.tea8_plain(a, b)
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == a.dtype and torch.equal(g, w), label


@pytest.mark.parametrize("h,w", ROW_SCAN_SHAPES, ids=[f"{h}x{w}" for h, w in ROW_SCAN_SHAPES])
def test_probe_row_scan_matches_plain_version_at_ragged_shapes(h, w):
    """row_scan's float4 path (whole quads, 16-byte aligned) and its word
    path (ragged rows, or a base 4 bytes past a 16-byte boundary), a lane's
    1 to 32 values, within rtol 1e-5 of row_scan_plain (torch.cumsum) on
    the probe's positive values, one launch a call."""
    from volren_tpu_torch.ops.kernels import probes as K

    dev = _cuda()
    x = np.random.default_rng(h * 4096 + w).random(h * w + 1).astype(np.float32)
    flat = torch.from_numpy(x).to(dev)
    aligned, offset = flat[:-1].view(h, w), flat[1:].view(h, w)
    assert aligned.data_ptr() % 16 == 0 and offset.data_ptr() % 16 == 4
    for t in (aligned, offset):
        before = K.row_scan.launches
        got = K.row_scan(t)
        assert K.row_scan.launches == before + 1
        torch.testing.assert_close(got, K.row_scan_plain(t), rtol=1e-5, atol=0)


# ---- the oracle engine (csrc/oracle.cu)

ORACLE_VARIANTS = [(dda, tf, emi) for dda in (True, False) for tf in (False, True)
                   for emi in (False, True)]
ORACLE_IDS = [f"{'dda' if d else 'delta'}{'-tf' if t else ''}{'-emi' if e else ''}"
              for d, t, e in ORACLE_VARIANTS]


def _oracle_renderer(device, use_dda, tf, emission, width=37, height=23):
    r = _renderer(device, tf=tf, emission=emission, width=width, height=height)
    r.engine = "oracle"
    r._use_dda = use_dda
    return r


def _oracle_inputs(r):
    return r._scene_tables(), r._trace_params(), r._config()


def _fb0(seed):
    """A non-zero running mean to start from."""
    return torch.rand(23, 37, 4, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("passes", [1, 3, 32, 33, 70])
@pytest.mark.parametrize("use_dda,tf,emission", ORACLE_VARIANTS, ids=ORACLE_IDS)
def test_oracle_kernel_matches_plain_version(use_dda, tf, emission, passes):
    """Every <USE_DDA, USE_TF, HAS_EMI> instantiation's launch of
    ``passes`` passes (a tile of 32 / n pixels to a warp below 32 passes,
    one pixel in rounds of 64 slots above) equals the plain torch version
    on the same CUDA tensors bitwise, at a ragged 37x23, from a non-zero
    framebuffer at sample 5, and is bitwise identical run to run: one
    launch per call."""
    from volren_tpu_torch.ops import tracer
    from volren_tpu_torch.ops.kernels import oracle

    dev = _cuda()
    scene, params, cfg = _oracle_inputs(_oracle_renderer(dev, use_dda, tf, emission))
    fb0 = _fb0(passes).to(dev)
    plain = tracer.trace_passes(scene, params, cfg, fb0, 5, passes, 37, 23)
    before = oracle.trace_pass.launches_by_variant.get((use_dda, tf, emission), 0)
    kb = oracle.trace_passes(scene, params, cfg, fb0, 5, passes)
    kb2 = oracle.trace_passes(scene, params, cfg, fb0, 5, passes)
    assert oracle.trace_pass.launches_by_variant[(use_dda, tf, emission)] == before + 2
    assert torch.equal(kb, plain), float((kb - plain).abs().max())
    assert torch.equal(kb, kb2)
    assert bool(torch.isfinite(kb).all()) and not torch.equal(kb, fb0)


@pytest.mark.parametrize("use_dda", [True, False], ids=["dda", "delta"])
def test_oracle_kernel_launches_fold_in_pass_order(use_dda):
    """Launches of 3, 1 and 4 passes after one another equal one launch of
    8 and the passes one at a time, bitwise."""
    from volren_tpu_torch.ops.kernels import oracle

    dev = _cuda()
    scene, params, cfg = _oracle_inputs(_oracle_renderer(dev, use_dda, True, True))
    fb0 = _fb0(8).to(dev)
    whole = oracle.trace_passes(scene, params, cfg, fb0, 2, 8)
    split = oracle.trace_passes(scene, params, cfg, fb0, 2, 3)
    split = oracle.trace_passes(scene, params, cfg, split, 5, 1)
    split = oracle.trace_passes(scene, params, cfg, split, 6, 4)
    one = fb0
    for s in range(2, 10):
        one = oracle.trace_pass(scene, params, cfg, one, s)
    assert torch.equal(split, whole) and torch.equal(one, whole)


@pytest.mark.parametrize("use_dda", [True, False], ids=["dda", "delta"])
def test_oracle_kernel_matches_plain_version_with_the_cap_binding(use_dda):
    """max_steps = 3: most tracking loop calls stop mid-loop; the kernel
    keeps their state as the plain version does, and counts as many capped
    loop calls, over a launch of 3 passes."""
    from volren_tpu_torch.ops import tracer
    from volren_tpu_torch.ops.kernels import oracle

    dev = _cuda()
    scene, params, cfg = _oracle_inputs(_oracle_renderer(dev, use_dda, True, True))
    cfg = cfg._replace(max_steps=3)
    stats = {}
    fb0 = _fb0(3).to(dev)
    plain = tracer.trace_passes(scene, params, cfg, fb0, 2, 3, 37, 23, stats)
    capped = torch.zeros(1, dtype=torch.int32, device=dev)
    got = oracle.trace_passes(scene, params, cfg, fb0, 2, 3, capped=capped)
    assert stats["capped"] > 0 and int(capped) == stats["capped"]
    assert torch.equal(got, plain)


@pytest.mark.parametrize("use_dda,tf,emission", ORACLE_VARIANTS, ids=ORACLE_IDS)
def test_oracle_stats_instantiation_counts_the_plain_versions_units(use_dda, tf, emission):
    """The STATS instantiation renders the same framebuffer as the render
    path's launches and counts what the plain version counts: paths,
    bounce and tracking-loop iterations, DDA tests, emission taps, capped
    loop calls; its SIMT efficiencies are shares."""
    from volren_tpu_torch.ops import tracer
    from volren_tpu_torch.ops.kernels import oracle

    dev = _cuda()
    scene, params, cfg = _oracle_inputs(_oracle_renderer(dev, use_dda, tf, emission))
    fb0 = torch.rand(23, 37, 4, generator=torch.Generator().manual_seed(3)).to(dev)
    stats = {}
    plain = tracer.trace_passes(scene, params, cfg, fb0, 2, 3, 37, 23, stats)
    got, st = oracle.trace_stats(scene, params, cfg, fb0, 2, 3)
    assert torch.equal(got, plain)
    assert torch.equal(got, oracle.trace_passes(scene, params, cfg, fb0, 2, 3))
    for key, n in stats.items():
        assert st[key] == n, (key, st[key], n)
    assert st["paths"] == 3 * 37 * 23 and st["capped"] == stats.get("capped", 0)
    assert st["groups"] == 10 * 6   # 4 x 4 pixel tiles of 3 passes: 32-item groups
    assert 0.0 < st["simt_bounce"] <= 1.0 and 0.0 < st["simt_track"] <= 1.0
    assert st["blocks"] >= 1 and 0.0 <= st["tail_ms"] <= st["span_ms"]


def test_oracle_renderer_and_cli_launch_the_kernel(tmp_path):
    from volren_tpu_torch import cli
    from volren_tpu_torch.ops.kernels import oracle

    dev = _cuda()
    r = _oracle_renderer(dev, True, False, False, 32, 32)
    for spp in (3, 130):   # ceil(spp / DISPATCH_SPP) launches
        before = oracle.trace_pass.launches
        r.trace(spp)
        assert r.last_engine == "cuda_oracle"
        assert oracle.trace_pass.launches == before + -(-spp // DISPATCH_SPP)
    assert r.sample == 133
    fb = r.framebuffer()
    assert fb.is_cuda and bool(torch.isfinite(fb).all()) and float(fb[..., :3].mean()) > 0
    grid = tmp_path / "grid.dense"
    from volren_tpu_torch.voldata import write_dense

    write_dense(str(grid), DenseGrid(16, 16, 16, _grid16()))
    for flags, variant in ((["--no-dda"], (False, False, False)),
                           (["--engine", "oracle"], (True, False, False))):
        before = oracle.trace_pass.launches_by_variant.get(variant, 0)
        r, stats = cli.run([str(grid), "--render", "-w", "16", "-h", "16", "--spp", "70",
                            "--bounces", "8", "--output", str(tmp_path / "o.png"), *flags])
        assert r.last_engine == "cuda_oracle" and r.sample == 70
        assert oracle.trace_pass.launches_by_variant[variant] == before + 2   # 64 + 6


# ---- the plain versions' chunked schedule on the card (ops/chunked.py)

PLAIN_SCENES = ["random16", "cloud512_crop64"]
PATHS = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
         "tf+emission": (True, True)}


@functools.lru_cache(maxsize=1)
def _cloud512_crop64():
    """The 64^3 crop of cloud512 that chip_smoke.py phase 3 renders."""
    import os

    from volren_tpu_torch.voldata import read_brick

    cloud = read_brick(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    ".scene_cache", "cloud512.brick"))
    zz, yy, xx = np.meshgrid(np.arange(96, 160), np.arange(224, 288), np.arange(224, 288),
                             indexing="ij")
    return cloud.lookup(np.stack([xx, yy, zz], -1))


def _path_renderer(dev, scene, path, use_dda=None):
    """A committed 64 x 64 Renderer of one of the kernel's paths (the --fau
    LUT, a half-resolution temperature grid), 16 bounces, on the random
    16^3 grid or the cloud512 crop; with ``use_dda``, the oracle engine."""
    from volren_tpu_torch.measure import path_renderer

    dense = _grid16() if scene == "random16" else _cloud512_crop64()
    d, h, w = dense.shape
    sky = Environment(procedural_sky(64, 32, seed=4))
    r = path_renderer(Volume(DenseGrid(w, h, d, dense)), sky, 64, 7, path, 16, device=dev)
    if use_dda is not None:
        r.engine = "oracle"
        r._use_dda = use_dda
    return r


def _count_captures(monkeypatch):
    from volren_tpu_torch.ops import chunked

    captures, capture = [], chunked.Schedule._capture

    def counted(self, *args):
        captures.append(args[-1])
        return capture(self, *args)

    monkeypatch.setattr(chunked.Schedule, "_capture", counted)
    return captures


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("scene", PLAIN_SCENES)
def test_graph_replayed_render_plain_is_its_eager_per_step_run(scene, path, monkeypatch):
    """render_plain on the card, whose chunks replay as CUDA graphs, is
    bitwise its per-step schedule's run on the same tensors, with the same
    stats, at 64 x 64 and 4 spp."""
    from volren_tpu_torch.ops import chunked

    dev = _cuda()
    r = _path_renderer(dev, scene, path)
    ks = r._kernel_scene()
    pf, pi = build_params(ks, r._trace_params(), 64, 64, 0, 4)
    inputs = ks, r._env_pool(0), pf, pi
    captures = _count_captures(monkeypatch)
    stats = {}
    got = megakernel.render_plain(*inputs, stats=stats)
    assert captures
    monkeypatch.setattr(chunked, "_FORCE", False)
    want_stats = {}
    want = megakernel.render_plain(*inputs, stats=want_stats)
    assert torch.equal(got, want) and stats == want_stats
    assert stats["capped"] == 0 and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("use_dda,tf,emission", ORACLE_VARIANTS, ids=ORACLE_IDS)
@pytest.mark.parametrize("scene", PLAIN_SCENES)
def test_graph_replayed_oracle_is_its_eager_per_step_run(scene, use_dda, tf, emission,
                                                         monkeypatch):
    """The oracle's plain version on the card (its tracking loops' chunks
    replayed as CUDA graphs inside an eager bounce loop) is bitwise its
    per-step run, with the same stats: 2 passes at 64 x 64 from a non-zero
    framebuffer."""
    from volren_tpu_torch.ops import chunked, tracer

    dev = _cuda()
    path = {v: k for k, v in PATHS.items()}[(tf, emission)]
    scene_t, params, cfg = _oracle_inputs(_path_renderer(dev, scene, path, use_dda))
    fb0 = torch.rand(64, 64, 4, generator=torch.Generator().manual_seed(3)).to(dev)
    captures = _count_captures(monkeypatch)
    stats = {}
    got = tracer.trace_passes(scene_t, params, cfg, fb0, 2, 2, 64, 64, stats)
    assert captures
    monkeypatch.setattr(chunked, "_FORCE", False)
    want_stats = {}
    want = tracer.trace_passes(scene_t, params, cfg, fb0, 2, 2, 64, 64, want_stats)
    assert torch.equal(got, want) and stats == want_stats
    assert stats.get("capped", 0) == 0 and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("which", ["megakernel", "oracle"])
def test_plain_chunks_make_no_host_sync_and_return_their_memory(which, monkeypatch):
    """Every chunk of a plain version's call on the card, its graph's
    capture and replays included, runs under torch's sync debug mode
    "error" (its checks between chunks sync, outside them; the oracle's
    eager bounce loop holds its tracking loops' checks); and once the
    call returns, its graphs' memory is free again: memory_allocated is
    back to its value before the call (after a first call, which makes the
    process's constants)."""
    from volren_tpu_torch.ops import chunked, tracer

    dev = _cuda()
    r = _path_renderer(dev, "random16", "tf+emission", None if which == "megakernel" else True)
    if which == "megakernel":
        ks = r._kernel_scene()
        pf, pi = build_params(ks, r._trace_params(), 64, 64, 0, 4)
        inputs = ks, r._env_pool(0), pf, pi

        def call():
            return megakernel.render_plain(*inputs, stats={})
    else:
        scene_t, params, cfg = _oracle_inputs(r)
        fb0 = torch.zeros(64, 64, 4, device=dev)

        def call():
            return tracer.trace_passes(scene_t, params, cfg, fb0, 1, 2, 64, 64, {})
    want = call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    chunks, run = [], chunked.Schedule.run

    def strict_run(self, loop, step, state, steps, graph=True):
        if not graph:   # the oracle's bounce loop: its tracking loops check in it
            return run(self, loop, step, state, steps, graph)
        chunks.append(loop)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, loop, step, state, steps, graph)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(chunked.Schedule, "run", strict_run)
    captures = _count_captures(monkeypatch)
    got = call()
    assert chunks and captures and torch.equal(got, want)
    del got
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
