"""The CUDA megakernel on the card. Every test here skips without a CUDA
device. The module imports no JAX, so it also runs where JAX is absent,
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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


def _renderer(device, seed=123, tf=False, emission=False, width=RES, height=RES, env=None):
    """The 16^3 test scene; ``tf`` adds a non-monotone LUT with a moved
    window, ``emission`` a radial temperature grid at half resolution.
    ``env``: the scene's sky, Environment(procedural_sky(64, 32, seed=4)),
    if made already."""
    r = Renderer(device=device)
    r.volume = Volume(DenseGrid(16, 16, 16, _grid16()))
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


def test_probe_row_scan_matches_cumsum():
    from volren_tpu_torch.ops.kernels import probes as K

    x = torch.from_numpy(np.random.default_rng(0).random((8, 128), np.float32)).to(_cuda())
    before = K.row_scan.launches
    got = K.row_scan(x)
    assert K.row_scan.launches == before + 1
    torch.testing.assert_close(got, K.row_scan_plain(x), rtol=1e-5, atol=0)


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
