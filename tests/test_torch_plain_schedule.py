"""The chunked schedule of the plain versions (volren_tpu_torch/ops/chunked.py)
on the CPU, where a test forces it.

On the card, ``megakernel.render_plain`` and the oracle's
``tracer.trace_passes`` check how many lanes still run once a chunk of
steps instead of once a step, and set the ended lanes aside to powers of
two; their guarded phases run on every lane and their counts add up on the
device. A step's lanes are independent, so the chunked schedule must give
the per-step schedule's output bitwise, with the same ``stats``: here on a
random 16^3 grid at 16x16, for every variant, with the packed tables, at
chunks of 1, 16 and 7 steps (7 divides no step count here), with chunks
bound by their lanes, with the card's constants, and with the step cap
binding. Forced onto the chunked schedule, both plain versions
still match the JAX package with the bars of tests/test_torch_megakernel.py
and tests/test_torch_oracle.py. The CUDA graphs that replay the chunks on
the card are held in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from oracle_reference import check_per_pixel, oracle_case, port_renderer
from torch_reference import jax_renderer, mean_rel, reference_case, rmse

from volren_tpu_torch.ops import chunked, tracer
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment, procedural_sky
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.voldata import DenseGrid, Volume

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

RES, SPP, PASSES = 16, 4, 2
VARIANTS = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
            "tf+emission": (True, True)}
ORACLE_VARIANTS = [(dda, tf, emi) for dda in (True, False) for tf in (False, True)
                   for emi in (False, True)]
ORACLE_IDS = [f"{'dda' if d else 'delta'}{'-tf' if t else ''}{'-emi' if e else ''}"
              for d, t, e in ORACLE_VARIANTS]
# the schedules: (chunk steps, lane-steps bound, lane floor), None the
# card's constants (4 steps a chunk on these few lanes, none set aside);
# chunks of 1 step, of 16, of 7 (which divides no step count here), and of
# 8 steps bound to 2048 lane-steps (2 steps on 1024 lanes, 8 on 256)
SCHEDULES = {"1": (1, 1 << 30, 1), "16": (16, 1 << 30, 1), "7": (7, 1 << 30, 1),
             "scaled": (8, 2048, 64), "card": None}


def _scene(grid, tf, emission, packs):
    """The 16^3 scene at RES x RES under a procedural sky, 16 bounces (the
    --fau-like LUT with a moved window, a radial temperature grid), on the
    float32 tables or with all three packed tables: the plain version's
    (KernelScene, pool, pf, pi) of SPP samples."""
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, grid))
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(procedural_sky(64, 32, seed=4)))
    r.bounces = 16
    r.seed = 123
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
    if packs:
        r.pallas_mip_u8, r.pallas_env_rgbe, r.pallas_pool_rgbe = "1", True, True
    r.init(RES, RES)
    r.commit()
    ks = r._kernel_scene()
    pf, pi = tpack.build_params(ks, r._trace_params(), RES, RES, 0, SPP)
    return ks, r._env_pool(0), pf, pi


def _chunked(monkeypatch, schedule="card"):
    """The chunked schedule SCHEDULES[schedule] on the CPU."""
    monkeypatch.setattr(chunked, "_FORCE", True)
    if SCHEDULES[schedule] is not None:
        for name, v in zip(("_CHUNK", "_LANE_STEPS", "_MIN_LANES"), SCHEDULES[schedule]):
            monkeypatch.setattr(chunked, name, v)


@pytest.fixture(scope="module")
def megakernel_cases(random_grid16):
    """(inputs, per-step image, per-step stats) of each (variant, packs)."""
    cache = {}

    def get(variant, packs, budget=None):
        key = (variant, packs, budget)
        if key not in cache:
            ks, pool, pf, pi = _scene(random_grid16, *VARIANTS[variant], packs)
            if budget is not None:
                pi = pi.copy()
                pi[tpack.PI_MAX_ITERS] = budget
            stats = {}
            image = megakernel.render_plain(ks, pool, pf, pi, stats=stats)
            cache[key] = (ks, pool, pf, pi), image, stats
        return cache[key]
    return get


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("packs", [False, True], ids=["f32", "packed"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chunked_render_plain_is_the_per_step_one(megakernel_cases, monkeypatch, variant,
                                                  packs, schedule):
    inputs, want, want_stats = megakernel_cases(variant, packs)
    _chunked(monkeypatch, schedule)
    stats = {}
    got = megakernel.render_plain(*inputs, stats=stats)
    assert torch.equal(got, want)
    assert stats == want_stats
    assert stats["capped"] == 0 and stats["test"] > 0 and stats["nee"] > 0
    assert ("march_level0" in stats) == packs and ("emission" in stats) == VARIANTS[variant][1]


@pytest.mark.parametrize("schedule", ["7", "16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chunked_render_plain_caps_the_same_samples(megakernel_cases, monkeypatch, variant,
                                                    schedule):
    """A budget of 12 substeps caps samples: the chunked schedule's last
    chunk stops at the budget (chunks of 7: 7 + 5; of 16: one of 12) and
    caps and counts the same samples."""
    inputs, want, want_stats = megakernel_cases(variant, False, budget=12)
    assert want_stats["capped"] > 0
    _chunked(monkeypatch, schedule)
    stats = {}
    got = megakernel.render_plain(*inputs, stats=stats)
    assert torch.equal(got, want) and stats == want_stats


def test_render_plain_on_the_cpu_runs_per_step(megakernel_cases, monkeypatch):
    """The CPU's default schedule is the per-step one: no chunk runs."""
    inputs, want, _stats = megakernel_cases("plain", False)

    def refuse(*args, **kwargs):
        raise AssertionError("a chunk ran on the CPU's default schedule")

    monkeypatch.setattr(chunked.Schedule, "run", refuse)
    assert torch.equal(megakernel.render_plain(*inputs), want)


@pytest.fixture(scope="module")
def oracle_cases(random_grid16):
    """(scene, params, cfg) of each instantiation and its per-step passes
    and stats (PASSES passes from a non-zero framebuffer), by max_steps."""
    cache = {}

    def get(v, max_steps=None):
        if (v, max_steps) not in cache:
            r = port_renderer(random_grid16, *v)
            scene, params, cfg = r._scene_tables(), r._trace_params(), r._config()
            if max_steps is not None:
                cfg = cfg._replace(max_steps=max_steps)
            fb = torch.rand(RES, RES, 4, generator=torch.Generator().manual_seed(3))
            stats = {}
            out = tracer.trace_passes(scene, params, cfg, fb, 2, PASSES, RES, RES, stats)
            cache[v, max_steps] = (scene, params, cfg, fb), out, stats
        return cache[v, max_steps]
    return get


def _passes(inputs, stats):
    scene, params, cfg, fb = inputs
    return tracer.trace_passes(scene, params, cfg, fb, 2, PASSES, RES, RES, stats)


@pytest.mark.parametrize("schedule", ["16", "7", "scaled", "card"])
@pytest.mark.parametrize("v", ORACLE_VARIANTS, ids=ORACLE_IDS)
def test_chunked_oracle_is_the_per_step_one(oracle_cases, monkeypatch, v, schedule):
    inputs, want, want_stats = oracle_cases(v)
    _chunked(monkeypatch, schedule)
    stats = {}
    assert torch.equal(_passes(inputs, stats), want)
    assert stats == want_stats
    loops = ("sample_volume_dda", "transmittance_dda") if v[0] else \
        ("sample_volume", "transmittance")
    assert all(stats[f"{name}_iters"] > 0 for name in (*loops, "bounce"))
    assert stats["paths"] == PASSES * RES * RES and stats.get("capped", 0) == 0


@pytest.mark.parametrize("v", ORACLE_VARIANTS, ids=ORACLE_IDS)
def test_chunked_oracle_caps_the_same_loop_calls(oracle_cases, monkeypatch, v):
    """max_steps 3 stops many tracking loop calls mid-loop: the chunked
    loops run 2 steps, check, then the last alone, and stop and count the
    same calls."""
    inputs, want, want_stats = oracle_cases(v, max_steps=3)
    assert want_stats["capped"] > 0
    _chunked(monkeypatch, "16")
    stats = {}
    assert torch.equal(_passes(inputs, stats), want) and stats == want_stats


@pytest.mark.parametrize("which", ["megakernel", "oracle-dda", "oracle-delta"])
def test_no_step_builds_a_tensor_from_host_data(megakernel_cases, oracle_cases, monkeypatch,
                                                which):
    """No step of a chunk calls torch.tensor (a copy from host data, which
    on the card waits for the device, and which a CUDA graph cannot
    replay): the TF + emission variants, which read every constant. The
    constants are made once a process and value, so a warm-up call comes
    first."""
    if which == "megakernel":
        inputs, want, _stats = megakernel_cases("tf+emission", True)

        def run():
            return megakernel.render_plain(*inputs)
    else:
        inputs, want, _stats = oracle_cases((which == "oracle-dda", True, True))

        def run():
            return _passes(inputs, None)
    _chunked(monkeypatch, "7")
    assert torch.equal(run(), want)
    made, chunks, run_chunk = [], [], chunked.Schedule.run
    tensor = torch.tensor

    def counting_tensor(*args, **kwargs):
        made.append(args)
        return tensor(*args, **kwargs)

    def watched_run(self, *args, **kwargs):
        chunks.append(args[0])
        torch.tensor = counting_tensor
        try:
            return run_chunk(self, *args, **kwargs)
        finally:
            torch.tensor = tensor

    monkeypatch.setattr(chunked.Schedule, "run", watched_run)
    assert torch.equal(run(), want)
    assert chunks and not made, (len(chunks), made[:3])


def test_chunked_render_plain_matches_the_pallas_kernel(random_grid16, monkeypatch):
    """Forced onto the chunked schedule, the plain version holds the bars of
    tests/test_torch_megakernel.py against the Pallas kernel (interpret
    mode) and the chunked XLA engine: every pixel within 1e-4, RMSE below
    1.5x the seed-to-seed noise, the mean within 5%."""
    _chunked(monkeypatch, "7")
    r = jax_renderer(random_grid16)
    r.commit()
    case = reference_case(r)
    got, ref = case["plain"], case["pallas"]
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-4
    assert rmse(got, ref) < 1.5 * case["noise"] and mean_rel(got, ref) < 0.05
    chunk = case["chunked"][0]
    assert rmse(got, chunk) < 1.5 * case["noise"] and mean_rel(got, chunk) < 0.05


def test_chunked_oracle_matches_the_jax_oracle_per_pixel(random_grid16, monkeypatch):
    """Forced onto the chunked schedule, the port's DDA oracle with TF and
    emission holds the bar of tests/test_torch_oracle.py against
    volren_tpu's: every pixel within 1e-4 but the known FMA flips, RMSE
    below 1.5x the noise, mean within 5%."""
    _chunked(monkeypatch, "7")
    check_per_pixel(oracle_case(random_grid16, True, True, True))
