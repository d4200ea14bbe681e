"""The oracle engine of volren_tpu_torch (ops/tracer.py, its plain torch
version of csrc/oracle.cu) against volren_tpu's oracle engine
(volren_tpu/ops/tracer.py), with DDA tracking, and the engine's wiring
through ``Renderer``.

``Renderer(device="cpu")`` with ``engine = "oracle"`` renders the scene of
tests/test_render.py and is held per pixel to ``volren_tpu.renderer.
Renderer`` with ``engine = "oracle"`` (tests/oracle_reference.py has the
bar and the one known FMA flip); the global-majorant estimators
(``_use_dda = False``) are held in tests/test_torch_tracking.py. The
oracle is also held in the mean to the port's megakernel, as
tests/test_render.py:44 holds volren_tpu's engines. The CUDA kernel runs
only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from oracle_reference import RES, check_per_pixel, flame, oracle_case, port_renderer

from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.ops import tracer
from volren_tpu_torch.ops.kernels import oracle
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment
from volren_tpu_torch.voldata import DenseGrid, Volume

VARIANTS = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
            "tf+emission": (True, True)}


@pytest.fixture(scope="module")
def cases(random_grid16):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = oracle_case(random_grid16, True, *VARIANTS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dda_oracle_matches_jax_oracle_per_pixel(cases, variant):
    check_per_pixel(cases(variant))


@pytest.mark.parametrize("variant", ["plain", "tf", "emission"])
def test_oracle_matches_megakernel_in_the_mean(random_grid16, variant):
    """Same estimator, different draws: the oracle's and the megakernel's
    24-pass images agree in the mean within 5% (tests/test_render.py:44)."""
    r = port_renderer(random_grid16, True, *VARIANTS[variant])
    r.render(24)
    assert r.last_engine == "torch_oracle"
    of = r.fbo_data()
    r.engine = "megakernel"
    r.render(24)
    assert r.last_engine == "torch_plain"
    wf = r.fbo_data()
    assert abs(wf.mean() - of.mean()) / max(of.mean(), 1e-6) < 0.05, (wf.mean(), of.mean())


def test_progressive_passes_equal_one_batched_trace(random_grid16, monkeypatch):
    """trace(1) three times equals render(3) bitwise (the CPU traces
    several passes' lanes at once), and so does trace_pass pass by pass;
    none of it launches the CUDA kernel."""
    r = port_renderer(random_grid16, True, True, True)
    before = oracle.trace_pass.launches
    r.render(3)
    batch = r.framebuffer().clone()
    r.reset()
    r._fb = torch.zeros_like(r._fb)
    for _ in range(3):
        r.trace(1)
    assert torch.equal(r.framebuffer(), batch) and r.sample == 3
    scene, params, cfg = r._scene_tables(), r._trace_params(), r._config()
    fb = torch.zeros(RES, RES, 4)
    for s in (1, 2, 3):
        fb = oracle.trace_pass(scene, params, cfg, fb, s)
    assert torch.equal(fb, batch)
    monkeypatch.setattr(tracer, "PLAIN_LANES", RES * RES)   # one pass's lanes at a time
    small = tracer.trace_passes(scene, params, cfg, torch.zeros(RES, RES, 4), 1, 3, RES, RES)
    assert torch.equal(small, batch)
    assert oracle.trace_pass.launches == before


def test_split_traces_fold_in_pass_order(random_grid16):
    """trace(5) equals trace(2) then trace(3) bitwise: each call folds its
    passes into the running mean after the earlier calls' passes, in pass
    order, as the kernel's launches do (one launch per call)."""
    r = port_renderer(random_grid16, True, False, False)
    r.init(16, 16)
    r.render(5)
    assert r.framebuffer().shape == (16, 16, 4)
    whole = r.framebuffer().clone()
    r.render(2)
    r.trace(3)
    assert r.sample == 5 and torch.equal(r.framebuffer(), whole)


def test_the_step_cap_stops_loop_calls_and_is_counted(random_grid16):
    """Every tracking loop call stops after max_steps iterations with its
    state as it stands; the plain version counts those calls. The 8192 cap
    binds on no call of this scene."""
    r = port_renderer(random_grid16, True, False, False)
    scene, params, cfg = r._scene_tables(), r._trace_params(), r._config()
    fb = torch.zeros(RES, RES, 4)
    stats = {}
    full = oracle.trace_passes(scene, params, cfg, fb, 1, 2, stats)
    assert stats.get("capped", 0) == 0 and stats["paths"] == 2 * RES * RES
    assert stats["sample_volume_dda_iters"] > 0 and stats["transmittance_dda_iters"] > 0
    capped_stats = {}
    capped = oracle.trace_passes(scene, params, cfg._replace(max_steps=2), fb, 1, 2,
                                 capped_stats)
    assert capped_stats.get("capped", 0) > 0
    assert np.isfinite(capped.numpy()).all() and not torch.equal(capped, full)


def test_engine_switches_and_the_megakernel_refuses_no_dda(random_grid16):
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment.white(0.5))
    r.bounces = 4
    r.init(8, 8)
    r.commit()
    assert r.engine == "megakernel" and r._use_dda and r.describe()["engine"] == "megakernel"
    r._use_dda = False
    with pytest.raises(NotImplementedError, match="engine='oracle'"):
        r.trace(1)
    r.engine = "oracle"
    r.trace(2)
    assert r.last_engine == "torch_oracle" and r.sample == 2
    assert r.describe()["engine"] == "oracle" and r._config() == tscene.TraceConfig(use_dda=False)
    r.engine = "wavefront"
    assert r.engine == "megakernel"
    with pytest.raises(ValueError, match="unknown engine"):
        r.engine = "nope"


def test_config_takes_the_current_frames_emission_grid(random_grid16):
    """An animation whose second frame has no emission grid: the oracle's
    switches follow the current frame's own entry (volren_tpu's
    ``frame < len(...)`` test is a recorded fault, ROADMAP Queue 3)."""
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
    r.volume.update_grid_frame(0, DenseGrid(16, 16, 16, flame()), "flame")
    r.volume.update_grid_frame(1, DenseGrid(16, 16, 16, random_grid16), "density")
    r.scale_and_move_to_unit_cube()
    r.init(8, 8)
    r.commit()
    r.engine = "oracle"
    assert r._config().has_emission and r._scene_tables().emission is not None
    r.volume.grid_frame_counter = 1
    assert not r._config().has_emission and r._scene_tables().emission is None
    r.trace(1)
    assert np.isfinite(r.fbo_data()).all()


def test_the_wrapper_refuses_a_config_of_another_variant(random_grid16):
    r = port_renderer(random_grid16, True, True, False)
    scene, params, cfg = r._scene_tables(), r._trace_params(), r._config()
    with pytest.raises(ValueError, match="variant"):
        oracle.trace_pass(scene, params, cfg._replace(use_tf=False), torch.zeros(RES, RES, 4), 1)
    pf, pi = oracle.build_params(scene, params, cfg, RES, RES, 5, 3)
    assert pi[oracle.OI_FIRST_SAMPLE] == 5 and pi[oracle.OI_N_PASSES] == 3
    assert tracer.pass_weight(5) == np.float32(1) / np.float32(5)
    assert pi[oracle.OI_IMP_LEVELS] == 10 and pi[oracle.OI_IMP_DIM] == 512
    assert pi[oracle.OI_TF_SIZE] == scene.tf.lut.shape[0] and pi[oracle.OI_EMI_N_SLOTS] == 0


def test_trace_stats_needs_a_pass(random_grid16):
    """The STATS twin traces at least one pass: a launch of none would
    leave its framebuffer unwritten and time no block."""
    r = port_renderer(random_grid16, True, False, False)
    scene, params, cfg = r._scene_tables(), r._trace_params(), r._config()
    for n in (0, -1):
        with pytest.raises(ValueError, match="at least one pass"):
            oracle.trace_stats(scene, params, cfg, torch.zeros(RES, RES, 4), 1, n)
