"""The oracle engine's building blocks in volren_tpu_torch (ops/tracking.py,
grid.py, envmap.py, raymarch.py) against volren_tpu's, and the
global-majorant estimators end to end.

- ``Renderer(device="cpu")`` with ``engine = "oracle"`` and
  ``_use_dda = False`` (delta and ratio tracking) against volren_tpu's
  oracle on the scene of tests/test_render.py, per pixel
  (tests/oracle_reference.py).
- Function by function, on the same tables through
  ``ops.scene.from_reference``: the hierarchical environment warp and its
  pdf, the grid lookups and stochastic filters, the four tracking
  functions (their final seeds count the draws, and so the loop
  iterations: exact) with and without a binding step cap, ray marching and
  DVR. The JAX functions run jitted on the CPU (the warp op by op: see
  its test).
- The closed-form and estimator-agreement patterns of
  tests/test_tracking.py and tests/test_raymarch.py, on in-repo scenes
  (the TF case with the CLI's ``--fau`` LUT).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_reference import check_per_pixel, oracle_case, port_scene
from test_tracking import CFG, CFG_DDA, make_scene, seeds

from volren_tpu.ops import envmap as jenvmap
from volren_tpu.ops import grid as jgrid
from volren_tpu.ops import raymarch as jraymarch
from volren_tpu.ops import scene as jscene
from volren_tpu.ops import tracking as jtracking
from volren_tpu.ops.scene import TraceConfig as JTraceConfig
from volren_tpu.scene.environment import Environment as JEnvironment
from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu_torch.cli import FAU_LUT
from volren_tpu_torch.ops import envmap, grid, raymarch, tracking
from volren_tpu_torch.ops import rng as trng
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.scene.environment import Environment
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.voldata import build_brick_grid

VARIANTS = {"plain": (False, False), "tf": (True, False), "emission": (False, True),
            "tf+emission": (True, True)}


def _seeds(n, stream=0):
    """tests/test_tracking.py's seeds, as the port's int64 lanes."""
    return torch.tensor(np.asarray(seeds(n, stream)).astype(np.int64))


def _t(a):
    return torch.tensor(np.array(a))


def _rays(n, seed, lo=-7.0, span=30.0):
    rng = np.random.default_rng(seed)
    org = (rng.random((n, 3)) * span + lo).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d.astype(np.float32)


@pytest.fixture(scope="module")
def cases(random_grid16):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = oracle_case(random_grid16, False, *VARIANTS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_delta_tracking_oracle_matches_jax_oracle_per_pixel(cases, variant):
    check_per_pixel(cases(variant))


# ---- function by function, through from_reference

@pytest.fixture(scope="module")
def scene_pair(random_grid16):
    """The random 16^3 grid at density scale 0.5 with a small random sky,
    the --fau LUT and the radial flame as an emission grid, in both
    packages."""
    return _scene_pair(random_grid16)


def _scene_pair(dense):
    jsc, jparams = make_scene(dense, density_scale=0.5)
    rng = np.random.default_rng(5)
    env = JEnvironment((rng.random((8, 16, 3)) * 0.9 + 0.05).astype(np.float32))
    env.strength = 1.5
    zz, yy, xx = np.meshgrid(*([np.arange(16)] * 3), indexing="ij")
    temp = np.clip(1.0 - np.sqrt((xx - 8) ** 2 + (yy - 8) ** 2 + (zz - 8) ** 2) / 8.0, 0, 1)
    emi = jscene.upload_grid(build_brick_grid(temp.astype(np.float32), np.diag([2, 2, 2, 1])),
                             np.eye(4, dtype=np.float32))
    jsc = jsc._replace(env=jscene.upload_environment(env), emission=emi,
                       tf=jscene.upload_transferfunc(JTransferFunction(FAU_LUT)))
    jparams = jparams._replace(emission_scale=jnp.float32(30.0), emission_norm=jnp.float32(1.0))
    tsc, tparams = port_scene(jsc, jparams)
    return jsc, jparams, tsc, tparams


def test_environment_warp_and_pdf_match_jax(scene_pair):
    """The warp, its pdf and the lookup against volren_tpu's functions run
    op by op (``jax.disable_jit``): within 1e-6, Le and pdf bitwise. Under
    jit, XLA fuses the warp's arithmetic and a few lanes of 4096 walk to a
    neighbouring texel (pdf off by 5e-4); the port keeps every operation's
    rounding, as csrc/oracle.cu does."""
    jsc, _, tsc, _ = scene_pair
    u2 = np.random.default_rng(1).random((4096, 2)).astype(np.float32)
    _, d = _rays(4096, 2)
    with jax.disable_jit():
        want = jenvmap.sample_environment(jsc.env, jnp.asarray(u2))
        pdf = jenvmap.pdf_environment(jsc.env, jnp.asarray(d))
        le = jenvmap.lookup_environment(jsc.env, jnp.asarray(d))
    got = envmap.sample_environment(tsc.env, _t(u2))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(envmap.pdf_environment(tsc.env, _t(d)).numpy(), np.asarray(pdf),
                               rtol=0, atol=1e-6)
    # the lookup's bilinear weights come from acos / atan2 of a matrix
    # product that XLA's dot rounds its own way: a few ulp on this rough sky
    np.testing.assert_allclose(envmap.lookup_environment(tsc.env, _t(d)).numpy(), np.asarray(le),
                               rtol=1e-5, atol=1e-6)


def test_grid_lookups_and_filters_match_jax(scene_pair):
    """Index work is exact; a decode may differ by the ulp of XLA's fused
    multiply-add; the filters' taps and final seeds are exact."""
    jsc, jparams, tsc, _ = scene_pair
    g, tg = jsc.density, tsc.density
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.uniform(-3.0, 19.0, (20000, 3)),
                          rng.uniform(-0.51, 0.51, (2000, 3))]).astype(np.float32)
    tpos = _t(pos)
    for a, b in zip(jax.jit(jgrid._brick_index)(g, pos), grid._brick_index(tg, tpos)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    mip = rng.integers(0, 4, len(pos)).astype(np.int32)
    np.testing.assert_array_equal(grid._majorant_index(tg, tpos, _t(mip)).numpy(),
                                  np.asarray(jax.jit(jgrid._majorant_index)(g, pos, mip)))
    np.testing.assert_array_equal(grid.lookup_majorant(tg, tpos, _t(mip), 0.5).numpy(),
                                  np.asarray(jgrid.lookup_majorant(g, pos, mip, 0.5)))
    for jfn, fn in ((jgrid.lookup_density, grid.lookup_density),
                    (jgrid.lookup_density_trilinear, grid.lookup_density_trilinear)):
        np.testing.assert_allclose(fn(tg, tpos, 0.5).numpy(),
                                   np.asarray(jax.jit(jfn)(g, pos, 0.5)), rtol=1e-6, atol=1e-6)
    s = seeds(len(pos), 4)
    active = rng.random(len(pos)) < 0.8
    for jfn, fn in ((jgrid.stochastic_trilinear_filter, grid.stochastic_trilinear_filter),
                    (jgrid.stochastic_tricubic_filter, grid.stochastic_tricubic_filter)):
        jtap, js = jax.jit(jfn)(pos, s, active)
        tap, ts = fn(tpos, _seeds(len(pos), 4), _t(active))
        np.testing.assert_array_equal(tap.numpy(), np.asarray(jtap))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    je, js = jax.jit(jgrid.lookup_emission)(jsc.emission, g.transform, pos, s, active,
                                            jparams.emission_scale, jparams.emission_norm)
    te, ts = grid.lookup_emission(tsc.emission, tg.transform, tpos, _seeds(len(pos), 4),
                                  _t(active), 30.0, 1.0)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


TRACKERS = {
    "transmittance": (jtracking.transmittance, tracking.transmittance, False),
    "transmittance_dda": (jtracking.transmittance_dda, tracking.transmittance_dda, True),
    "sample_volume": (jtracking.sample_volume, tracking.sample_volume, False),
    "sample_volume_dda": (jtracking.sample_volume_dda, tracking.sample_volume_dda, True),
}


@pytest.mark.parametrize("max_steps", [4096, 3])
@pytest.mark.parametrize("name", list(TRACKERS))
def test_tracking_matches_jax(scene_pair, name, max_steps):
    """Random rays through the grid, a fifth of them inactive, with the TF
    and the emission grid on the sample functions: the final seed of each
    lane (its draws, so its loop iterations) and the hit flags are exact;
    t, Tr, throughput and radiance agree to float rounding. With
    max_steps = 3 the cap stops most lanes mid-loop, and the state they
    stop with is the same."""
    jsc, jparams, tsc, tparams = scene_pair
    jfn, fn, dda = TRACKERS[name]
    sample = name.startswith("sample")
    cfg = JTraceConfig(use_dda=dda, use_tf=sample, has_emission=sample, max_steps=max_steps)
    tcfg = tscene.TraceConfig(use_dda=dda, use_tf=sample, has_emission=sample,
                              max_steps=max_steps)
    jsc_c = jsc if sample else jsc._replace(tf=None, emission=None)
    tsc_c = tsc if sample else tsc._replace(tf=None, emission=None)
    n = 4096
    org, d = _rays(n, 7)
    active = np.random.default_rng(8).random(n) < 0.8
    if sample:
        th = np.random.default_rng(9).uniform(0.2, 1.0, (n, 3)).astype(np.float32)
        le = np.zeros((n, 3), np.float32)
        want = jax.jit(functools.partial(jfn, cfg=cfg))(
            jsc_c, jparams, org=org, direction=d, throughput=th, le=le, seed=seeds(n, 5),
            active=active)
        stats = {}
        got = fn(tsc_c, tparams, tcfg, _t(org), _t(d), _t(th), _t(le), _seeds(n, 5),
                 _t(active), stats)
        hit, t, th_j, le_j, s_j = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got[4].numpy(), s_j.astype(np.int64))
        np.testing.assert_array_equal(got[0].numpy(), hit)
        # a collision's t = t_adv + tau_adv / maj, where XLA fuses tau_adv =
        # tau - maj * dt into an FMA: a small difference of large terms
        np.testing.assert_allclose(got[1].numpy()[hit], t[hit], rtol=1e-5, atol=1e-5)
        # the TF colour and the emission at a collision carry t's difference
        np.testing.assert_allclose(got[2].numpy(), th_j, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[3].numpy(), le_j, rtol=1e-4, atol=1e-5)
    else:
        tr, s = jax.jit(functools.partial(jfn, cfg=cfg))(
            jsc_c, jparams, org=org, direction=d, seed=seeds(n, 5), active=active)
        stats = {}
        ttr, ts = fn(tsc_c, tparams, tcfg, _t(org), _t(d), _seeds(n, 5), _t(active), stats)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s).astype(np.int64))
        np.testing.assert_allclose(ttr.numpy(), np.asarray(tr), rtol=1e-5, atol=1e-6)
    iters = stats[f"{name}_iters"]
    assert iters > 0 and (stats.get("capped", 0) > 0) == (max_steps == 3)


def test_raymarch_and_dvr_match_jax(scene_pair):
    jsc, jparams, tsc, tparams = scene_pair
    n = 2048
    org, d = _rays(n, 11)
    active = np.ones(n, bool)
    for use_tf in (False, True):
        cfg = JTraceConfig(use_dda=False, use_tf=use_tf, has_emission=False)
        tcfg = tscene.TraceConfig(use_dda=False, use_tf=use_tf)
        jsc_c = jsc if use_tf else jsc._replace(tf=None)
        tsc_c = tsc if use_tf else tsc._replace(tf=None)
        tr, s = jax.jit(functools.partial(jraymarch.transmittance_raymarch, cfg=cfg))(
            jsc_c, jparams, org=org, direction=d, seed=seeds(n, 2), active=active)
        ttr, ts = raymarch.transmittance_raymarch(tsc_c, tparams, tcfg, _t(org), _t(d),
                                                  _seeds(n, 2), _t(active))
        np.testing.assert_allclose(ttr.numpy(), np.asarray(tr), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s).astype(np.int64))
    cfg = JTraceConfig(use_dda=False, use_tf=True, has_emission=False)
    rad, _ = jax.jit(functools.partial(jraymarch.direct_volume_rendering, cfg=cfg))(
        jsc, jparams, org=org, direction=d, seed=seeds(n, 3), active=active)
    trad, _ = raymarch.direct_volume_rendering(tsc, tparams, tscene.TraceConfig(use_tf=True),
                                               _t(org), _t(d), _seeds(n, 3), _t(active))
    np.testing.assert_allclose(trad.numpy(), np.asarray(rad), rtol=1e-5, atol=1e-5)


# ---- closed forms and estimator agreement (the port alone)

def _port_scene(dense, density_scale=1.0, transform=None):
    """tests/test_tracking.py::make_scene, built by the port alone."""
    bg = build_brick_grid(np.asarray(dense, np.float32), transform)
    maj = max(bg.minorant_majorant()[1] * density_scale, 1e-20)
    f32 = np.float32
    params = tscene.TraceParams(
        cam_pos=np.zeros(3, f32), cam_transform=np.eye(3, dtype=f32), cam_fov=40.0,
        bb_min=np.zeros(3, f32), bb_max=np.asarray(bg.voxel_extent, f32),
        majorant=float(f32(maj)), inv_majorant=float(f32(1.0 / maj)),
        albedo=np.full(3, 0.8, f32), phase_g=0.0, density_scale=float(f32(density_scale)),
        bounces=100, show_environment=1, seed=42)
    scene = tscene.SceneTables(
        density=tscene.upload_grid(bg, np.eye(4, dtype=f32), "cpu"), emission=None,
        env=tscene.upload_environment(Environment.white(0.5), "cpu"), tf=None)
    return scene, params


def _port_tf(scene, lut):
    return scene._replace(tf=tscene.upload_transferfunc(TransferFunction(lut), "cpu"))


def test_constant_density_transmittance_closed_form():
    """Tr through constant density sigma over length L is exp(-sigma L),
    for ratio tracking and for DDA tracking."""
    sigma = 0.35
    dense = np.full((16, 16, 16), sigma, np.float32)
    dense[0, 0, 0] = sigma * 1.0001
    scene, params = _port_scene(dense)
    n = 40_000
    org = torch.tensor([[-5.0, 8.0, 8.0]]).repeat(n, 1)
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    active = torch.ones(n, dtype=torch.bool)
    for cfg, fn in ((CFG, tracking.transmittance), (CFG_DDA, tracking.transmittance_dda)):
        tr, _ = fn(scene, params, tscene.TraceConfig(cfg.use_dda, max_steps=4096), org, d,
                   _seeds(n), active)
        assert abs(float(tr.mean()) - np.exp(-sigma * 16.0)) < 0.01, fn.__name__


def test_transmittance_outside_box_is_one():
    scene, params = _port_scene(np.ones((8, 8, 8), np.float32))
    for use_dda, fn in ((False, tracking.transmittance), (True, tracking.transmittance_dda)):
        tr, _ = fn(scene, params, tscene.TraceConfig(use_dda), torch.tensor([[20.0, 20, 20]]),
                   torch.tensor([[1.0, 0, 0]]), _seeds(1), torch.ones(1, dtype=torch.bool))
        assert float(tr[0]) == 1.0


def test_sample_volume_free_flight_distribution():
    """In constant density, P(no collision) = exp(-sigma L), collision t's
    follow a truncated exponential, and a hit multiplies the throughput by
    the albedo once."""
    sigma, length = 0.25, 16.0
    dense = np.full((16, 16, 16), sigma, np.float32)
    dense[0, 0, 0] = sigma * 1.0001
    scene, params = _port_scene(dense)
    n = 40_000
    org = torch.tensor([[-3.0, 8.0, 8.0]]).repeat(n, 1)
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    for use_dda, fn in ((False, tracking.sample_volume), (True, tracking.sample_volume_dda)):
        hit, t, th, _le, _ = fn(scene, params, tscene.TraceConfig(use_dda, max_steps=4096),
                                org, d, torch.ones(n, 3), torch.zeros(n, 3), _seeds(n, 3),
                                torch.ones(n, dtype=torch.bool))
        hit = hit.numpy()
        assert abs((1.0 - hit.mean()) - np.exp(-sigma * length)) < 0.01, fn.__name__
        expect = 1 / sigma - length * np.exp(-sigma * length) / (1 - np.exp(-sigma * length))
        assert abs((t.numpy()[hit] - 3.0).mean() - expect) < 0.05, fn.__name__
        np.testing.assert_allclose(th.numpy()[hit][:, 0], 0.8, rtol=1e-6)


@pytest.mark.parametrize("use_tf", [False, True], ids=["density", "fau_tf"])
def test_dda_and_delta_tracking_agree_on_heterogeneous_grid(random_grid16, use_tf):
    """Both estimators are unbiased for the same integral. With the --fau
    LUT (alpha made monotone by the CDF rewrite), the TF-classified local
    majorant still bounds the density, so DDA-TF tracking stays unbiased."""
    scene, params = _port_scene(random_grid16, density_scale=1.0 if use_tf else 0.5)
    if use_tf:
        scene = _port_tf(scene, FAU_LUT)
        assert (np.diff(scene.tf.lut[:, 3].numpy()) >= -1e-7).all()
    n = 30_000
    org, d = _rays(n, 9 if use_tf else 3)
    active = torch.ones(n, dtype=torch.bool)
    tr_a, _ = tracking.transmittance(scene, params, tscene.TraceConfig(False, use_tf, False, 4096),
                                     _t(org), _t(d), _seeds(n, 11 if use_tf else 5), active)
    tr_b, _ = tracking.transmittance_dda(scene, params,
                                         tscene.TraceConfig(True, use_tf, False, 4096),
                                         _t(org), _t(d), _seeds(n, 12 if use_tf else 6), active)
    ma, mb = float(tr_a.mean()), float(tr_b.mean())
    assert abs(ma - mb) < 0.01, (ma, mb)


@pytest.mark.parametrize("use_tf", [False, True], ids=["density", "fau_tf"])
def test_delta_and_dda_emission_gap_is_the_references(use_tf):
    """Delta tracking and DDA tracking collect different emission: the
    reference's DDA sample weights it by the global inverse majorant while
    it tests collisions at the local majorant's rate
    (volren_tpu/ops/tracking.py:12-19), so where a brick's majorant lies
    below the global one it counts less of it. On a thin grid with one
    dense brick, the JAX functions show that gap on the same rays and
    seeds, and the port's gap is the same; so the port's delta/DDA
    difference in emission images (chip_smoke.py phase 10.3) is the
    reference's, not a port fault."""
    dense = np.full((16, 16, 16), 0.2, np.float32)
    dense[:8, :8, :8] = 3.0
    jsc, jparams, tsc, tparams = _scene_pair(dense)
    n = 8192
    org, d = _rays(n, 13)
    th = np.ones((n, 3), np.float32)
    le = np.zeros((n, 3), np.float32)
    active = np.ones(n, bool)
    means = {}
    for dda in (False, True):
        jfn, fn = ((jtracking.sample_volume_dda, tracking.sample_volume_dda) if dda
                   else (jtracking.sample_volume, tracking.sample_volume))
        cfg = JTraceConfig(use_dda=dda, use_tf=use_tf, has_emission=True, max_steps=4096)
        tcfg = tscene.TraceConfig(use_dda=dda, use_tf=use_tf, has_emission=True,
                                  max_steps=4096)
        jsc_c = jsc if use_tf else jsc._replace(tf=None)
        tsc_c = tsc if use_tf else tsc._replace(tf=None)
        want = jax.jit(functools.partial(jfn, cfg=cfg))(
            jsc_c, jparams, org=org, direction=d, throughput=th, le=le, seed=seeds(n, 14),
            active=active)
        got = fn(tsc_c, tparams, tcfg, _t(org), _t(d), _t(th), _t(le), _seeds(n, 14),
                 _t(active))
        means[dda] = float(np.asarray(want[3]).mean()), float(got[3].mean())
    gap_jax = means[False][0] / means[True][0] - 1.0
    gap_port = means[False][1] / means[True][1] - 1.0
    assert gap_jax > 0.5, means
    assert abs(gap_port - gap_jax) < 1e-3, (gap_port, gap_jax)


def test_raymarch_transmittance_and_dvr_closed_forms():
    sigma = 0.3
    dense = np.full((16, 16, 16), sigma, np.float32)
    dense[0, 0, 0] = sigma * 1.0001
    scene, params = _port_scene(dense)
    n = 20000
    org = torch.tensor([[-5.0, 8.0, 8.0]]).repeat(n, 1)
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    tr, _ = raymarch.transmittance_raymarch(scene, params, tscene.TraceConfig(use_dda=False),
                                            org, d, _seeds(n), torch.ones(n, dtype=torch.bool))
    assert abs(float(tr.mean()) - np.exp(-sigma * 16)) < 0.01
    # constant white TF: L = sum over the 64-step left Riemann sum
    # (common.glsl:583-588), plus env * Tr
    scene = _port_tf(scene, [(1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0)])._replace(env=None)
    rad, _ = raymarch.direct_volume_rendering(scene, params, tscene.TraceConfig(use_tf=True),
                                              org[:4096], d[:4096], _seeds(4096, 2),
                                              torch.ones(4096, dtype=torch.bool))
    dtau = params.majorant * 16.0 / raymarch.RAYMARCH_STEPS
    expect = dtau * (1 - np.exp(-raymarch.RAYMARCH_STEPS * dtau)) / (1 - np.exp(-dtau))
    assert abs(float(rad[:, 0].mean()) - expect) < 0.02


def test_masked_draws_advance_only_active_lanes():
    s = torch.arange(6, dtype=torch.int64) * 7919
    active = torch.tensor([True, False, True, False, True, False])
    s2, u = trng.rng2_masked(s, active)
    assert u.shape == (6, 2) and torch.equal(s2[~active], s[~active])
    s3, u3 = trng.rng3_masked(s, active)
    assert u3.shape == (6, 3) and torch.equal(s3[~active], s[~active])
    assert not torch.equal(s3[active], s[active])
