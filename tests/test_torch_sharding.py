"""Rendering across devices in volren_tpu_torch (``parallel.sharding``)
against one process and against volren_tpu.parallel.sharding.

- Row bands: the plain version over 2, 3 (a ragged last band) and 4 bands,
  concatenated, is bitwise the whole dispatch in every variant.
- The gloo dry run (``parallel.dryrun``): 4 spawned processes, once for the
  module, render meshes (2, 1), (4, 1), (1, 2) and (2, 2) through
  ``Renderer.distribute``; bands are bitwise one process's render, a
  sample split within rtol = atol = 1e-5 (only the merge's order of sums
  differs: the bar of tests/test_sharding.py).
- Against the JAX package: ``render_sharded_pallas`` on a 2-tile CPU mesh
  (Pallas interpret mode) and the port's 2-band render of the same scene
  and seed agree to the statistical bar of tests/test_pallas.py (RMSE
  below 1.5x the seed-to-seed noise, mean within 5%): that function packs
  the environment and the pool as RGBE, which the port does not, so pixels
  differ by more than rounding.
"""

import inspect

import numpy as np
import pytest
import torch
from test_torch_cuda import _inputs, _renderer
from torch_reference import RES, SEED, SPP, jax_renderer, mean_rel, port_inputs, rmse

from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels.pack import PI_ROW0, PI_ROWS, build_env_pool, build_params
from volren_tpu_torch.parallel import dryrun, sharding
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import Environment, procedural_sky

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
VARIANT_IDS = ["plain", "tf", "emission", "tf+emission"]


@pytest.fixture(scope="module")
def sky():
    return Environment(procedural_sky(64, 32, seed=4))


@pytest.mark.parametrize("tf,emission", VARIANTS, ids=VARIANT_IDS)
def test_row_bands_concatenated_are_the_whole_dispatch(sky, tf, emission):
    """37 x 23 at 3 spp, 8 bounces, over 2, 3 (8, 8, 7 rows) and 4 (6, 6,
    6, 5) bands: a band's pixels keep their global seeds and camera rays,
    so the bands' sums put together are bitwise the whole frame's; the
    tolerance is 0."""
    r = _renderer(torch.device("cpu"), tf=tf, emission=emission, width=37, height=23, env=sky)
    r.bounces = 8
    ks, pool, pf, pi = _inputs(r, spp=3)
    whole = megakernel.render(ks, pool, pf, pi)
    assert whole.shape == (37 * 23, 4) and bool(torch.isfinite(whole).all())
    for n in (2, 3, 4):
        parts = []
        for t in range(n):
            row0, rows = sharding.band_rows(23, n, t)
            bpf, bpi = build_params(ks, r._trace_params(), 37, 23, 0, 3, row0, rows)
            assert (bpi[PI_ROW0], bpi[PI_ROWS]) == (row0, rows)
            parts.append(megakernel.render(ks, pool, bpf, bpi))
        assert [p.shape[0] // 37 for p in parts] == [sharding.band_rows(23, n, t)[1]
                                                     for t in range(n)]
        assert torch.equal(torch.cat(parts), whole), n


def test_band_and_share_arithmetic():
    assert [sharding.band_rows(23, 3, t) for t in range(3)] == [(0, 8), (8, 8), (16, 7)]
    assert [sharding.band_rows(5, 4, t) for t in range(4)] == [(0, 2), (2, 2), (4, 1), (5, 0)]
    assert [sharding.spp_share(5, 2, s) for s in range(2)] == [(0, 3), (3, 2)]
    assert [sharding.spp_share(1, 2, s) for s in range(2)] == [(0, 1), (1, 0)]
    # every sample of a dispatch once, in order
    for spp in (1, 5, 64):
        for n in (1, 2, 3, 4):
            shares = [sharding.spp_share(spp, n, s) for s in range(n)]
            assert sum(c for _k, c in shares) == spp
            assert all(k0 + c == k1 for (k0, c), (k1, _c) in zip(shares, shares[1:]))
    with pytest.raises(ValueError, match="not rows of a 8-row frame"):
        build_params(None, None, 8, 8, 0, 1, 6, 3)


def test_world_of_one_is_the_undistributed_render(sky):
    """Without a process group, ``distribute()`` is the default 1 x 1 mesh,
    which makes no collective, and a trace through it over two dispatches
    (65 spp: 64 + 1) is bitwise the running mean of the kernel's two
    dispatches, each with the pool drawn at its first sample."""
    r = _renderer(torch.device("cpu"), width=6, height=5, env=sky)
    assert r.mesh == sharding.Mesh(1, 1)
    r.distribute()
    assert r.mesh == sharding.Mesh(1, 1) and r.mesh.group is None
    r.bounces = 4
    r.render(65)
    ks, params = r._kernel_scene(), r._trace_params()
    fb = torch.zeros(5, 6, 4)
    for base, n in ((0, 64), (64, 1)):
        pf, pi = build_params(ks, params, 6, 5, base, n)
        accum = megakernel.render(ks, build_env_pool(r._env_device, r.seed, base), pf, pi)
        fb = (fb * base + accum.reshape(5, 6, 4)) / (base + n)
    assert torch.equal(r.framebuffer(), fb)
    band = torch.ones(30, 4)
    assert sharding.reduce_shards(band, r.mesh) is band
    assert sharding.gather_bands(band, r.mesh, 6, 5).data_ptr() == band.data_ptr()
    with pytest.raises(ValueError, match="at most 64 samples"):
        sharding.render_sharded(ks, None, params, 6, 5, 65, 0, r.mesh)
    with pytest.raises(ValueError):
        sharding.make_mesh(n_tiles=2)


@pytest.fixture(scope="module")
def dry_run():
    """The gloo dry run's four cases, in four processes spawned once."""
    return {tuple(rec["mesh"]): rec for rec in dryrun.dryrun(4, dryrun.CASES, device="cpu")}


def test_dry_run_defaults_to_the_card(monkeypatch):
    """The dry run renders on the card unless asked for the CPU: with no
    card, the function and the module's command line refuse to start."""
    assert inspect.signature(dryrun.dryrun).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.dryrun(2, dryrun.CASES[:1])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.main(["--procs", "2"])


@pytest.mark.parametrize("mesh", [c[:2] for c in dryrun.CASES],
                         ids=[f"{c[0]}x{c[1]}" for c in dryrun.CASES])
def test_dry_run_matches_one_process(dry_run, mesh):
    rec = dry_run[mesh]
    assert rec["ranks_agree"] and rec["engines"] == ["torch_plain"]
    if mesh[1] == 1:
        assert rec["bitwise"], rec
    else:
        assert rec["max_abs"] <= dryrun.TOL, rec
    assert rec["ok"], rec


def test_two_bands_match_jax_render_sharded_pallas(random_grid16):
    """volren_tpu's pixel-band engine on a 2-device CPU mesh (Pallas in
    interpret mode, RGBE tables) against the port's 2-band render of the
    same scene, pool seed and samples (RES 32, SPP 8, seed 123): RMSE below
    1.5x the port's own seed-to-seed noise, mean within 5%."""
    import jax

    from volren_tpu.ops.pallas.pack import build_env_pool as jbuild_env_pool
    from volren_tpu.parallel.sharding import make_mesh, render_sharded_pallas

    r = jax_renderer(random_grid16)
    r.commit()
    scene, params, cfg = r._scene_device(), r._trace_params(), r._config()
    jmesh = make_mesh(n_tiles=2, n_spp=1, devices=jax.devices()[:2])
    theirs = np.asarray(render_sharded_pallas(scene, params, cfg, RES, RES, SPP, 0, jmesh,
                                              seed=SEED)).reshape(-1, 4) / SPP
    ref, ks, _pf, _pi = port_inputs(scene, params, jbuild_env_pool(scene, SEED, 0))

    def two_bands(spp_base):
        parts = []
        for t in range(2):
            row0, rows = sharding.band_rows(RES, 2, t)
            pf, pi = build_params(ks, ref.params, RES, RES, spp_base, SPP, row0, rows)
            parts.append(megakernel.render(ks, ref.pool, pf, pi))
        return torch.cat(parts).numpy() / SPP

    ours, other = two_bands(0), two_bands(SPP)
    noise = rmse(other, ours)
    assert np.isfinite(ours).all() and ours.shape == theirs.shape
    assert rmse(ours, theirs) < 1.5 * noise, (rmse(ours, theirs), noise)
    assert mean_rel(ours, theirs) < 0.05


def test_renderer_distribute_moves_nothing_on_the_cpu():
    r = Renderer(device="cpu")
    assert r.mesh == sharding.Mesh(1, 1)
    r.distribute(sharding.make_mesh())
    assert r.device == torch.device("cpu") and r.mesh.size == 1


def test_distribute_puts_rank_on_device_rank_mod_count(monkeypatch):
    """On a CUDA device, global rank r takes ``cuda:r % device_count``."""
    moved = []
    r = Renderer(device="cpu")
    r.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: moved.append(("set", d)))
    monkeypatch.setattr(r, "_move_to", lambda d: moved.append(("move", d)))
    mesh = sharding.Mesh(2, 2, rank=3, global_rank=3)
    assert r.distribute(mesh) is r and r.mesh is mesh
    assert moved == [("move", torch.device("cuda", 1)), ("set", torch.device("cuda", 1))]


def test_move_to_rebuilds_every_table_on_the_new_device(sky, monkeypatch):
    """``_move_to`` uploads the environment, the transfer function and
    every frame's density and emission grids anew on the new device,
    clears the packed kernel scene, and the render after the move is
    bitwise the render before it. The CPU stands in for a second card:
    ``cpu:0`` is another device than ``cpu`` to the renderer."""
    from volren_tpu_torch import renderer as renderer_mod

    r = _renderer(torch.device("cpu"), tf=True, emission=True, width=6, height=5, env=sky)
    r.bounces = 4
    r.render(2)
    before = r.framebuffer().clone()
    r._kernel_scene()
    assert r._packed is not None
    uploads = []
    for name in ("upload_environment", "upload_transferfunc", "upload_grid"):
        real = getattr(renderer_mod.dscene, name)

        def spy(*args, _real=real, _name=name):
            uploads.append((_name, torch.device(args[-1])))
            return _real(*args)

        monkeypatch.setattr(renderer_mod.dscene, name, spy)
    new = torch.device("cpu", 0)
    assert new != r.device
    r._move_to(new)
    assert r.device == new and r._packed is None
    assert sorted(uploads, key=str) == sorted(
        [("upload_environment", new), ("upload_transferfunc", new), ("upload_grid", new),
         ("upload_grid", new)], key=str)
    r.render(2)
    assert torch.equal(r.framebuffer(), before)
