"""volren_tpu_torch.Renderer and CLI on the CPU (the plain torch version
of the render kernel), the dispatch fence, and the package's isolation
from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu.voldata import Volume as JVolume
from volren_tpu_torch import cli
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.renderer import DISPATCH_SPP, Renderer
from volren_tpu_torch.voldata import DenseGrid, Volume, build_brick_grid, write_brick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "volren_tpu_torch")


def _renderer(dense, res=8, bounces=4):
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, dense))
    r.scale_and_move_to_unit_cube()
    r.bounces = bounces
    r.seed = 5
    r.init(res, res)
    r.commit()
    return r


def test_trace_crosses_dispatch_fence(random_grid16, monkeypatch):
    """trace(96) runs a 64-spp and a 32-spp dispatch, each with its own
    NEE pool (spp_base = samples so far), and keeps the running mean."""
    calls = []
    real_render, real_pool = megakernel.render, tpack.build_env_pool

    def spy_render(ks, pool, pf, pi):
        calls.append((int(pi[tpack.PI_SPP_BASE]), int(pi[tpack.PI_SPP])))
        return real_render(ks, pool, pf, pi)

    pools = []

    def spy_pool(env, seed, spp_base):
        pools.append((seed, spp_base))
        return real_pool(env, seed, spp_base)

    monkeypatch.setattr(megakernel, "render", spy_render)
    monkeypatch.setattr("volren_tpu_torch.renderer.build_env_pool", spy_pool)
    r = _renderer(random_grid16, res=2, bounces=1)
    r.trace(96)
    assert calls == [(0, DISPATCH_SPP), (DISPATCH_SPP, 96 - DISPATCH_SPP)]
    assert pools == [(5, 0), (5, DISPATCH_SPP)]
    assert r.sample == 96 and r.last_engine == "torch_plain"
    fb = r.framebuffer()
    assert fb.shape == (2, 2, 4) and bool(torch.isfinite(fb).all())
    assert float(fb[..., :3].mean()) > 0.0
    img = r.draw()
    assert img.shape == (2, 2, 4) and np.isfinite(img).all()


def test_render_resets_and_matches_trace(random_grid16):
    r = _renderer(random_grid16)
    r.trace(3)
    first = r.framebuffer().clone()
    r.render(3)
    assert r.sample == 3 and torch.equal(r.framebuffer(), first)
    rgb = r.fbo_data()
    assert rgb.shape == (8, 8, 3) and np.array_equal(rgb, first[..., :3].numpy())


def test_trace_params_match_reference(random_grid16):
    """The majorant floor, unit-cube fit (which scales density_scale too)
    and the clip box follow volren_tpu.renderer."""
    ours = Renderer(device="cpu")
    theirs = JRenderer()
    for r, grid in ((ours, DenseGrid), (theirs, JDenseGrid)):
        r.volume = (Volume if r is ours else JVolume)(grid(16, 16, 16, random_grid16 * 0.5))
        r.density_scale = 0.25
        r.scale_and_move_to_unit_cube()
        r.vol_clip_min = np.array([0.1, 0.0, 0.2], np.float32)
    assert ours.density_scale == theirs.density_scale == 4.0
    a, b = ours._trace_params(), theirs._trace_params()
    for key in ("cam_pos", "cam_transform", "bb_min", "bb_max", "albedo"):
        assert np.array_equal(getattr(a, key), np.asarray(getattr(b, key))), key
    for key in ("cam_fov", "majorant", "inv_majorant", "phase_g", "density_scale"):
        assert getattr(a, key) == float(np.asarray(getattr(b, key))), key
    assert a.seed == int(np.asarray(b.seed)) and a.bounces == int(b.bounces)
    ours.volume = Volume(DenseGrid(2, 2, 2, np.zeros(8, np.float32)))
    assert ours._trace_params().majorant == float(np.float32(1e-20))


def test_unported_variants_raise(random_grid16):
    r = _renderer(random_grid16)
    r.transferfunc = object()
    with pytest.raises(NotImplementedError, match="K2"):
        r.trace(1)
    r.transferfunc = None
    r.volume.grids[0]["temperature"] = r.volume.grids[0]["density"]
    with pytest.raises(NotImplementedError, match="K3"):
        r.commit()


def test_cuda_renderer_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([os.path.join(REPO, ".scene_cache", "cloud512.brick"), "--render"])


def test_cli_render_on_cpu(tmp_path, random_grid16):
    vol = tmp_path / "grid.brick"
    write_brick(str(vol), build_brick_grid(random_grid16))
    out = tmp_path / "img.png"
    args = [str(vol), "--render", "-w", "12", "-h", "8", "--spp", "3", "--bounces", "5",
            "--albedo", "0.8", "--phase", "0.3", "--env_strength", "2", "--env_rot", "30",
            "--cam_pos", "1", "0.2", "1", "--cam_dir", "-1", "-0.2", "-1", "--cam_fov", "60",
            "--exposure", "3", "--gamma", "2.0", "--output", str(out), "--device", "cpu"]
    r, stats = cli.run(args)
    png = tmp_path / "img_000000.png"
    assert stats["outputs"] == [str(png)]
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert r.sppx == 3 and r.sample == 3 and r.bounces == 5 and r.phase == 0.3
    assert r.environment.strength == 2.0 and r.cam.fov_degree == 60.0
    assert r.framebuffer().shape == (8, 12, 4) and stats["spp"] == 3
    with pytest.raises(ValueError):
        cli.run([str(vol), "--render", "--no-such-flag"])


def test_cli_density_scales_the_unit_cube_fit(tmp_path, random_grid16):
    """``--density D`` multiplies the density scale that the unit-cube fit
    sets, in any argument order. (volren_tpu.cli resets the scale to 1.0
    when it loads the volume after parsing, so there the flag has no
    effect; ROADMAP records the difference.)"""
    vol = tmp_path / "grid.brick"
    write_brick(str(vol), build_brick_grid(random_grid16))
    base = [str(vol), "--render", "-w", "2", "-h", "2", "--spp", "1", "--bounces", "1",
            "--output", str(tmp_path / "img.png"), "--device", "cpu"]
    fit = cli.run(base)[0].density_scale
    assert fit != 1.0
    assert cli.run(base + ["--density", "2"])[0].density_scale == 2.0 * fit
    assert cli.run(["--density", "0.5"] + base)[0].density_scale == 0.5 * fit


def test_package_never_imports_jax(tmp_path, random_grid16):
    """A fresh interpreter imports the port and renders without jax."""
    np.save(tmp_path / "grid.npy", random_grid16)
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import numpy as np\n"
        "import volren_tpu_torch\n"
        "from volren_tpu_torch.renderer import Renderer\n"
        "from volren_tpu_torch.voldata import DenseGrid, Volume\n"
        "r = Renderer(device='cpu'); r.volume = Volume(DenseGrid(16, 16, 16, np.load(sys.argv[2])))\n"
        "r.scale_and_move_to_unit_cube(); r.bounces = 3; r.init(4, 4); r.commit(); r.trace(1)\n"
        "assert r.sample == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'volren_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, REPO, str(tmp_path / "grid.npy")],
                   check=True, cwd=str(tmp_path), timeout=300)


def test_package_reads_no_environment_variable():
    for root, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for word in ("os.environ", "getenv", "import jax"):
                    assert word not in text, (name, word)
