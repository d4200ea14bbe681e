"""volren_tpu_torch.Renderer and CLI on the CPU (the plain torch version
of the render kernel), the dispatch fence, and the package's isolation
from JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.voldata import DenseGrid as JDenseGrid
from volren_tpu.voldata import Volume as JVolume
from volren_tpu_torch import cli
from volren_tpu_torch import renderer as renderer_module
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.ops.kernels import pack as tpack
from volren_tpu_torch.renderer import DISPATCH_SPP, Renderer
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.voldata import DenseGrid, Volume, build_brick_grid, write_brick

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

LUT = [(0.9, 0.2, 0.1, 0.0), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 1.0)]
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

    def spy_pool(env, seed, spp_base, rgbe=False):
        pools.append((seed, spp_base))
        return real_pool(env, seed, spp_base, rgbe)

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
    """The TF and emission variants, the oracle engine and rendering across
    devices are ported: ``distribute()`` with no process group is a world
    of one and leaves the renderer on its device. The megakernel, DDA-only,
    refuses the global-majorant estimators (``_use_dda = False``) as
    volren_tpu's wavefront engine does, and a parameter block built for
    another variant is refused."""
    r = _renderer(random_grid16)
    assert r.distribute() is r and r.mesh.size == 1 and r.device.type == "cpu"
    assert r.engine == "megakernel" and r._use_dda
    r._use_dda = False
    with pytest.raises(NotImplementedError, match="DDA-only"):
        r.trace(1)
    r.engine = "oracle"
    assert r.engine == "oracle"
    r.engine, r._use_dda = "megakernel", True
    ks = r._kernel_scene()
    pf, pi = tpack.build_params(ks, r._trace_params(), 8, 8, 0, 1)
    pool = tpack.build_env_pool(r._env_device, 5, 0)
    r.set_transferfunc(TransferFunction(LUT))
    with pytest.raises(ValueError, match="variant"):
        megakernel.render(r._kernel_scene(), pool, pf, pi)


def test_tf_render_on_cpu(random_grid16, monkeypatch):
    """A TF scene renders through the plain version; the majorant table is
    baked once per trace, from the trace's parameters."""
    bakes = []
    real_bake = renderer_module.bake_tf_majorant

    def spy_bake(ks, params):
        bakes.append(params.density_scale)
        return real_bake(ks, params)

    monkeypatch.setattr(renderer_module, "bake_tf_majorant", spy_bake)
    r = _renderer(random_grid16, res=16)
    r.set_transferfunc(TransferFunction(LUT))
    r.trace(2)
    assert r.last_engine == "torch_plain" and len(bakes) == 1
    fb = r.framebuffer()
    assert fb.shape == (16, 16, 4) and bool(torch.isfinite(fb).all())
    assert float(fb[..., :3].mean()) > 0.0
    r.set_transferfunc(None)
    r.trace(1)
    assert len(bakes) == 1


def test_emission_render_on_cpu(random_grid16):
    """A frame's temperature grid, on its own index grid at half the
    density's resolution, makes the volume glow: red above blue."""
    r = _renderer(random_grid16, res=16)
    zz, yy, xx = np.meshgrid(*([np.arange(8)] * 3), indexing="ij")
    hot = np.clip(1.0 - np.sqrt((xx - 4) ** 2 + (yy - 4) ** 2 + (zz - 4) ** 2) / 4.0, 0, 1) ** 2
    r.volume.update_grid_frame(0, DenseGrid(8, 8, 8, hot, np.diag([2, 2, 2, 1])), "temperature")
    r.commit()
    assert r._majorant_emission == 1.0 and r._trace_params().emission_norm == 1.0
    ks = r._kernel_scene()
    assert ks.emi_atlas is not None and ks.tf is None
    assert np.array_equal(ks.emi_x[:3, :3], np.eye(3, dtype=np.float32) * 0.5)
    r.trace(2)
    assert r.last_engine == "torch_plain"
    fb = r.framebuffer()
    assert fb.shape == (16, 16, 4) and bool(torch.isfinite(fb).all())
    assert float((fb[..., 0] - fb[..., 2]).max()) > 0.0


def test_cli_transfer_function_flags(tmp_path, random_grid16):
    """A .txt path is a LUT and hides the environment; --fau is the
    built-in LUT; --tf_left / --tf_width set its window after it is
    loaded, wherever they stand on the line (volren_tpu.cli's order)."""
    vol = tmp_path / "grid.brick"
    write_brick(str(vol), build_brick_grid(random_grid16))
    lut = tmp_path / "lut.txt"
    TransferFunction(LUT).write_to_file(str(lut))
    base = [str(vol), "--render", "-w", "4", "-h", "4", "--spp", "1", "--bounces", "2",
            "--output", str(tmp_path / "img.png"), "--device", "cpu"]
    r = cli.run(base + [str(lut), "--tf_width", "0.5"])[0]
    assert np.array_equal(r.transferfunc.lut, TransferFunction(str(lut)).lut)
    assert not r.show_environment and r.transferfunc.window_width == 0.5
    assert r.transferfunc.window_left == 0.0 and r._tf_device.window_width == 0.5
    r = cli.run(["--tf_left", "0.25"] + base + ["--fau", "--emission", "3"])[0]
    assert np.array_equal(r.transferfunc.lut, np.asarray(cli.FAU_LUT, np.float32))
    assert r.show_environment and r.transferfunc.window_left == 0.25
    assert r.emission_scale == 3.0 and r.last_engine == "torch_plain"
    assert bool(torch.isfinite(r.framebuffer()).all())
    assert cli.run(base + ["--tf_left", "0.25"])[0].transferfunc is None


def test_cuda_renderer_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([os.path.join(REPO, ".scene_cache", "cloud512.brick"), "--render"])


def test_cli_render_on_cpu(tmp_path, random_grid16, capsys):
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
    # an unknown argument is reported and ignored, as volren_tpu.cli does
    r, stats = cli.run(args + ["--no-such-flag"])
    assert stats["outputs"] == [str(png)] and r.sample == 3
    assert "ignoring unknown argument: --no-such-flag" in capsys.readouterr().err


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
    """A fresh interpreter imports the port and renders without jax, flax,
    optax, volren_tpu, PIL, matplotlib or h5py: the renderer, the loaders
    (VDB, NanoVDB, DICOM, blosc), the colormaps, volpy, the CLI's
    interactive loop with its viewer and kernel hot reload, and the
    parallel, models and scripts packages. No module of the port names one
    of them (or the repo's scripts/) in an import statement, but for the
    guarded h5py of train_denoiser."""
    np.save(tmp_path / "grid.npy", random_grid16)
    code = (
        "import sys, types, time; sys.path.insert(0, sys.argv[1]); import numpy as np\n"
        "import volren_tpu_torch\n"
        "from volren_tpu_torch.renderer import Renderer\n"
        "from volren_tpu_torch.voldata import DenseGrid, Volume, load_grid\n"
        "from volren_tpu_torch.voldata import blosc, dicom, nanovdb\n"
        "from volren_tpu_torch.voldata.vdb import write_vdb\n"
        "from volren_tpu_torch.scene.transferfunc import TransferFunction\n"
        "from volren_tpu_torch import cli, viewer, volpy\n"
        "from volren_tpu_torch.utils import hotreload\n"
        "from volren_tpu_torch import models, parallel\n"
        "from volren_tpu_torch.parallel import dryrun\n"
        "from volren_tpu_torch.scripts import colmap_model, compare_rmse, datagen_colmap\n"
        "from volren_tpu_torch.scripts import datagen_denoise, make_cloud, styletransfer\n"
        "from volren_tpu_torch.scripts import train_denoiser\n"
        "dense = np.load(sys.argv[2])\n"
        "r = Renderer(device='cpu'); r.volume = Volume(DenseGrid(16, 16, 16, dense))\n"
        "r.scale_and_move_to_unit_cube(); r.bounces = 3; r.init(4, 4); r.commit(); r.trace(1)\n"
        "assert r.sample == 1\n"
        "TransferFunction().colormap('turbo')\n"
        "write_vdb(sys.argv[3], dense, compression='blosc')\n"
        "assert load_grid(sys.argv[3]).data.shape == (16, 16, 16)\n"
        "def stop(s): raise KeyboardInterrupt\n"
        "cli.time = types.SimpleNamespace(time=time.time, perf_counter=time.perf_counter, "
        "sleep=stop)\n"
        "r, stats = cli.run([sys.argv[3], '-w', '4', '-h', '4', '--spp', '4', '--bounces', '1', "
        "'--cpu', '--serve', '0', '--turbo', '--output', sys.argv[4]])\n"
        "assert stats['spp'] == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'volren_tpu', 'PIL', 'matplotlib', 'h5py'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code, REPO, str(tmp_path / "grid.npy"),
                    str(tmp_path / "grid.vdb"), str(tmp_path / "out.png")],
                   check=True, cwd=str(tmp_path), timeout=300)
    forbidden = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|volren_tpu|PIL|matplotlib"
                           r"|h5py|scripts)"
                           r"(?![\w])", re.M)
    # the one exception: train_denoiser reads an .h5 dataset only where
    # h5py imports, behind this guard
    guarded_h5py = ("        try:\n            import h5py\n"
                    "        except ImportError as e:\n")
    for root, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                if os.path.join(root, name) == os.path.join(PACKAGE, "scripts",
                                                             "train_denoiser.py"):
                    assert text.count(guarded_h5py) == 1, name
                    text = text.replace(guarded_h5py, "")
                assert not forbidden.findall(text), name


def test_package_reads_no_environment_variable():
    for root, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for word in ("os.environ", "getenv", "import jax"):
                    assert word not in text, (name, word)
