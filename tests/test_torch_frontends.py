"""The port's front ends on the CPU against volren_tpu's: CLI flag parity
(renderer state, trace parameters and every frame's uploaded tables),
checkpoints across the packages, the viewer's endpoints, kernel hot
reload with a stubbed build, the volpy shim, the offline CLI over an
animated VDB folder, and the interactive loop."""

import io
import json
import os
import threading
import time
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volren_tpu.cli as jcli
import volren_tpu.scene.environment as jenvironment
import volren_tpu.volpy as jvolpy
from volren_tpu.renderer import Renderer as JRenderer
from volren_tpu.viewer import ViewerServer as JViewerServer
from volren_tpu_torch import cli, volpy
from volren_tpu_torch import renderer as renderer_module
from volren_tpu_torch.ops.kernels import build as kbuild
from volren_tpu_torch.ops.kernels import megakernel
from volren_tpu_torch.renderer import Renderer
from volren_tpu_torch.scene.environment import procedural_sky
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.utils import hotreload
from volren_tpu_torch.utils.hdr import write_hdr
from volren_tpu_torch.utils.image import save_ldr
from volren_tpu_torch.viewer import ViewerServer
from volren_tpu_torch.voldata import DenseGrid, Volume
from volren_tpu_torch.voldata.vdb import write_vdb_grids

LUT = [(0.9, 0.2, 0.1, 0.0), (0.2, 0.9, 0.6, 0.7), (1.0, 1.0, 1.0, 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _memoized_jax_importance_map():
    """volren_tpu.Environment builds its 512^2 importance pyramid (about
    4 s on a CPU) for every Environment.white(), i.e. for every JAX
    Renderer; memoize it on the image for these tests (the same arrays)."""
    real = jenvironment.build_importance_pyramid
    cache = {}

    def build(envmap):
        key = (envmap.shape, envmap.tobytes())
        if key not in cache:
            cache[key] = real(envmap)
        return cache[key]

    jenvironment.build_importance_pyramid = build
    yield
    jenvironment.build_importance_pyramid = real


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """A 2-frame VDB folder (frame 0 with a temperature grid, frame 1 with
    a non-emission second grid), a sky .hdr, a LUT .txt and a garbage .vdb."""
    root = tmp_path_factory.mktemp("scene")
    folder = root / "anim"
    folder.mkdir()
    rng = np.random.default_rng(11)
    dense = rng.random((16, 16, 24)).astype(np.float32) * 3.0
    dense[:, :4] = 0.0
    zz, yy, xx = np.meshgrid(*([np.arange(8, dtype=np.float32)] * 2),
                             np.arange(12, dtype=np.float32), indexing="ij")
    hot = np.clip(1.0 - np.sqrt((xx - 6) ** 2 + (yy - 4) ** 2 + (zz - 4) ** 2) / 5.0, 0, 1) ** 2
    write_vdb_grids(str(folder / "frame_0.vdb"),
                    [("density", dense, None),
                     ("temperature", np.pad(hot, ((0, 0), (0, 0), (0, 4))),
                      np.diag([2.0, 2.0, 2.0, 1.0]))])
    write_vdb_grids(str(folder / "frame_1.vdb"),
                    [("density", np.roll(dense, 3, axis=2), None),
                     ("mask", (dense > 1.0).astype(np.float32), None)])
    hdr = root / "sky.hdr"
    write_hdr(str(hdr), procedural_sky(32, 16, seed=3))
    lut = root / "lut.txt"
    TransferFunction(LUT).write_to_file(str(lut))
    bad = root / "bad.vdb"
    bad.write_bytes(b"\x00" * 64)
    return types.SimpleNamespace(root=root, folder=str(folder), frame=str(folder / "frame_0.vdb"),
                                 hdr=str(hdr), lut=str(lut), bad=str(bad))


# ---- CLI parity ----

class _JCounting(JRenderer):
    """The JAX renderer with a trace that only counts samples."""
    made = []

    def __init__(self):
        super().__init__()
        _JCounting.made.append(self)

    def trace(self, spp=1):
        self.sample += int(spp)


class _TCounting(Renderer):
    made = []

    def __init__(self, device="cuda"):
        super().__init__(device)
        _TCounting.made.append(self)

    def trace(self, spp=1):
        self.sample += int(spp)


def _argvs(f):
    small = ["-w", "4", "-h", "4"]
    return {
        "every_scalar_flag_fau_density": [
            f.folder, "--render", "-w", "8", "-h", "6", "--spp", "3", "--samples", "5",
            "--bounces", "4", "--albedo", "0.7", "--phase", "0.2", "--emission", "7",
            "--env_strength", "2", "--env_rot", "30", "--cam_pos", "1", "0.2", "1",
            "--cam_dir", "-1", "-0.2", "-1", "--cam_fov", "50", "--exposure", "2",
            "--gamma", "2.1", "--vol_crop_min", "0.1", "0", "0", "--vol_crop_max", "1", "0.8",
            "1", "--env_hide", "--title", "t", "--font", "f", "--major", "4", "--minor", "5",
            "--swap", "1", "--fontsize", "12", "--no-resize", "--no-decoration", "--floating",
            "--maximised", "---debug", "--hidden", "--engine", "wavefront", "--step-engine",
            "pallas", "--animate", "--fps", "12", "--fau", "--tf_width", "0.7", "--density",
            "2", "--serve", "--no-such-flag"],
        "env_lut_turbo_window_rot_y": [
            f.folder, f.hdr, f.lut, "--render", *small, "--spp", "2", "--turbo", "--tf_left",
            "0.1", "--tf_width", "0.5", "--vol_rot_y", "30", "--serve", "8123"],
        "bad_path_vdb_frame_viridis_rot_xz": [
            f.bad, f.frame, "--render", *small, "--viridis", "--vol_rot_x", "20",
            "--vol_rot_z", "-15", "--step-engine", "device_queue"],
        "default_volume": ["--render", *small, "--density", "3", "--spp", "1"],
    }


def _same_grid_tables(ours, theirs):
    meta = np.asarray(theirs.brick_meta)
    assert np.array_equal(ours.slot.numpy(), meta[..., 0].reshape(-1).astype(np.int32))
    assert np.array_equal(ours.lo.numpy(), meta[..., 1].reshape(-1))
    assert np.array_equal(ours.hi.numpy(), meta[..., 2].reshape(-1))
    assert np.array_equal(ours.mip_maj.numpy(), np.asarray(theirs.mip_maj))
    atlas = np.asarray(theirs.atlas).reshape(-1, 512)
    n = ours.atlas.shape[0]
    # the JAX package pads animations' atlases to a power of two (for jit)
    assert np.array_equal(ours.atlas.numpy(), atlas[:n]) and not atlas[n:].any()
    assert np.array_equal(ours.transform, np.asarray(theirs.transform))
    assert np.array_equal(ours.inv_transform, np.asarray(theirs.inv_transform))
    assert ours.n_bricks == tuple(theirs.n_bricks)


@pytest.mark.parametrize("case", ["every_scalar_flag_fau_density", "env_lut_turbo_window_rot_y",
                                  "bad_path_vdb_frame_viridis_rot_xz", "default_volume"])
def test_cli_state_matches_reference(case, scene_files, tmp_path, monkeypatch, capsys):
    argv = _argvs(scene_files)[case]
    monkeypatch.setattr(jcli, "Renderer", _JCounting)
    monkeypatch.setattr(cli, "Renderer", _TCounting)
    _JCounting.made.clear()
    _TCounting.made.clear()
    assert jcli.main(argv + ["--output", str(tmp_path / "jax.png")]) == 0
    jerr = capsys.readouterr().err
    ours, stats = cli.run(argv + ["--output", str(tmp_path / "port.png"), "--cpu"])
    err = capsys.readouterr().err
    theirs = _JCounting.made[-1]
    assert ours is _TCounting.made[-1] and ours.device.type == "cpu"
    for word in ("ignoring unknown argument", "Unable to load"):
        assert (word in err) == (word in jerr)
    n = theirs.volume.n_grid_frames()
    assert stats["outputs"] == [str(tmp_path / f"port_{k:06d}.png") for k in range(n)]
    assert all((tmp_path / f"jax_{k:06d}.png").exists() for k in range(n))

    if "--density" in argv and argv[0] != "--render":
        # the documented difference: the port multiplies the unit-cube
        # fit's density compensation by --density; volren_tpu resets it
        d = float(argv[argv.index("--density") + 1])
        assert ours.density_scale == d * theirs.density_scale
        theirs.density_scale = ours.density_scale
    if any(a.startswith("--vol_rot") for a in argv):
        # the other documented difference: volren_tpu uploads the grids
        # before it rotates the volume; the port commits the rotation
        theirs.commit()
    a, b = ours.describe(), theirs.describe()
    assert a.pop("engine") == "megakernel" and b.pop("engine") in ("wavefront", "oracle")
    assert a == b
    if "--step-engine" in argv:
        assert ours.step_engine == theirs.step_engine == argv[argv.index("--step-engine") + 1]
    pa, pb = ours._trace_params(), theirs._trace_params()
    for key in pa._fields:
        want = np.asarray(getattr(pb, key))
        got = getattr(pa, key)
        if isinstance(got, np.ndarray):
            assert np.array_equal(got, want), key
        else:
            assert got == want.astype(np.float32 if isinstance(got, float) else want.dtype), key
    assert np.array_equal(ours._env_device.transform, np.asarray(theirs._env_device.transform))
    assert ours._env_device.strength == float(np.asarray(theirs._env_device.strength))
    if theirs._tf_device is None:
        assert ours._tf_device is None
    else:
        assert np.array_equal(ours._tf_device.lut.numpy(), np.asarray(theirs._tf_device.lut))
        assert ours._tf_device.window_left == float(np.asarray(theirs._tf_device.window_left))
        assert ours._tf_device.window_width == float(np.asarray(theirs._tf_device.window_width))
    assert len(ours._density_grids) == len(theirs._density_grids) == n
    for mine, ref in zip(ours._density_grids, theirs._density_grids):
        _same_grid_tables(mine, ref)
    # the port keeps one emission entry per frame (None where a frame has
    # none); volren_tpu lists only the frames that have one
    emission = [g for g in ours._emission_grids if g is not None]
    assert len(ours._emission_grids) == n and len(emission) == len(theirs._emission_grids)
    for mine, ref in zip(emission, theirs._emission_grids):
        _same_grid_tables(mine, ref)
    assert ours._majorant_emission == theirs._majorant_emission


def test_cli_unported_flags_raise(scene_files, tmp_path):
    """Every flag once left unported now runs: --distribute without a
    launcher renders in a world of one, the same image as without it, and
    refuses nothing; --no-dda (the global-majorant estimators, as in
    volren_tpu.cli) and --engine oracle render through the oracle engine on
    the CPU."""
    images = []
    for extra in ([], ["--distribute"]):
        out = str(tmp_path / f"dist{len(extra)}.png")
        r, stats = cli.run([scene_files.frame, "--render", "--cpu", "-w", "8", "-h", "8",
                            "--spp", "2", "--bounces", "4", "--output", out, *extra])
        assert r.mesh.shape == {"tiles": 1, "spp": 1} and r.mesh.group is None
        assert len(stats["outputs"]) == 1
        images.append(r.framebuffer())
    assert torch.equal(images[0], images[1])
    for flags, use_dda in ((["--no-dda"], False), (["--engine", "oracle"], True)):
        out = str(tmp_path / f"oracle_{use_dda}.png")
        r, stats = cli.run([scene_files.frame, "--render", "--cpu", "-w", "8", "-h", "8",
                            "--spp", "2", "--bounces", "4", "--output", out, *flags])
        assert r.engine == "oracle" and r._use_dda == use_dda and r._config().has_emission
        assert r.last_engine == "torch_oracle" and r.sample == 2
        assert all(os.path.getsize(p) for p in stats["outputs"])
        assert np.isfinite(r.fbo_data()).all() and r.fbo_data().mean() > 0.0


# ---- checkpoints ----

def test_checkpoints_cross_load(tmp_path):
    fb = np.random.default_rng(3).random((5, 7, 4)).astype(np.float32)
    theirs = JRenderer()
    theirs._fb = jnp.asarray(fb)
    theirs.sample, theirs.seed = 96, 1234
    theirs.save_checkpoint(str(tmp_path / "jax.npz"))
    ours = Renderer(device="cpu")
    ours.load_checkpoint(str(tmp_path / "jax.npz"))
    assert ours.framebuffer().device.type == "cpu" and ours.resolution == (7, 5)
    assert np.array_equal(ours.framebuffer().numpy(), fb)
    assert (ours.sample, ours.seed) == (96, 1234)
    ours.sample, ours.seed = 33, 77
    ours.save_checkpoint(str(tmp_path / "port.npz"))
    back = JRenderer()
    back.load_checkpoint(str(tmp_path / "port.npz"))
    assert np.array_equal(np.asarray(back.framebuffer()), fb)
    assert (back.sample, back.seed, back.resolution) == (33, 77, (7, 5))


def test_checkpoint_resume_equals_straight_trace(random_grid16, tmp_path, monkeypatch):
    """2 + 4 samples through a file = 6 in one go, bitwise: the draws come
    from (pixel, sample), and both cut their dispatches at the same fences
    (every 2 samples here, every 64 in the renderer)."""
    monkeypatch.setattr(renderer_module, "DISPATCH_SPP", 2)

    def renderer():
        r = Renderer(device="cpu")
        r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
        r.scale_and_move_to_unit_cube()
        r.bounces, r.seed = 2, 9
        r.init(4, 4)
        r.commit()
        return r

    first = renderer()
    first.trace(2)
    first.save_checkpoint(str(tmp_path / "c.npz"))
    resumed = renderer()
    resumed.load_checkpoint(str(tmp_path / "c.npz"))
    resumed.trace(4)
    straight = renderer()
    straight.trace(6)
    assert resumed.sample == 6 and torch.equal(resumed.framebuffer(), straight.framebuffer())


# ---- the renderer's surface ----

def test_describe_save_and_profile(random_grid16, tmp_path, capsys):
    r = Renderer(device="cpu")
    assert list(r.describe()) == list(JRenderer().describe())
    assert repr(r).startswith("Renderer(\n  sample: 0")
    r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.bounces = 1
    r.init(4, 4)
    r.commit()
    with r.profile(str(tmp_path / "prof")):
        r.trace(1)
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.endswith(".pt.trace.json")
    with open(tmp_path / "prof" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "volren_tpu_torch.megakernel" in names
    r.save_with_alpha(str(tmp_path / "img.jpg"))
    png = (tmp_path / "img.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[25] == 6  # RGBA
    for name in STEP_NAMES:
        r.step_engine = name
    with pytest.raises(ValueError):
        r.step_engine = "warp"


STEP_NAMES = ("chunked", "device", "host", "queue", "device_queue", "pallas", "auto")


# ---- the viewer ----

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def test_viewer_endpoints(random_grid16):
    r = Renderer(device="cpu")
    r.volume = Volume(DenseGrid(16, 16, 16, random_grid16))
    r.scale_and_move_to_unit_cube()
    r.bounces = 1
    r.init(16, 16)
    r.commit()
    r.trace(1)
    viewer = ViewerServer(r, port=0).start()
    try:
        port = viewer.port
        status, ctype, page = _get(port, "/")
        assert status == 200 and ctype == "text/html" and b"/frame.png" in page
        status, ctype, png = _get(port, "/frame.png")
        assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        assert (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")) == (16, 16)
        state = json.loads(_get(port, "/state.json")[2])
        assert list(state) == list(r.describe()) and state["sample"] == 1
        applied = json.loads(_get(port, "/set?bounces=3&albedo=0.5,0.6,0.7&nope=1")[2])
        assert applied == {"bounces": "3", "albedo": "0.5,0.6,0.7"}
        assert r.bounces == 3 and r.sample == 0
        assert np.array_equal(r.albedo, np.float32([0.5, 0.6, 0.7]))
        r.sample = 4
        pos = r.cam.pos.copy()
        _get(port, "/nav?fwd=1&right=0&up=0")
        assert r.sample == 0 and not np.array_equal(r.cam.pos, pos)
        r.sample = 4
        direction = r.cam.dir.copy()
        _get(port, "/look?dx=10&dy=-5")
        assert r.sample == 0 and not np.array_equal(r.cam.dir, direction)
        assert json.loads(_get(port, "/snapshot")[2]) == {"snapshot": True}
        assert viewer.snapshot_requested
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nothing")
        assert err.value.code == 404
    finally:
        viewer.stop()


def test_viewer_matches_reference_viewer(random_grid16):
    """The same edits move both packages' cameras alike, and /frame.png
    carries the JAX viewer's pixels for the same framebuffer."""
    from PIL import Image

    fb = np.random.default_rng(5).random((6, 9, 4)).astype(np.float32) * 2
    ours, theirs = Renderer(device="cpu"), JRenderer()
    for r in (ours, theirs):
        r.init(9, 6)
    ours._fb = torch.as_tensor(fb)
    theirs._fb = jnp.asarray(fb)
    a, b = ViewerServer(ours, port=0), JViewerServer(theirs, port=0)
    try:
        for v in (a, b):
            v.apply_params({"cam_dir": "1,0.2,-1", "tonemap_exposure": "2", "seed": "4"})
            v.navigate(1.0, -2.0, 0.5)
            v.look(12.0, -7.0)
        assert np.array_equal(ours.cam.pos, theirs.cam.pos)
        assert np.array_equal(ours.cam.dir, theirs.cam.dir)
        assert ours.describe()["seed"] == theirs.describe()["seed"] == 4
        img = lambda png: np.asarray(Image.open(io.BytesIO(png)))  # noqa: E731
        got, want = img(a.frame_png()), img(b.frame_png())
        assert got.shape == (6, 9, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    finally:
        for v in (a, b):
            v._httpd.server_close()


# ---- hot reload ----

def test_hot_reload_swaps_a_rebuilt_library(tmp_path, capsys):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "megakernel.cu"
    src.write_text("// kernel\n")
    (csrc / "other.cu").write_text("// not watched\n")
    built = []
    fake = types.SimpleNamespace(_LIB=None, _LIB_LOCK=threading.Lock())
    fake.build = lambda source: built.append(source) or f"lib_{len(built)}.so"
    fake.load = lambda path: ("lib", path)
    watcher = hotreload.KernelWatcher(str(csrc), {"megakernel.cu": fake})
    assert not watcher.reload_modified_kernels()

    def touch(path, dt):
        st = os.stat(path)
        os.utime(path, (st.st_atime, st.st_mtime + dt))

    touch(src, 1)
    assert not watcher.reload_modified_kernels() and built == []  # nothing loaded yet
    fake._LIB = ("lib", "first.so")
    touch(src, 2)
    touch(csrc / "other.cu", 2)
    assert watcher.reload_modified_kernels()
    assert built == [str(src)] and fake._LIB == ("lib", "lib_1.so")
    assert not watcher.reload_modified_kernels()

    def failing(source):
        raise RuntimeError("nvcc failed (2):\nerror: expected a ';'")

    fake.build = failing
    touch(src, 3)
    assert not watcher.reload_modified_kernels()
    assert fake._LIB == ("lib", "lib_1.so")  # the loaded library stays
    assert "expected a ';'" in capsys.readouterr().out


def test_hot_reload_rebuilds_every_loaded_source_on_a_header_change(tmp_path):
    """A changed shared header (csrc/*.cuh) rebuilds each loaded kernel
    from its source beside it; a module not loaded yet is left alone."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("megakernel.cu", "oracle.cu", "common.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    built = []

    def fake(loaded):
        m = types.SimpleNamespace(_LIB=loaded, _LIB_LOCK=threading.Lock())
        m.build = lambda source: built.append(source) or f"lib_{len(built)}.so"
        m.load = lambda path: ("lib", path)
        return m

    mega, orc = fake(("lib", "first.so")), fake(None)
    watcher = hotreload.KernelWatcher(str(csrc), {"megakernel.cu": mega, "oracle.cu": orc})
    st = os.stat(csrc / "common.cuh")
    os.utime(csrc / "common.cuh", (st.st_atime, st.st_mtime + 1))
    assert watcher.reload_modified_kernels()
    assert built == [str(csrc / "megakernel.cu")] and mega._LIB == ("lib", "lib_1.so")
    assert orc._LIB is None


def test_a_kernel_build_is_keyed_by_its_shared_headers(tmp_path, monkeypatch):
    """The library's name hashes the source, the headers beside it and
    csrc's shared ones, so a header edit rebuilds (nvcc stubbed: none here)."""
    assert os.path.join(kbuild.CSRC, "common.cuh") in kbuild.headers(megakernel.SOURCE)
    src = tmp_path / "megakernel.cu"
    src.write_text("// kernel\n")
    (tmp_path / "local.cuh").write_text("// one\n")
    calls = []

    def nvcc(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w"):
            pass
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kbuild.subprocess, "run", nvcc)
    first = kbuild.build(str(src), "k")
    assert kbuild.build(str(src), "k") == first and len(calls) == 1
    assert calls[0][calls[0].index("-I") + 1] == kbuild.CSRC
    (tmp_path / "local.cuh").write_text("// two\n")
    assert kbuild.build(str(src), "k") != first and len(calls) == 2


def test_hot_reload_of_the_real_kernel_module(tmp_path, monkeypatch):
    """The watcher rebuilds megakernel.cu through the module's own build
    and swaps megakernel._LIB (the build stubbed: no nvcc here)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    with open(megakernel.SOURCE) as f:
        (csrc / "megakernel.cu").write_text(f.read())
    monkeypatch.setattr(megakernel, "_LIB", "old library")
    monkeypatch.setattr(megakernel, "build", lambda source: f"built from {source}")
    monkeypatch.setattr(megakernel, "load", lambda path: f"loaded {path}")
    watcher = hotreload.KernelWatcher(str(csrc))
    st = os.stat(csrc / "megakernel.cu")
    os.utime(csrc / "megakernel.cu", (st.st_atime, st.st_mtime + 1))
    assert watcher.reload_modified_kernels()
    assert megakernel._LIB == f"loaded built from {csrc / 'megakernel.cu'}"


# ---- volpy ----

def test_volpy_flow_through_the_cli(scene_files, tmp_path):
    """The flow of tests/test_cli_volpy.py, written as a reference-style
    script (``import volpy``) and run by the CLI on an in-repo scene."""
    script = tmp_path / "script.py"
    out = tmp_path / "script.png"
    script.write_text(
        "import numpy as np\n"
        "import volpy\n"
        "r = volpy.Renderer()\n"
        "r.init(12, 12)\n"
        f"r.volume = volpy.Volume({scene_files.frame!r})\n"
        "r.scale_and_move_to_unit_cube()\n"
        "r.commit()\n"
        "r.albedo = volpy.vec3(0.8, 0.7, 0.6)\n"
        "r.phase = 0.3\n"
        "r.bounces = 4\n"
        "bb_min, bb_max = r.volume.AABB('density')\n"
        "center = np.asarray(bb_min) + (np.asarray(bb_max) - np.asarray(bb_min)) * 0.5\n"
        "r.cam_pos = center + np.array([0, 0, 2.0], np.float32)\n"
        "r.cam_dir = (center - np.asarray(r.cam_pos)) / np.linalg.norm(center - np.asarray(r.cam_pos))\n"
        "r.cam_fov = 50\n"
        "r.render(2)\n"
        "data = r.fbo_data()\n"
        "assert data.shape == (12, 12, 3) and np.isfinite(data).all()\n"
        "assert float(r.colmap_focal_length()) > 0\n"
        "q = r.colmap_view_rot()\n"
        "assert abs(q.w**2 + q.x**2 + q.y**2 + q.z**2 - 1) < 1e-5\n"
        "res = volpy.Renderer.resolution()\n"
        "assert (res.x, res.y) == (12, 12)\n"
        f"r.save({str(out)!r})\n")
    r, stats = cli.run([str(script), "--render", "-w", "12", "-h", "12", "--spp", "1",
                        "--bounces", "2", "--cpu", "--output", str(tmp_path / "after.png")])
    assert volpy._bound["renderer"] is r and r.last_engine == "torch_plain"
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert stats["outputs"] == [str(tmp_path / "after_000000.png")]
    import sys
    assert sys.modules["volpy"] is volpy
    bad = tmp_path / "bad.py"
    bad.write_text("raise RuntimeError('script failed')\n")
    with pytest.raises(RuntimeError, match="script failed"):
        cli.run([str(bad), "--render", "--cpu", "-w", "2", "-h", "2"])


def test_volpy_glm_types_match_reference():
    for name in ("vec2", "vec3", "vec4", "ivec2", "ivec3", "ivec4", "uvec2", "uvec3", "uvec4"):
        ours, theirs = getattr(volpy, name), getattr(jvolpy, name)
        for args in ((), (5,), (range(1, ours._n + 1),), tuple(range(2, ours._n + 2))):
            a, b = ours(*args), theirs(*args)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert [getattr(a, c) for c in "xyzw"[:ours._n]] == \
                [getattr(b, c) for c in "xyzw"[:ours._n]]
    s = np.sin(np.pi / 8)
    qa, qb = volpy.quat(np.cos(np.pi / 8), s, 0.0, s), jvolpy.quat(np.cos(np.pi / 8), s, 0.0, s)
    for op in (lambda q, m: q * m.vec3(1, 2, 3), lambda q, m: np.asarray(q * q),
               lambda q, m: np.asarray(q.conjugate()), lambda q, m: q.to_mat3(),
               lambda q, m: np.asarray(q.normalize())):
        assert np.array_equal(op(qa, volpy), op(qb, jvolpy))
    assert repr(qa) == repr(qb)
    for fn in ("mat3", "mat4"):
        for args in ((), (2.0,), tuple(range(9 if fn == "mat3" else 16))):
            assert np.array_equal(getattr(volpy, fn)(*args), getattr(jvolpy, fn)(*args))
    assert volpy.Renderer._FORWARD == jvolpy.Renderer._FORWARD


# ---- the offline CLI and the interactive loop ----

def test_offline_cli_renders_each_frame_as_the_renderer_does(scene_files, tmp_path):
    base = ["-w", "16", "-h", "16", "--spp", "2", "--bounces", "3", "--cpu"]
    r, stats = cli.run([scene_files.folder, "--render", *base, "--output",
                        str(tmp_path / "anim.png")])
    assert r.last_engine == "torch_plain" and len(stats["frames"]) == 2
    assert all(f["finite"] and f["mean"][0] > 0 for f in stats["frames"])
    own = Renderer(device="cpu")
    own.volume = Volume.load_folder(scene_files.folder)
    own.scale_and_move_to_unit_cube()
    own.sppx, own.bounces = 2, 3
    own.init(16, 16)
    own.commit()
    for frame, png in enumerate(stats["outputs"]):
        own.volume.grid_frame_counter = frame
        own.render(2)
        save_ldr(str(tmp_path / "own.png"), own.draw(), flip=True, alpha=True)
        assert (tmp_path / "own.png").read_bytes() == open(png, "rb").read(), frame


def _loop_clock(monkeypatch, stop):
    """cli's clock, whose sleep (the idle wait) calls ``stop``."""
    monkeypatch.setattr(cli, "time", types.SimpleNamespace(
        time=time.time, perf_counter=time.perf_counter, sleep=lambda s: stop()))


def test_interactive_loop_converges_saves_and_exits(scene_files, tmp_path, monkeypatch):
    def interrupt():
        raise KeyboardInterrupt

    _loop_clock(monkeypatch, interrupt)
    out = tmp_path / "live.png"
    r, stats = cli.run([scene_files.frame, "-w", "8", "-h", "8", "--spp", "8", "--bounces",
                        "2", "--cpu", "--output", str(out)])
    assert r.sample == 8 and stats["spp"] == 8 and stats["outputs"] == [str(out)]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "live_preview.png").exists()
    assert cli.main([scene_files.frame, "-w", "4", "-h", "4", "--spp", "4", "--bounces", "1",
                     "--cpu", "--output", str(tmp_path / "again.png")]) == 0


def test_interactive_loop_animates_and_serves(scene_files, tmp_path, monkeypatch):
    """--animate advances a frame at each step at a high --fps; --serve 0
    starts the viewer, whose /snapshot renders sppx samples at the full
    resolution (two 4-spp traces) between two steps."""
    frames = []
    real_trace = Renderer.trace

    def trace(self, spp=1):
        frames.append(self.volume.grid_frame_counter)
        if len(frames) == 3:
            self_viewer[0].snapshot_requested = True
        if len(frames) > 6:
            raise KeyboardInterrupt
        real_trace(self, spp)

    self_viewer = []
    real_start = ViewerServer.start

    def start(viewer):
        self_viewer.append(viewer)
        return real_start(viewer)

    monkeypatch.setattr(Renderer, "trace", trace)
    monkeypatch.setattr(ViewerServer, "start", start)
    out = tmp_path / "snap.png"
    r, stats = cli.run([scene_files.folder, "-w", "8", "-h", "8", "--spp", "8",
                        "--bounces", "1", "--cpu", "--animate", "--fps", "1e9", "--serve", "0",
                        "--output", str(out)])
    assert frames[:3] == [1, 0, 1] and stats["outputs"] == [str(out)]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_trace_params_use_the_committed_majorant(scene_files, monkeypatch):
    """A committed frame's density majorant is not scanned again per trace
    (a dense VDB frame's scan costs tens of ms at full size); a grid that
    was not committed is scanned."""
    r = Renderer(device="cpu")
    r.volume = Volume.load_folder(scene_files.folder)
    r.scale_and_move_to_unit_cube()
    r.init(4, 4)
    r.commit()
    def params():
        return [[np.asarray(v).tolist() for v in r._trace_params()]
                for r.volume.grid_frame_counter in (0, 1)]

    want = params()

    def scan(grid):
        raise AssertionError("scanned a committed grid")

    monkeypatch.setattr(DenseGrid, "minorant_majorant", scan)
    assert params() == want
    r.volume.update_grid_frame(1, DenseGrid(2, 2, 2, np.ones(8, np.float32)))
    with pytest.raises(AssertionError, match="scanned"):
        r._trace_params()
