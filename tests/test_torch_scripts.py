"""The port's scripts (volren_tpu_torch.scripts) in reduced in-process
runs, with the shapes of tests/test_scripts.py, on the CPU; where a JAX
script computes the same thing, against it.

- colmap_model round-trips binary and text models;
- make_cloud writes the same .brick bytes as scripts/make_cloud.py;
- compare_rmse reads the port's PNGs, .npy, .npz and .hdr, and prints what
  scripts/compare_rmse.py prints for the same PNGs;
- datagen_denoise writes two fp16 (N, 3, H, W) ``color`` datasets,
  datagen_colmap RGBA views and a text model;
- train_denoiser trains on .npz (and .h5) pairs and writes parameters both
  packages load;
- styletransfer is bitwise deterministic and within the committed golden
  stats (atol 0.02, tests/goldens/styletransfer_stats.json); after 2 epochs
  its pixels are within 1e-3 of scripts/styletransfer.py's steps on the same
  inputs and weights (f32 convolutions summed in other orders).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from volren_tpu_torch.scripts import (colmap_model, compare_rmse, datagen_colmap,
                                      datagen_denoise, make_cloud, styletransfer,
                                      train_denoiser)
from volren_tpu_torch.utils.hdr import write_hdr
from volren_tpu_torch.utils.image import read_png, write_png

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _jax_script(name):
    sys.path.insert(0, SCRIPTS)
    try:
        return __import__(name)
    finally:
        sys.path.remove(SCRIPTS)


def test_colmap_model_binary_roundtrip(tmp_path):
    cm = colmap_model
    cameras = {1: cm.Camera(id=1, model="SIMPLE_PINHOLE", width=640, height=480,
                            params=[500.0, 320.0, 240.0])}
    images = {
        7: cm.Image(id=7, qvec=[0.5, 0.5, -0.5, 0.5], tvec=[0.1, -0.2, 3.0],
                    camera_id=1, name="view_000007.png",
                    xys=[(1.5, 2.5), (3.0, 4.0)], point3D_ids=[11, -1]),
        8: cm.Image(id=8, qvec=[1.0, 0.0, 0.0, 0.0], tvec=[0.0, 0.0, 0.0],
                    camera_id=1, name="view_000008.png"),
    }
    points = {11: cm.Point3D(id=11, xyz=[0.25, -0.75, 1.25], rgb=[10, 200, 255],
                             error=0.5, image_ids=[7], point2D_idxs=[0])}
    cm.write_model(cameras, images, points, str(tmp_path), ext=".bin")
    rc, ri, rp = cm.read_model(str(tmp_path))
    assert (rc[1].model, rc[1].width, rc[1].height) == ("SIMPLE_PINHOLE", 640, 480)
    assert rc[1].params == [500.0, 320.0, 240.0]
    assert ri[7].qvec == [0.5, 0.5, -0.5, 0.5] and ri[7].tvec == [0.1, -0.2, 3.0]
    assert ri[7].xys == [(1.5, 2.5), (3.0, 4.0)] and ri[7].point3D_ids == [11, -1]
    assert ri[8].xys == [] and ri[7].name == "view_000007.png"
    assert rp[11].xyz == [0.25, -0.75, 1.25] and rp[11].rgb == [10, 200, 255]
    assert rp[11].error == 0.5 and rp[11].image_ids == [7] and rp[11].point2D_idxs == [0]
    cm.write_model(cameras, images, points, str(tmp_path / "txt"), ext=".txt")
    tc, ti, _tp = cm.read_model(str(tmp_path / "txt"))
    assert ti[7].point3D_ids == [11, -1] and tc[1].params == rc[1].params
    # the JAX script's reader reads the port's binary files the same
    jc, ji, jp = _jax_script("colmap_model").read_model(str(tmp_path))
    assert ji[7].xys == ri[7].xys and jc[1].params == rc[1].params and jp[11].xyz == rp[11].xyz


def test_make_cloud_matches_the_jax_script(tmp_path):
    ours, theirs = str(tmp_path / "ours.brick"), str(tmp_path / "theirs.brick")
    make_cloud.main(["--res", "32", "--output", ours])
    argv = sys.argv
    try:
        sys.argv = ["make_cloud.py", "--res", "32", "--output", theirs]
        _jax_script("make_cloud").main()
    finally:
        sys.argv = argv
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    from volren_tpu_torch.voldata import Volume

    lo, hi = Volume(ours).minorant_majorant()
    assert hi > 0 and np.isfinite(hi)


def test_compare_rmse_reads_every_format(tmp_path, capsys):
    rng = np.random.default_rng(3)
    a = (rng.random((12, 10, 3)) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0, 255).astype(np.uint8)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(pa, a)
    Image.fromarray(b).save(pb)            # another library's PNG (filtered rows)
    assert compare_rmse.main([pa, pa]) == 0
    capsys.readouterr()
    code = compare_rmse.main([pa, pb])
    ours = capsys.readouterr().out
    argv = sys.argv
    try:
        sys.argv = ["compare_rmse.py", pa, pb]
        theirs_code = _jax_script("compare_rmse").main()
    finally:
        sys.argv = argv
    assert ours == capsys.readouterr().out and code == theirs_code
    hdr = rng.random((12, 10, 3)).astype(np.float32)
    write_hdr(str(tmp_path / "x.hdr"), hdr)
    np.save(tmp_path / "x.npy", hdr)
    np.savez(tmp_path / "x.npz", framebuffer=np.concatenate([hdr, np.ones((12, 10, 1))], -1))
    assert compare_rmse.main([str(tmp_path / "x.npy"), str(tmp_path / "x.npz")]) == 0
    assert compare_rmse.load_any(str(tmp_path / "x.hdr")).shape == (12, 10, 3)
    big = np.repeat(np.repeat(a, 2, 0), 2, 1)
    write_png(str(tmp_path / "big.png"), big)
    assert compare_rmse.main([pa, str(tmp_path / "big.png"), "--resize-b"]) == 0


def test_datagen_denoise_reduced(tmp_path):
    """2 scenes of cloud512 under the procedural sky at 16x16, 4 spp
    converged: two fp16 (2, 3, 16, 16) datasets, finite, not black."""
    stem = str(tmp_path / "ds")
    datagen_denoise.main(["--count", "2", "--spp", "4", "--res", "16", "--output", stem,
                          "--device", "cpu"])
    for suffix in ("_input.npz", "_target.npz"):
        with np.load(stem + suffix) as f:
            d = f["color"]
        assert d.shape == (2, 3, 16, 16) and d.dtype == np.float16
        data = d.astype(np.float32)
        assert np.isfinite(data).all() and data.max() > 0


def test_datagen_colmap_reduced(tmp_path):
    out = tmp_path / "colmap"
    datagen_colmap.main(["--views", "2", "--spp", "2", "--res", "16", "--out", str(out),
                         "--device", "cpu"])
    pngs = sorted(out.glob("**/*.png"))
    assert [p.name for p in pngs] == ["view_000000.png", "view_000001.png"]
    img = read_png(str(pngs[0]))
    assert img.shape == (16, 16, 4)
    cams, images, points = colmap_model.read_model(str(out))
    assert len(images) == 2 and cams[0].model == "SIMPLE_PINHOLE" and len(points) >= 1


@pytest.mark.parametrize("ext", [".npz", ".h5"])
def test_train_denoiser_script(tmp_path, capsys, ext):
    rng = np.random.default_rng(5)
    clean = rng.random((2, 3, 24, 24)).astype(np.float16)
    noisy = clean + rng.normal(0, 0.05, clean.shape).astype(np.float16)
    paths = [str(tmp_path / f"in{ext}"), str(tmp_path / f"tg{ext}")]
    for path, data in zip(paths, (noisy, clean)):
        if ext == ".npz":
            np.savez(path, color=data)
        else:
            import h5py

            with h5py.File(path, "w") as f:
                f.create_dataset("color", data=data)
    out = str(tmp_path / "params.pkl")
    train_denoiser.main([*paths, "--steps", "3", "--batch", "2", "--patch", "16",
                         "--output", out, "--device", "cpu"])
    assert "loss" in capsys.readouterr().out
    from volren_tpu.models.denoiser import load_params as jload

    tree = jload(out)
    assert tree["params"]["ConvBlock_0"]["Conv_0"]["kernel"].shape == (3, 3, 3, 32)


def _style_inputs(tmp_path):
    """The golden test's inputs (tests/test_scripts.py)."""
    rng = np.random.default_rng(7)
    content, style = str(tmp_path / "content.png"), str(tmp_path / "style.png")
    Image.fromarray((rng.random((32, 32, 3)) * 200 + 40).astype(np.uint8)).save(content)
    Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(style)
    return content, style


def test_styletransfer_deterministic_golden(tmp_path):
    content, style = _style_inputs(tmp_path)

    def run(out):
        styletransfer.main([content, style, "--epochs", "4", "--save_epochs", "4",
                            "--image_size", "32", "--output", out, "--cpu"])
        return read_png(out).astype(np.float32) / 255.0

    a = run(str(tmp_path / "a.png"))
    b = run(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(a, b)
    with open(os.path.join(REPO, "tests", "goldens", "styletransfer_stats.json")) as f:
        golden = json.load(f)
    np.testing.assert_allclose([a[..., c].mean() for c in range(3)], golden["mean"], atol=0.02)
    np.testing.assert_allclose([a[..., c].std() for c in range(3)], golden["std"], atol=0.02)


def test_styletransfer_matches_the_jax_steps(tmp_path):
    """Two epochs of the JAX script's optimisation (optax chain, random VGG11
    filters of the same numpy draws) against the port's: every pixel within
    1e-3 (both clip to [0, 1]; Adam's first steps move a pixel by about the
    learning rate, 0.1, so a wrong sign or scale would show at 1e-1)."""
    import jax
    import jax.numpy as jnp
    import optax

    content, style = _style_inputs(tmp_path)
    st = _jax_script("styletransfer")
    c, s = st.load_image(content), st.load_image(style)
    params = st.load_vgg11_params()
    for (jw, _jb), (tw, _tb) in zip(params, styletransfer.random_vgg11_params()):
        assert np.array_equal(np.asarray(jw), tw.numpy())
    opt = optax.chain(optax.clip(1.0), optax.scale_by_adam(b1=0.9, b2=0.999),
                      optax.scale_by_learning_rate(optax.exponential_decay(0.1, 1, 0.999)))

    @jax.jit
    def step(image, state):
        grad = jax.grad(lambda im: st.style_loss_fn(params, im, c, s, 1.0, 3000.0))(image)
        updates, state = opt.update(grad, state, image)
        return jnp.clip(image + updates, 0.0, 1.0), state

    image, state = c, opt.init(c)
    for _ in range(2):
        image, state = step(image, state)
    ours = styletransfer.main([content, style, "--epochs", "2", "--image_size", "32",
                               "--output", str(tmp_path / "o.png"), "--cpu"])
    assert isinstance(ours, torch.Tensor)
    err = np.abs(ours.numpy() - np.asarray(image)).max()
    assert err < 1e-3, err


def test_styletransfer_resize_is_jax_bicubic():
    import jax

    x = np.random.default_rng(0).random((1, 3, 20, 13)).astype(np.float32)
    for size in ((20, 13), (10, 7), (31, 19)):
        want = np.asarray(jax.image.resize(x, (1, 3, *size), "bicubic"))
        got = styletransfer.resize(torch.from_numpy(x), size).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
