"""Host layers of volren_tpu_torch (numpy copies of volren_tpu's voldata,
scene and utils modules) held bitwise against the JAX package."""

import os

import numpy as np
import pytest
import torch

from volren_tpu.scene import environment as jenv
from volren_tpu.utils import hdr as jhdr
from volren_tpu.voldata import brick as jbrick
from volren_tpu.voldata import brick_io as jbrick_io
from volren_tpu_torch.scene import environment as tenv
from volren_tpu_torch.utils import hdr as thdr
from volren_tpu_torch.utils.image import save_ldr
from volren_tpu_torch.voldata import brick as tbrick
from volren_tpu_torch.voldata import brick_io as tbrick_io
from volren_tpu_torch.voldata import DenseGrid, Volume, to_brick_grid

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUD = os.path.join(REPO, ".scene_cache", "cloud512.brick")


def _assert_grids_equal(a, b):
    assert np.array_equal(a.indirection, b.indirection)
    assert np.array_equal(a.range, b.range)
    assert np.array_equal(a.atlas, b.atlas)
    assert np.array_equal(a.transform, b.transform)
    assert np.array_equal(a.voxel_extent, b.voxel_extent)
    assert len(a.range_mips) == len(b.range_mips)
    for ma, mb in zip(a.range_mips, b.range_mips):
        assert np.array_equal(ma, mb)


def _cloud_dense(shape=(20, 24, 28), seed=5):
    rng = np.random.default_rng(seed)
    dense = rng.random(shape).astype(np.float32) * 2.0
    dense[:, :8] = 0.0          # empty bricks
    dense[:8, 8:16] = 0.75      # constant bricks
    return dense


def test_to_brick_grid_matches_reference_numpy_path():
    dense = _cloud_dense()
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = (1.0, -2.0, 0.5)
    ref = jbrick.build_brick_grid(dense, t, use_native=False)
    _assert_grids_equal(tbrick.build_brick_grid(dense, t), ref)
    grid = DenseGrid(28, 24, 20, dense, t)
    _assert_grids_equal(to_brick_grid(grid), ref)


def test_brick_round_trip_and_byte_compatible(tmp_path):
    grid = tbrick.build_brick_grid(_cloud_dense())
    ours, theirs = tmp_path / "ours.brick", tmp_path / "theirs.brick"
    tbrick_io.write_brick(str(ours), grid)
    jbrick_io.write_brick(str(theirs), jbrick.build_brick_grid(_cloud_dense(), use_native=False))
    assert ours.read_bytes() == theirs.read_bytes()
    _assert_grids_equal(tbrick_io.read_brick(str(ours)), jbrick_io.read_brick(str(ours)))


def test_read_brick_cloud512_matches_reference():
    a = tbrick_io.read_brick(CLOUD)
    b = jbrick_io.read_brick(CLOUD)
    _assert_grids_equal(a, b)
    assert a.n_bricks == (64, 64, 32) and a.atlas.shape[0] == 20480


def test_dense_round_trip(tmp_path):
    grid = DenseGrid(6, 5, 4, np.arange(120, dtype=np.float32))
    path = tmp_path / "g.dense"
    tbrick_io.write_dense(str(path), grid)
    back = jbrick_io.read_dense(str(path))
    assert np.array_equal(back.data, grid.data)
    vol = Volume(str(path))
    assert np.array_equal(vol.current_grid().data, grid.data)


def test_importance_pyramid_matches_reference():
    rng = np.random.default_rng(11)
    img = (rng.random((64, 64, 3)) * 4.0).astype(np.float32)
    a = tenv.build_importance_pyramid(img)
    b = jenv.build_importance_pyramid(img)
    assert len(a) == len(b) == 10
    for ma, mb in zip(a, b):
        assert np.array_equal(ma, mb)


def test_hdr_round_trip_matches_reference(tmp_path):
    sky = tenv.procedural_sky(64, 32, seed=3)
    assert sky.shape == (32, 64, 3) and np.isfinite(sky).all()
    assert np.array_equal(sky, tenv.procedural_sky(64, 32, seed=3))
    path = tmp_path / "sky.hdr"
    thdr.write_hdr(str(path), sky)
    assert np.array_equal(thdr.read_hdr(str(path)), jhdr.read_hdr(str(path)))
    # RGBE keeps 8 mantissa bits of the brightest channel of each texel
    err = np.abs(thdr.read_hdr(str(path)) - sky)
    assert (err <= sky.max(axis=-1, keepdims=True) / 128).all()


def test_png_writer_matches_reference_pixels(tmp_path):
    from PIL import Image

    from volren_tpu.utils.image import save_ldr as jsave_ldr

    rng = np.random.default_rng(2)
    img = rng.random((7, 9, 4)).astype(np.float32) * 1.2 - 0.1
    for alpha in (False, True):
        save_ldr(str(tmp_path / "ours.png"), img, flip=True, alpha=alpha)
        jsave_ldr(str(tmp_path / "theirs.png"), img, flip=True, alpha=alpha)
        ours = np.asarray(Image.open(tmp_path / "ours.png"))
        theirs = np.asarray(Image.open(tmp_path / "theirs.png"))
        assert ours.shape == theirs.shape == (7, 9, 4 if alpha else 3)
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("degrees", [0.0, 37.5])
def test_rotation_y_matches_reference(degrees):
    assert np.array_equal(tenv.rotation_y(degrees), jenv.rotation_y(degrees))
