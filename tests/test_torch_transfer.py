"""Transfer functions in volren_tpu_torch against volren_tpu: the numpy
TransferFunction (text IO, the alpha-CDF rewrite) and the torch LUT
lookups of ops/transfer.py, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volren_tpu.ops import scene as jscene
from volren_tpu.ops import transfer as jtransfer
from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu_torch.ops import scene as tscene
from volren_tpu_torch.ops import transfer as ttransfer
from volren_tpu_torch.scene.transferfunc import TransferFunction

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)


def _lut(seed=5, n=8):
    return np.random.default_rng(seed).random((n, 4)).astype(np.float32)


def test_text_round_trip_matches_reference(tmp_path):
    path = str(tmp_path / "lut.txt")
    TransferFunction(_lut()).write_to_file(str(tmp_path / "lut.dat"))  # -> lut.txt
    ours, theirs = TransferFunction(path), JTransferFunction(path)
    assert ours.lut.dtype == np.float32 and ours.lut.shape == (8, 4)
    assert np.array_equal(ours.lut, theirs.lut)
    assert np.allclose(ours.lut, _lut(), rtol=0, atol=5e-7)   # "%f" keeps 6 decimals
    with open(path) as f:
        assert f.readline().count(",") == 3


def test_cdf_rewrite_matches_reference():
    mono = np.array([(0, 0, 0, 0), (1, 0, 0, 0.5), (0, 1, 0, 0.5), (0, 0, 1, 1)], np.float32)
    zero = _lut()
    zero[:, 3] = 0.0
    for lut in (_lut(), mono, zero):
        ours, theirs = TransferFunction(lut), JTransferFunction(lut)
        assert np.array_equal(ours.device_lut(), theirs.device_lut())
        assert np.array_equal(TransferFunction.compute_lut_cdf(lut),
                              JTransferFunction.compute_lut_cdf(lut))
        assert (np.diff(ours.device_lut()[:, 3]) >= 0).all()
    assert np.array_equal(TransferFunction(mono).device_lut(), mono)   # already monotone


def test_randomize_and_window_match_reference():
    ours, theirs = TransferFunction(), JTransferFunction()
    assert np.array_equal(ours.lut, theirs.lut) and ours.size == theirs.size == 8
    ours.randomize(16, seed=3)
    theirs.randomize(16, seed=3)
    assert np.array_equal(ours.lut, theirs.lut)
    assert (ours.window_left, ours.window_width) == (theirs.window_left, theirs.window_width)


@pytest.mark.parametrize("left,width", [(0.0, 1.0), (0.1, 0.7)])
def test_lut_lookups_match_reference(left, width):
    """tf_lookup and tf_alpha_majorant on 4096 densities (some outside the
    window on both sides) against volren_tpu.ops.transfer (onehot=False):
    bitwise, as the render kernel's TF path needs."""
    ours, theirs = TransferFunction(_lut()), JTransferFunction(_lut())
    for tf in (ours, theirs):
        tf.window_left, tf.window_width = left, width
    t_dev = tscene.upload_transferfunc(ours, "cpu")
    j_dev = jscene.upload_transferfunc(theirs)
    assert np.array_equal(t_dev.lut.numpy(), np.asarray(j_dev.lut))
    d = (np.random.default_rng(11).random(4096) * 1.4 - 0.2).astype(np.float32)
    got = ttransfer.tf_lookup(t_dev, torch.as_tensor(d)).numpy()
    ref = np.asarray(jtransfer.tf_lookup(j_dev, jnp.asarray(d)))
    assert got.shape == (4096, 4) and np.array_equal(got, ref)
    got_a = ttransfer.tf_alpha_majorant(t_dev, torch.as_tensor(d)).numpy()
    ref_a = np.asarray(jtransfer.tf_alpha_majorant(j_dev, jnp.asarray(d), onehot=False))
    assert np.array_equal(got_a, ref_a) and np.array_equal(got_a, got[:, 3])


def test_colormap_is_not_ported_yet():
    """It is now (the name is kept from when colormap raised): the CLI's
    --turbo LUT equals the JAX package's bitwise, its device upload too,
    and an unknown name raises as there."""
    ours, theirs = TransferFunction(), JTransferFunction()
    ours.colormap("turbo")
    theirs.colormap("turbo")
    assert np.array_equal(ours.lut, theirs.lut)
    up = tscene.upload_transferfunc(ours, "cpu")
    assert np.array_equal(up.lut.numpy(), np.asarray(jscene.upload_transferfunc(theirs).lut))
    for tf in (ours, theirs):
        with pytest.raises(KeyError):
            tf.colormap("nope")
