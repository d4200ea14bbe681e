"""The UNet denoiser of volren_tpu_torch against volren_tpu's flax model.

The same parameters (flax's initialisation, carried across with
``from_flax_params``) and the same numpy inputs go through both. In f32
(``dtype`` float32 in both) the forward pass and one AdamW step agree
within rtol = atol = 1e-5; in bf16 the convolutions round differently
(XLA and oneDNN accumulate in other orders, and round the bias add and the
pooling at other points), so the bar is 0.01 in log space, where the model
predicts its residual: about two bf16 steps (2^-8) of a log radiance near
1. Sizes 32 and 33: at 33 ``avg_pool`` floors the skips to odd sizes, where
jax.image.resize's half-pixel nearest differs from torch's "nearest" (the
port uses "nearest-exact").
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volren_tpu.models import denoiser as jden
from volren_tpu_torch.models import denoiser as tden

FEATURES = (8, 12, 16)
TOL = 1e-5
BF16_LOG_TOL = 0.01


def _flax(size, dtype=jnp.float32, seed=0):
    model = jden.Denoiser(features=FEATURES, dtype=dtype)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 3, size, size), jnp.float32))
    return model, jax.device_get(params)


def _port(params, dtype=torch.float32):
    model = tden.Denoiser(FEATURES, dtype)
    model.load_state_dict(tden.from_flax_params(params, model))
    return model


def _hdr(size, seed=1):
    return (np.abs(np.random.default_rng(seed).normal(size=(2, 3, size, size))) * 5.0
            ).astype(np.float32)


@pytest.mark.parametrize("size", [32, 33])
def test_forward_matches_flax_f32(size):
    jm, params = _flax(size)
    x = _hdr(size)
    want = np.asarray(jm.apply(params, x))
    got = _port(params)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 3, size, size) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", [32, 33])
def test_forward_matches_flax_bf16(size):
    jm, params = _flax(size, jnp.bfloat16)
    x = _hdr(size)
    want = np.asarray(jm.apply(params, x))
    got = _port(params, torch.bfloat16)(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = np.abs(np.log1p(got) - np.log1p(want)).max()
    assert err < BF16_LOG_TOL, err


def test_one_train_step_matches_optax_adamw():
    """optax.adamw (weight decay 1e-4) under cosine_decay_schedule(3e-3,
    20_000, alpha=0.05) against the port's AdamW and LambdaLR, f32, from the
    same parameters and batch: the loss and every updated parameter within
    1e-5, and the learning rate of the next step is the schedule's at 1."""
    rng = np.random.default_rng(0)
    clean = np.zeros((4, 3, 32, 32), np.float32)
    clean[:, :, 8:24, 8:24] = 2.0
    noisy = np.maximum(clean + rng.normal(0, 0.6, clean.shape).astype(np.float32), 0)
    jm, params = _flax(32)
    tx = optax.adamw(optax.cosine_decay_schedule(3e-3, 20_000, alpha=0.05))
    new, _state, jloss = jden.train_step(jm.apply, tx, params, tx.init(params),
                                         jnp.asarray(noisy), jnp.asarray(clean))
    model, opt, sched = tden.create_train_state(0, lr=3e-3, features=FEATURES, device="cpu",
                                                dtype=torch.float32)
    model.load_state_dict(tden.from_flax_params(params, model))
    loss = tden.train_step(model, opt, sched, noisy, clean)
    assert abs(float(loss) - float(jloss)) < TOL
    want = tden.from_flax_params(jax.device_get(new), model)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=TOL, err_msg=name)
    assert sched.get_last_lr()[0] == pytest.approx(3e-3 * tden.cosine_decay(1), rel=1e-12)
    assert tden.cosine_decay(20_000) == pytest.approx(0.05)


def test_training_reduces_loss():
    """Thirty bf16 steps on a noisy box lower the loss below 0.7x (the
    pattern of tests/test_denoiser.py), from the port's own initialisation."""
    rng = np.random.default_rng(0)
    clean = np.zeros((4, 3, 32, 32), np.float32)
    clean[:, :, 8:24, 8:24] = 2.0
    noisy = np.maximum(clean + rng.normal(0, 0.6, clean.shape).astype(np.float32), 0)
    model, opt, sched = tden.create_train_state(0, lr=3e-3, features=FEATURES, device="cpu")
    losses = [float(tden.train_step(model, opt, sched, noisy, clean)) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_parameter_files_cross_both_ways(tmp_path):
    """A file of volren_tpu's save_params loads into the port (same output
    as flax's, f32), and the port's save_params writes the same layout,
    which volren_tpu's load_params reads back to the same arrays."""
    jm, params = _flax(16, seed=3)
    path = str(tmp_path / "jax.pkl")
    jden.save_params(path, params)
    model = _port(tden.load_params(path))
    x = _hdr(16, seed=2)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(params, x)), rtol=TOL, atol=TOL)
    mine = str(tmp_path / "port.pkl")
    tden.save_params(mine, model)
    back = jden.load_params(mine)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_denoise_image_helper():
    model, _opt, _sched = tden.create_train_state(0, features=FEATURES, device="cpu")
    img = np.abs(np.random.default_rng(2).normal(size=(20, 24, 3))).astype(np.float32)
    out = tden.denoise_image(model, img)
    assert out.shape == (20, 24, 3) and out.dtype == torch.float32
    assert bool((out >= 0).all()) and bool(torch.isfinite(out).all())
