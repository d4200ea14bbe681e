"""volren_tpu_torch.ops.rng: TEA-32 seeding and the LCG stream, bitwise
against volren_tpu.ops.rng over 2^18 (pixel, sample) pairs."""

import jax.numpy as jnp
import numpy as np
import torch

from volren_tpu.ops import rng as jrng
from volren_tpu_torch.ops import rng as trng

N = 1 << 18


def _pairs():
    rng = np.random.default_rng(123)
    seed = np.uint32(rng.integers(0, 2**32, dtype=np.uint64))
    pixel = np.arange(N, dtype=np.uint32) * np.uint32(977)       # spread lanes
    sample = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return seed * pixel, sample


def test_mul32_matches_uint32_wraparound():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    got = trng.mul32(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), a * b)


def test_tea_and_lcg_bitwise():
    v0, v1 = _pairs()
    ref = np.asarray(jrng.tea(jnp.asarray(v0), jnp.asarray(v1)))
    got = trng.tea(torch.from_numpy(v0.astype(np.int64)), torch.from_numpy(v1.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), ref)

    js, ts = jnp.asarray(ref), got
    for _ in range(4):
        js, ju = jrng.rng(js)
        ts, tu = trng.rng(ts)
        assert np.array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
        assert np.array_equal(tu.numpy(), np.asarray(ju))


def test_masked_draw_advances_only_active_lanes():
    v0, v1 = _pairs()
    state = trng.tea(torch.from_numpy(v0[:4096].astype(np.int64)),
                     torch.from_numpy(v1[:4096].astype(np.int64)))
    active = torch.from_numpy(np.arange(4096) % 3 == 0)
    new, u = trng.rng_masked(state, active)
    ref_state, ref_u = jrng.rng_masked(jnp.asarray(state.numpy().astype(np.uint32)),
                                       jnp.asarray(active.numpy()))
    assert np.array_equal(new.numpy().astype(np.uint32), np.asarray(ref_state))
    assert np.array_equal(u.numpy(), np.asarray(ref_u))
