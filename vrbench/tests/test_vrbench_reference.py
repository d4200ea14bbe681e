"""The frozen reference against the program's plain version on the CPU:
bitwise, on the plain and the emission path, at 32x32 and a few samples."""

import numpy as np
import pytest
import torch
from helpers_vrbench import CAMERA, brick_path, settings, sky, temperature  # noqa: F401

from vrbench.inputs import TEMPERATURE_TRANSFORM
from vrbench.reference.render import Job, dispatches_of, render_states
from vrbench.reference.scene import build_scene

W = H = 32


def _program(sky, temperature, seed):
    from volren_tpu_torch.renderer import Renderer
    from volren_tpu_torch.scene.environment import Environment
    from volren_tpu_torch.voldata import DenseGrid, Volume

    r = Renderer(device="cpu")
    r.volume = Volume(brick_path())
    r.scale_and_move_to_unit_cube()
    r.set_environment(Environment(sky))
    r.seed = seed
    if temperature is not None:
        d, h, w = temperature.shape
        r.volume.update_grid_frame(0, DenseGrid(w, h, d, temperature, TEMPERATURE_TRANSFORM),
                                   "temperature")
    r.cam.pos, r.cam.dir, r.cam.up, r.cam.fov_degree = CAMERA
    r.init(W, H)
    r.commit()
    return r


@pytest.mark.parametrize("path", ["plain", "emission"])
def test_reference_is_render_plain_bitwise(path, sky, temperature):
    from volren_tpu_torch.ops.kernels import megakernel
    from volren_tpu_torch.ops.kernels.pack import build_env_pool, build_params

    temp = temperature if path == "emission" else None
    seed, spp, spp_base = 3_000_000_019, 3, 5
    r = _program(sky, temp, seed)
    ks, tp = r._kernel_scene(), r._trace_params()
    pool = build_env_pool(r._env_device, seed, spp_base)
    pf, pi = build_params(ks, tp, W, H, spp_base, spp)
    sums = megakernel.render_plain(ks, pool, pf, pi)
    want = (torch.zeros_like(sums) * 0 + sums) / spp

    scene = build_scene(brick_path(), sky, settings(), temp,
                        TEMPERATURE_TRANSFORM if temp is not None else None, "cpu")
    job = Job(*CAMERA, seed, W, H, ((spp_base, spp),), np.arange(W * H))
    got = render_states(scene, [job])[0]
    assert float(want[:, 3].mean()) > 0.05          # the cloud is in the frame
    assert torch.equal(got, want)


def test_reference_follows_the_running_mean(sky):
    """Two trace calls of the Renderer (three dispatches) against the
    reference's running mean over the same dispatches, at sampled pixels."""
    seed = 11
    r = _program(sky, None, seed)
    r.trace(5)
    r.trace(2)
    fb = r.framebuffer().reshape(-1, 4)
    pixels = np.array([0, 17, 300, 511, 700, 1023])
    scene = build_scene(brick_path(), sky, settings(), None, None, "cpu")
    job = Job(*CAMERA, seed, W, H, dispatches_of([5, 2]), pixels)
    got = render_states(scene, [job, job._replace(pixels=pixels[::2])])
    assert torch.equal(got[0], fb[torch.as_tensor(pixels)])
    assert torch.equal(got[1], fb[torch.as_tensor(pixels[::2])])


def test_dispatches_split_at_64():
    assert dispatches_of([4, 4]) == ((0, 4), (4, 4))
    assert dispatches_of([130]) == ((0, 64), (64, 64), (128, 2))
