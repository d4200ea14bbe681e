"""Shared set-up of the benchmark's CPU tests: one torch thread (the tensors
are small), the cells cut to a frame a test can hold, and the inputs."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)


def small_cell(name: str, width: int = 16, height: int = 16, spp: int = 2, pixels: int = 12,
               **traffic):
    """The cell ``name`` at a frame and a sample count a CPU test can hold,
    its warm-up one step and its check's sampled steps among the first two."""
    from vrbench.cell import load_cell

    cell = load_cell(name)
    t = dict(cell.traffic, width=width, height=height, spp=spp, warmup_steps=1, **traffic)
    t["check"] = dict(t["check"], pixels=pixels, steps=min(t["check"]["steps"], 1),
                      steps_within=2)
    return cell._replace(traffic=t)


@pytest.fixture(scope="session")
def sky():
    from vrbench.inputs import procedural_sky

    return procedural_sky(1024, 512, 7)


@pytest.fixture(scope="session")
def temperature():
    from vrbench.inputs import temperature_grid

    return temperature_grid(256, 256, 128, 7)


def brick_path():
    return os.path.join(ROOT, ".scene_cache", "cloud512.brick")


def settings():
    return {"bounces": 100, "albedo": 0.9, "phase": 0.0, "density_scale": 1.0,
            "emission_scale": 100.0, "show_environment": True}


CAMERA = (np.array([1.0, 0.0, 1.0], np.float32),
          (np.array([-1.0, 0.0, -1.0], np.float32) / np.linalg.norm([-1.0, 0.0, -1.0]))
          .astype(np.float32),
          np.array([0.0, 1.0, 0.0], np.float32), 70.0)
