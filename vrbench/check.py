"""What decides ``correct``: the framebuffer values the window produced, at
pixels drawn from the seed, against the reference's values for the same
states (vrbench.reference), worked out from the same inputs.

The program's kernel is the bitwise image of its plain version, which the
reference freezes: the comparison is exact. Two numbers are compared, each
with the limit 0: ``values_differing``, the framebuffer values (four
channels a pixel) that are not equal to the reference's (a NaN equals a
NaN), and ``max_abs_diff``, the largest absolute difference (NaN or inf
read as inf).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .reference.render import Job, render_states
from .reference.scene import build_scene, camera_slots

LIMITS = {"values_differing": 0, "max_abs_diff": 0.0}


class State(NamedTuple):
    """A framebuffer state the window left: the job the reference works
    out, and the program's values at the job's pixels, (n, 4) float32."""

    job: Job
    values: np.ndarray


def pick_pixels(rng: np.random.Generator, cam_pos, cam_dir, cam_up, fov, width: int,
                height: int, n: int) -> np.ndarray:
    """``n`` distinct flat pixel indices: half drawn over the frame that the
    unit cube around the volume covers on screen, the rest over the whole
    frame."""
    slots = camera_slots(cam_pos, cam_dir, cam_up, fov)
    pos, rot, z_cam = slots[:3].astype(np.float64), slots[3:12].reshape(3, 3), float(slots[12])
    corners = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    view = (corners - pos) @ rot.astype(np.float64)      # rot is view -> world
    x0, x1, y0, y1 = 0, width, 0, height
    if (view[:, 2] < 0).all():
        s = z_cam / view[:, 2]
        px = view[:, 0] * s * height + 0.5 * width
        py = view[:, 1] * s * height + 0.5 * height
        x0, x1 = max(0, int(np.floor(px.min()))), min(width, int(np.ceil(px.max())) + 1)
        y0, y1 = max(0, int(np.floor(py.min()))), min(height, int(np.ceil(py.max())) + 1)
        if x1 <= x0 or y1 <= y0:
            x0, x1, y0, y1 = 0, width, 0, height
    inner = (np.arange(y0, y1)[:, None] * width + np.arange(x0, x1)[None, :]).reshape(-1)
    n_in = min(n // 2, inner.size)
    picked = rng.choice(inner, n_in, replace=False)
    rest = np.setdiff1d(np.arange(width * height), picked)
    picked = np.concatenate([picked, rng.choice(rest, min(n - n_in, rest.size), replace=False)])
    return np.sort(picked).astype(np.int64)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """The two numbers compared, of (n, 4) float32 arrays."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    diff = np.where(same, 0.0, np.where(np.isfinite(diff), diff, np.inf))
    return {"values_differing": int((~same).sum()),
            "max_abs_diff": float(diff.max()) if diff.size else 0.0}


def reference_values(config: dict, brick_path: str, inputs, jobs: list, device,
                     dtype=torch.float32) -> list:
    """The reference's values at each job's pixels (``dtype`` bfloat16: the
    control)."""
    scene = build_scene(brick_path, inputs.sky, config["settings"], inputs.temperature,
                        inputs.temperature_transform, device)
    return [v.cpu().numpy() for v in render_states(scene, jobs, dtype)]


def judge(states: list, want: list) -> tuple[bool, dict]:
    """(correct, readings): the readings over every state, each within its
    limit."""
    readings = {"values_differing": 0, "max_abs_diff": 0.0}
    for st, w in zip(states, want):
        r = compare(st.values, w)
        readings["values_differing"] += r["values_differing"]
        readings["max_abs_diff"] = max(readings["max_abs_diff"], r["max_abs_diff"])
    ok = all(readings[k] <= LIMITS[k] for k in LIMITS) and bool(states)
    return ok, readings
