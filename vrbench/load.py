"""The one general generator of the benchmark's traffic: a closed loop of
render steps, read from a traffic file's parameters.

Step ``i`` of a window is ``trace(spp)`` and a device sync, as a user who
waits for each image sees it. Every ``reset_every`` steps a group starts:
the camera orbits the volume by the next of the orbit's angles (when the
traffic orbits), the render seed changes (when ``new_seed_each_group``),
and the accumulation restarts (``reset()``). A traffic file holds:

- ``width``, ``height``: the frame; ``spp``: samples a step;
- ``reset_every``: steps a group; ``new_seed_each_group``: a fresh render
  seed a group, else one seed for the run;
- ``orbit``: null, or ``{"min_deg", "max_deg", "values"}``: the group's turn
  about the volume's vertical axis, one of ``values`` evenly spaced angles,
  the same for every seed in a seeded order;
- ``warmup_steps``: set-up's steps of one dispatch each, untimed;
- ``check``: ``{"pixels", "steps", "steps_within"}``: pixels a checked
  framebuffer state compares, and how many steps drawn from the first
  ``steps_within`` are checked besides the window's last one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .inputs import Seeds, orbit_camera, orbit_increments

# the render seeds drawn ahead: more groups than any window holds
MAX_GROUPS = 1 << 17


class Step(NamedTuple):
    group: int
    first_of_group: bool
    spp: int


class Schedule:
    """The steps, cameras and seeds of one run of a traffic file."""

    def __init__(self, traffic: dict, seeds: Seeds, camera: dict):
        self.traffic = traffic
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.spp = int(traffic["spp"])
        self.reset_every = int(traffic["reset_every"])
        if self.spp < 1 or self.reset_every < 1:
            raise ValueError("a traffic's spp and reset_every are at least 1")
        self.pos0 = np.asarray(camera["pos"], np.float32)
        self.up = np.asarray(camera["up"], np.float32)
        self.fov = float(camera["fov"])
        d = np.asarray(camera["dir"], np.float32)
        self.dir0 = (d / np.linalg.norm(d)).astype(np.float32)
        seeds_per_group = MAX_GROUPS if traffic["new_seed_each_group"] else 1
        self._seeds = seeds.render_seeds(seeds_per_group)
        orbit = traffic.get("orbit")
        self._turns = None
        if orbit:
            incs = orbit_increments(float(orbit["min_deg"]), float(orbit["max_deg"]),
                                    int(orbit["values"]), seeds.orbit)
            self._turns = (np.cumsum(incs), float(incs.sum()))

    def step(self, i: int) -> Step:
        return Step(i // self.reset_every, i % self.reset_every == 0, self.spp)

    def seed(self, group: int) -> int:
        return self._seeds[group % len(self._seeds)]

    def camera(self, group: int):
        """(pos, dir) of a group's camera, float32."""
        if self._turns is None:
            return self.pos0, self.dir0
        cum, lap = self._turns
        return orbit_camera(self.pos0, (group // len(cum)) * lap + cum[group % len(cum)])

    def traces_since_reset(self, i: int) -> list[int]:
        """The sample counts of the trace calls from step ``i``'s group start
        through step ``i``."""
        return [self.spp] * (i % self.reset_every + 1)
