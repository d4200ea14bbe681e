"""Volume container: animation frames of named grids (numpy copy of
volren_tpu.voldata.volume).

Mirrors voldata::Volume (API from call sites in
reference src/renderer.cpp:56-124, reference src/main.cpp:37-62
and reference src/bindings.cpp:83-94): frames are maps of grid name ->
grid, with a shared world transform and a frame counter; ``load_folder``
loads an alphanumerically-ordered animation.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .brick_io import read_brick, read_dense
from .grid import DenseGrid, Grid


def load_grid(path: str, name: str = "density") -> Grid:
    """Load a single named grid from a file, dispatched by extension
    (cf. voldata::Volume::load_grid, call site reference src/main.cpp:49):
    .brick, .dense, .nvdb, .vdb, and DICOM (.dcm, .dicom, or no extension:
    a single file or a series folder)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".brick":
        return read_brick(path)
    if ext == ".dense":
        return read_dense(path)
    if ext == ".nvdb":
        from .nanovdb import read_nanovdb

        return read_nanovdb(path, name)
    if ext == ".vdb":
        from .vdb import read_vdb

        return read_vdb(path, name)
    if ext in (".dcm", ".dicom", ""):
        from .dicom import read_dicom

        return read_dicom(path)
    raise ValueError(f"unsupported grid file extension: {path}")


def _alphanum_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


class Volume:
    GRID_NAMES_EMISSION = ("flame", "flames", "temperature")

    def __init__(self, arg=None, *args):
        self.grids: list[dict[str, Grid]] = []
        self.grid_frame_counter: int = 0
        self.transform: np.ndarray = np.eye(4, dtype=np.float32)
        if arg is None:
            return
        if isinstance(arg, Grid):
            self.grids.append({"density": arg})
        elif isinstance(arg, (str, os.PathLike)):
            grid = load_grid(str(arg))
            self.grids.append({"density": grid})
        elif isinstance(arg, (int, np.integer)) and len(args) >= 3:
            # Volume(w, h, d, data) as in bindings.cpp:83-85
            w, h, d, data = arg, args[0], args[1], args[2]
            self.grids.append({"density": DenseGrid(w, h, d, data)})
        else:
            raise TypeError(f"cannot construct Volume from {arg!r}")

    # ---- frame management ----

    def clear(self) -> None:
        self.grids.clear()
        self.grid_frame_counter = 0

    def add_grid_frame(self, grid: Grid | None = None, name: str = "density") -> None:
        self.grids.append({} if grid is None else {name: grid})

    def update_grid_frame(self, frame: int, grid: Grid, name: str = "density") -> None:
        while len(self.grids) <= frame:
            self.grids.append({})
        self.grids[frame][name] = grid

    def n_grid_frames(self) -> int:
        return len(self.grids)

    def current_grid(self, name: str = "density") -> Grid:
        return self.grids[self.grid_frame_counter][name]

    def current_frame(self) -> dict[str, Grid]:
        return self.grids[self.grid_frame_counter]

    # ---- queries ----

    def AABB(self, name: str = "density") -> tuple[np.ndarray, np.ndarray]:
        """World-space AABB of the current frame's grid, including the
        volume-level transform."""
        grid = self.current_grid(name)
        ext = np.asarray(grid.index_extent(), dtype=np.float32)
        corners = np.array(
            [[x, y, z, 1.0] for x in (0, ext[0]) for y in (0, ext[1]) for z in (0, ext[2])],
            dtype=np.float32,
        )
        M = self.transform @ np.asarray(grid.transform, np.float32)
        world = corners @ M.T
        return world[:, :3].min(axis=0), world[:, :3].max(axis=0)

    def minorant_majorant(self, name: str = "density") -> tuple[float, float]:
        return self.current_grid(name).minorant_majorant()

    # ---- loading ----

    @classmethod
    def load_folder(cls, path: str, grid_names=("density", "temperature", "flame", "flames")) -> "Volume":
        """Load every grid file in a folder as animation frames, in
        alphanumeric order (cf. reference src/main.cpp:40-42,
        README.md:80)."""
        vol = cls()
        files = sorted(
            (f for f in os.listdir(path) if not f.startswith(".")), key=_alphanum_key
        )
        for fname in files:
            fpath = os.path.join(path, fname)
            if not os.path.isfile(fpath):
                continue
            frame: dict[str, Grid] = {}
            for name in grid_names:
                try:
                    frame[name] = load_grid(fpath, name)
                except Exception:
                    continue
            if frame:
                if "density" not in frame:
                    # single-grid formats: treat the first grid as density
                    frame["density"] = next(iter(frame.values()))
                vol.grids.append(frame)
        if not vol.grids:
            raise RuntimeError(f"no loadable grids found in folder: {path}")
        return vol

    def to_string(self, indent: str = "") -> str:
        lines = [f"{indent}Volume: {len(self.grids)} frame(s), frame counter {self.grid_frame_counter}"]
        lines.append(f"{indent}transform:\n{indent}{self.transform}")
        for i, frame in enumerate(self.grids):
            for name, grid in frame.items():
                lines.append(f"{indent}[{i}] {name}: {grid.to_string()}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.to_string()

