"""volpy compatibility shim (the port of volren_tpu.volpy).

The reference embeds a Python module ``volpy``
(reference src/bindings.cpp, PYBIND11_EMBEDDED_MODULE) so datagen
scripts drive the renderer in-process. Here the framework IS Python, so
volpy becomes a thin facade over volren_tpu_torch with the same names:
Renderer, Volume, Environment, TransferFunction, vec2..mat4, COLMAP
helpers.

Scripts written against the reference's volpy ("import volpy") run after
adding this module under that name — ``bind_renderer`` installs it in
sys.modules (done automatically by the CLI script runner), in place of
any other module of that name. A ``Renderer()`` made before any renderer
is bound renders on the CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np

from .renderer import Renderer as _CoreRenderer
from .scene.environment import Environment as _Environment
from .scene.transferfunc import TransferFunction as _TransferFunction
from .voldata import Volume as _Volume


# ---- glm-ish vector shims: numpy arrays with .x/.y/.z/.w access ----


class _Vec(np.ndarray):
    _fields = "xyzw"
    _dtype = np.float32

    def __new__(cls, *args):
        n = cls._n
        if len(args) == 0:
            data = np.zeros(n, cls._dtype)
        elif len(args) == 1 and np.isscalar(args[0]):
            data = np.full(n, args[0], cls._dtype)
        elif len(args) == 1:
            data = np.asarray(args[0], cls._dtype).reshape(n)
        else:
            data = np.asarray(args, cls._dtype).reshape(n)
        return data.view(cls)

    def __getattr__(self, name):
        if len(name) == 1 and name in self._fields[: self._n]:
            v = self[self._fields.index(name)]
            return float(v) if self._dtype == np.float32 else int(v)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if len(name) == 1 and name in self._fields[: self._n]:
            self[self._fields.index(name)] = value
        else:
            super().__setattr__(name, value)

    def normalize(self):
        return self / np.linalg.norm(self)

    def length(self):
        return float(np.linalg.norm(self))


class vec2(_Vec):
    _n = 2


class vec3(_Vec):
    _n = 3


class vec4(_Vec):
    _n = 4


# integer vectors are genuinely int-backed (bindings.cpp registers glm
# i/uvec types with the same field access and operators)
class ivec2(_Vec):
    _n, _dtype = 2, np.int32


class ivec3(_Vec):
    _n, _dtype = 3, np.int32


class ivec4(_Vec):
    _n, _dtype = 4, np.int32


class uvec2(_Vec):
    _n, _dtype = 2, np.uint32


class uvec3(_Vec):
    _n, _dtype = 3, np.uint32


class uvec4(_Vec):
    _n, _dtype = 4, np.uint32


class quat:
    """glm-style quaternion, (w, x, y, z) constructor order as in glm and
    the reference bindings (bindings.cpp quat registration). Supports the
    operations the reference scripts rely on: field access, Hamilton
    product, vec3 rotation, normalize, conjugate, mat3 conversion."""

    __slots__ = ("_q",)

    def __init__(self, *args):
        if len(args) == 0:
            self._q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        elif len(args) == 1:
            a = args[0]
            if isinstance(a, quat):
                self._q = a._q.copy()
            else:
                self._q = np.asarray(a, np.float32).reshape(4)
        elif len(args) == 4:
            self._q = np.asarray(args, np.float32)
        else:
            raise TypeError("quat(), quat(q), or quat(w, x, y, z)")

    w = property(lambda self: float(self._q[0]))
    x = property(lambda self: float(self._q[1]))
    y = property(lambda self: float(self._q[2]))
    z = property(lambda self: float(self._q[3]))

    def __array__(self, dtype=None, copy=None):
        return np.array(self._q, dtype=dtype or np.float32)

    def __iter__(self):
        return iter(float(v) for v in self._q)

    def __repr__(self):
        w, x, y, z = self._q
        return f"quat({w:g}, {x:g}, {y:g}, {z:g})"

    def normalize(self):
        return quat(self._q / np.linalg.norm(self._q))

    def conjugate(self):
        w, x, y, z = self._q
        return quat(w, -x, -y, -z)

    def to_mat3(self):
        w, x, y, z = self.normalize()._q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )

    def __mul__(self, other):
        if isinstance(other, quat):
            w1, x1, y1, z1 = self._q
            w2, x2, y2, z2 = other._q
            return quat(
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            )
        v = np.asarray(other, np.float32).reshape(3)
        return vec3(self.to_mat3() @ v)


def mat3(*args):
    if not args:
        return np.eye(3, dtype=np.float32)
    if len(args) == 1 and np.isscalar(args[0]):
        return np.eye(3, dtype=np.float32) * args[0]
    return np.asarray(args, np.float32).reshape(3, 3)


def mat4(*args):
    if not args:
        return np.eye(4, dtype=np.float32)
    if len(args) == 1 and np.isscalar(args[0]):
        return np.eye(4, dtype=np.float32) * args[0]
    return np.asarray(args, np.float32).reshape(4, 4)


Volume = _Volume
Environment = _Environment
TransferFunction = _TransferFunction
# buffer-protocol image type of the reference bindings (bindings.cpp:69-80);
# numpy arrays serve the same role here
ImageDataFloat = np.ndarray

_bound: dict = {"renderer": None}


def bind_renderer(renderer) -> None:
    """Install this module as ``volpy`` bound to a live renderer."""
    _bound["renderer"] = renderer
    sys.modules["volpy"] = sys.modules[__name__]


class Renderer:
    """volpy.Renderer facade: property names follow bindings.cpp:150-216.

    Camera fields are exposed as class-level properties on the instance
    (the reference exposes them as statics on the single global camera)."""

    def __init__(self):
        core = _bound["renderer"] or _CoreRenderer()
        _bound["renderer"] = core
        object.__setattr__(self, "_core", core)

    # lifecycle
    def init(self, width: int = 1024, height: int = 1024):
        self._core.init(width, height)

    def commit(self):
        self._core.commit()

    def trace(self):
        self._core.trace()

    def reset(self):
        self._core.reset()

    def scale_and_move_to_unit_cube(self):
        self._core.scale_and_move_to_unit_cube()

    def render(self, spp: int):
        self._core.render(spp)

    def draw(self):
        return self._core.draw()

    @staticmethod
    def resolution():
        return vec2(*_bound["renderer"].resolution)

    def fbo_data(self):
        return self._core.fbo_data()

    def save(self, filename: str = "out.png"):
        self._core.save(filename)

    def save_with_alpha(self, filename: str = "out.png"):
        self._core.save_with_alpha(filename)

    @staticmethod
    def shutdown():
        sys.exit(0)

    # COLMAP helpers (bindings.cpp:196-206)
    @staticmethod
    def colmap_view_trans():
        return vec3(_bound["renderer"].cam.colmap_view_trans())

    @staticmethod
    def colmap_view_rot():
        return quat(_bound["renderer"].cam.colmap_view_rot())

    @staticmethod
    def colmap_focal_length():
        r = _bound["renderer"]
        return r.cam.colmap_focal_length(r.resolution[1])

    @staticmethod
    def cam_aspect():
        w, h = _bound["renderer"].resolution
        return w / h

    # scalar/vector members forwarded to the core renderer
    _FORWARD = {
        "volume",
        "sample",
        "sppx",
        "bounces",
        "seed",
        "tonemap_exposure",
        "tonemap_gamma",
        "tonemapping",
        "show_environment",
        "phase",
        "density_scale",
        "emission_scale",
        "vol_clip_min",
        "vol_clip_max",
    }

    def __getattr__(self, name):
        core = object.__getattribute__(self, "_core")
        if name in Renderer._FORWARD:
            return getattr(core, name)
        if name == "albedo":
            return vec3(core.albedo)
        if name == "environment":
            return core.environment
        if name == "transferfunc":
            return core.transferfunc
        if name in ("cam_pos", "cam_dir", "cam_up"):
            return vec3(getattr(core.cam, name[4:]))
        if name == "cam_fov":
            return core.cam.fov_degree
        if name == "cam_near":
            return core.cam.near
        if name == "cam_far":
            return core.cam.far
        if name == "view_matrix":
            return core.cam.view
        raise AttributeError(name)

    def __setattr__(self, name, value):
        core = object.__getattribute__(self, "_core")
        if name in Renderer._FORWARD:
            setattr(core, name, value)
        elif name == "albedo":
            core.albedo = np.broadcast_to(np.asarray(value, np.float32), (3,)).copy()
        elif name == "environment":
            core.set_environment(value)
        elif name == "transferfunc":
            core.set_transferfunc(value)
        elif name in ("cam_pos", "cam_dir", "cam_up"):
            setattr(core.cam, name[4:], np.asarray(value, np.float32))
            if name == "cam_dir":
                core.cam.dir = core.cam.dir / np.linalg.norm(core.cam.dir)
        elif name == "cam_fov":
            core.cam.fov_degree = float(value)
        else:
            object.__setattr__(self, name, value)
