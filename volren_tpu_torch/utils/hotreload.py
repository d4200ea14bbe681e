"""Kernel hot reload — the counterpart of the reference's shader reload
(volren_tpu.utils.hotreload reloads the JAX package's Python kernels).

The reference polls shader mtimes every second and recompiles + resets the
progressive accumulation on change (reference src/main.cpp:490-496). Here
the "shaders" are the CUDA sources in ``volren_tpu_torch/csrc``: on a
change, a source whose library is loaded is rebuilt through
``ops/kernels/build.py`` (whose hash covers the source and the shared
``.cuh`` headers; a changed header rebuilds every loaded source) and the
new library replaces the old one under its module's lock; the caller
resets its accumulation. A failed build prints nvcc's error and keeps the loaded
library, as the reference keeps its old shader.
"""

from __future__ import annotations

import os

from ..ops.kernels import build as _build
from ..ops.kernels import megakernel, oracle

# a source's file name -> the module that builds, loads and holds its
# library (the probes' kernels run on no render path)
KERNELS = {"megakernel.cu": megakernel, "oracle.cu": oracle}


class KernelWatcher:
    def __init__(self, csrc: str = _build.CSRC, kernels: dict | None = None):
        self.csrc = csrc
        self.kernels = KERNELS if kernels is None else kernels
        self._mtimes: dict[str, float] = {}
        self._scan()

    def _files(self):
        return sorted(os.path.join(self.csrc, f) for f in os.listdir(self.csrc)
                      if f.endswith((".cu", ".cuh")))

    def _scan(self) -> list[str]:
        changed = []
        for path in self._files():
            try:
                m = os.path.getmtime(path)
            except OSError:
                continue
            if self._mtimes.get(path, m) != m:
                changed.append(path)
            self._mtimes[path] = m
        return changed

    def reload_modified_kernels(self) -> bool:
        """Returns True if a modified source's library was rebuilt and
        swapped in (callers should reset() their accumulation, like the
        reference). A library not loaded yet is left alone: its first
        launch builds the source as it then is."""
        swapped = False
        changed = self._scan()
        if any(p.endswith(".cuh") for p in changed):
            changed = [os.path.join(self.csrc, name) for name in self.kernels]
        for path in changed:
            module = self.kernels.get(os.path.basename(path))
            if module is None or module._LIB is None:
                continue
            try:
                lib = module.load(module.build(source=path))
            except (RuntimeError, OSError) as e:
                print(f"kernel reload of {path} failed; keeping the loaded library:\n{e}")
                continue
            with module._LIB_LOCK:
                module._LIB = lib
            print(f"reloaded {os.path.basename(path)}")
            swapped = True
        return swapped
