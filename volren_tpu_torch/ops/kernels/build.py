"""Build and bind a CUDA source of ``volren_tpu_torch/csrc``: nvcc for
sm_90a into a shared library with a plain C interface under ``build/``,
loaded with ctypes. Nothing here runs at import; the card's machine has
nvcc, this package's CPU-only users never call it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
CSRC = os.path.join(REPO_ROOT, "volren_tpu_torch", "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              # no multiply-add contraction: a kernel rounds every operation
              # as its plain torch version's separate ops do (a kernel asks
              # for an fma explicitly where its plain version has one)
              "-fmad=false"]


def build(source: str, name: str, flags: list[str] = NVCC_FLAGS) -> str:
    """Compile ``source`` with nvcc into ``build/lib<name>_<hash>.so`` and
    return its path. The hash covers the source and the flags, so an edit
    always rebuilds. nvcc's output (with ptxas's resource usage) is kept
    beside the library as ``.log``."""
    with open(source, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    with open(f"{out}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def resource_usage(lib_path: str, rename=lambda kernel: kernel) -> list[str]:
    """ptxas's register, stack and spill lines for the library at
    ``lib_path``: one "<kernel> <usage>" entry per line ptxas printed, the
    kernel's mangled name passed through ``rename``."""
    out, name = [], "?"
    with open(f"{lib_path}.log") as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                          line)
            if m:
                name = rename(m.group(1))
            elif "registers" in line or "stack frame" in line:
                out.append(f"{name} {line.split(':', 1)[-1].strip()}")
    return out


def load(lib_path: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load a built library and declare its C entry points: ``signatures``
    maps each name to its argument types; every entry point returns the
    ``cudaError_t`` of its launch as an int."""
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
