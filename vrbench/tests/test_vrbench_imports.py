"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level module names compared whole: ``volren_tpu_torch`` is the
program, ``volren_tpu`` is not), and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from helpers_vrbench import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "volren_tpu"}
HARNESS = ["vrbench.run", "vrbench.check", "vrbench.cell", "vrbench.load", "vrbench.inputs",
           "vrbench.profile", "vrbench.stats", "vrbench.roofline"]
REFERENCE = ["vrbench.reference.scene", "vrbench.reference.render", "vrbench.check"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in list(sys.modules)}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    readers = [f[:-3] for f in os.listdir(os.path.join(ROOT, "vrbench", "metrics"))
               if f.endswith(".py")]
    code = "\n".join(f"import {m}" for m in HARNESS) + "\nfrom vrbench.cell import reader\n"
    code += "".join(f"reader({name!r})\n" for name in readers)
    # what the harness runs of the program
    code += ("import volren_tpu_torch.renderer, volren_tpu_torch.scene.environment, "
             "volren_tpu_torch.voldata, volren_tpu_torch.ops.kernels.megakernel, "
             "volren_tpu_torch.ops.kernels.pack\n")
    loaded = _loaded(code)
    assert "volren_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert not loaded & (FORBIDDEN | {"volren_tpu_torch"})


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "vrbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])
                for name in names:
                    assert name.split(".")[0] not in FORBIDDEN, (f, name)
