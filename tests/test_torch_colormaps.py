"""volren_tpu_torch.utils.colormaps against volren_tpu.utils.colormaps
(matplotlib), and TransferFunction.colormap against the JAX package's.

Run as a script to (re)write the port's table file from matplotlib:

    PYTHONPATH=. python tests/test_torch_colormaps.py --write
"""

import os
import sys

import numpy as np
import pytest
import torch

from volren_tpu.scene.transferfunc import TransferFunction as JTransferFunction
from volren_tpu.utils import colormaps as jcm
from volren_tpu_torch.scene.transferfunc import TransferFunction
from volren_tpu_torch.utils import colormaps as tcm

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

NAMES = sorted(set(tcm._MPL_NAMES) | {"parula", "github"})


def matplotlib_tables() -> dict:
    """matplotlib's RGB rows of every map the port carries, as float32
    (the rows its ``Colormap.__call__`` returns)."""
    import matplotlib

    tables = {}
    for name in sorted(set(tcm._MPL_NAMES.values())):
        cmap = matplotlib.colormaps[name]
        cmap(0.0)  # builds the lookup table
        tables[name] = np.asarray(cmap._lut[: cmap.N, :3], np.float64).astype(np.float32)
    return tables


def test_tables_are_matplotlibs():
    want = matplotlib_tables()
    for name, rows in want.items():
        got = tcm.table(name)
        assert got.dtype == np.float32 and got.shape == (256, 3), name
        assert np.array_equal(got, rows), name


@pytest.mark.parametrize("name", NAMES)
def test_colormap_matches_reference_bitwise(name):
    """1001 values of t, the bin edges, and values outside [0, 1]."""
    edges = np.arange(257, dtype=np.float32) / 256
    t = np.concatenate([np.linspace(0.0, 1.0, 1001, dtype=np.float32), edges,
                        np.nextafter(edges, np.float32(2)), np.nextafter(edges, np.float32(-1)),
                        np.array([-1.0, -1e-7, 1.0 + 1e-6, 7.0], np.float32)])
    ours, theirs = tcm.get_colormap(name)(t), jcm.get_colormap(name)(t)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape == (len(t), 3)
    assert np.array_equal(ours, theirs)
    t64 = np.linspace(-0.5, 1.5, 333)
    assert np.array_equal(tcm.get_colormap(name)(t64), jcm.get_colormap(name)(t64))
    with pytest.raises(KeyError):
        tcm.get_colormap(name + "_nope")


@pytest.mark.parametrize("n_bins", [256, 100])
@pytest.mark.parametrize("name", ["turbo", "viridis", "parula", "hsv"])
def test_transferfunc_colormap_matches_reference(name, n_bins):
    ours, theirs = TransferFunction(), JTransferFunction()
    ours.colormap(name, n_bins)
    theirs.colormap(name, n_bins)
    assert ours.lut.dtype == theirs.lut.dtype == np.float32
    assert np.array_equal(ours.lut, theirs.lut)
    assert np.array_equal(ours.device_lut(), theirs.device_lut())


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(__doc__)
    np.savez_compressed(tcm.TABLES, **matplotlib_tables())
    print(f"{os.path.relpath(tcm.TABLES)} written")
