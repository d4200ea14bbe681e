"""The probe kernels' plain versions (volren_tpu_torch.ops.kernels.probes)
against the Pallas probes they replace (probes/probe_*.py and the
_scan_gather harness), on the CPU: the same numpy inputs go through the
Pallas kernel under TPU interpret mode and through the port.

Where the function that builds a probe.s kernel is reachable (_loop_fn, _axis0_gather_fn,
mask_reduce_gather, VARIANTS, make_fn, _scan_gather) the test calls it;
where the kernel is built inside a guarded stage, the test runs the stage
in interpret mode with its output file under tmp_path and its timing
helpers cut to the correctness call, requires ``ok``, records what the
stage pulls to the host, and holds the port against that and against the
stage's numpy oracle. Round and iteration counts are patched down
(module attributes or arguments), never the probes' source.

Bars: bitwise for gathers, integer and u32 results, per-lane accumulators,
affine_loop and carry_loop (the JAX reference on this CPU fuses x * a + b
into one fma, and the port computes the same fma); relative 1e-6 on float
totals (another summation order); rtol 1e-5 for row_scan.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from volren_tpu_torch import probes as port_probes
from volren_tpu_torch.ops.kernels import probes as K
from volren_tpu_torch.probes import probe_dmagather as port_dmagather
from volren_tpu_torch.probes import variants
from volren_tpu_torch.probes.sites import SITES

# one intra-op thread: these tensors are small, and the test workers share the cores
torch.set_num_threads(1)

TOTAL_BAR = 1e-6


@pytest.fixture(autouse=True)
def _keep_jax_cache_env(monkeypatch):
    """Importing a probe sets JAX_COMPILATION_CACHE_DIR (its
    setup_compilation_cache); each test's teardown restores the variable."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """Import probes/<name>.py with its output file under tmp_path and a
    recorder on its host pull; returns (module, pulled arrays)."""
    def load(name):
        mod = importlib.import_module(f"probes.{name}")
        monkeypatch.setattr(mod, "OUT", str(tmp_path / f"{name}.jsonl"))
        pulled = []
        if hasattr(mod, "pull"):
            def pull(x):
                a = np.asarray(x)
                pulled.append(a)
                return a
            monkeypatch.setattr(mod, "pull", pull)
        return mod, pulled
    return load


def _interpret():
    return pltpu.force_tpu_interpret_mode()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _no_timing(monkeypatch, mod, returns):
    """Cut the stage's timing helper to nothing (its correctness call
    stays)."""
    for name in ("time_calls", "_marginal"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, lambda *a, **k: returns)


def _relerr(got, want):
    return abs(got - want) / max(abs(want), 1.0)


def _port_total(acc):
    return float(acc.sum(dtype=torch.float64))


# ---------------------------------------------------------------- affine_loop

def test_p0_launch_floor_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas")
    _no_timing(monkeypatch, mod, (0.0, [0.0]))
    with _interpret():
        assert mod.p0()["ok"]
    x = np.ones((8, 128), np.float32)
    assert np.array_equal(K.affine_loop(_t(x), 1, 2.0, 0.0).numpy(), pulled[0])


def test_p1_inkernel_loop_matches_pallas_bitwise():
    mod = importlib.import_module("probes.probe_pallas")
    x = np.random.default_rng(0).random((256, 512)).astype(np.float32)
    with _interpret():
        want = np.asarray(mod._loop_fn(256, (256, 512))(jnp.asarray(x)))
    got = K.affine_loop(_t(x), 256, 1.0000001, 0.000001)
    assert np.array_equal(got.numpy(), want)


def test_p2_device_trip_count_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas")
    _no_timing(monkeypatch, mod, (0.0, [0.0]))
    with _interpret():
        assert mod.p2()["ok"]
    x = _t(np.ones((256, 512), np.float32))
    got = K.affine_loop(x, a=1.0000001, b=0.000001, iters_dev=_t(np.array([64], np.int32)))
    assert np.array_equal(got.numpy(), pulled[0])


def test_p4_launch_loop_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas")
    _no_timing(monkeypatch, mod, (0.0, [0.0]))
    with _interpret():
        assert mod.p4()["ok"]
    y = _t(np.ones((256, 512), np.float32))
    for _ in range(2):        # the stage's warm call: n = 2 outer iterations
        y = K.affine_loop(y, 64, 1.0000001, 0.000001)
    assert np.array_equal(y.numpy(), pulled[0])


def test_fma32_is_one_rounding():
    """A product whose float64 sum lands on a float32 tie: the plain
    version's fma rounds once, as the kernels' __fmaf_rn does."""
    x = torch.tensor([1 + 2 ** -12, 1 + 2 ** -12], dtype=torch.float32)
    z = torch.tensor([2 ** -80, -2 ** -80], dtype=torch.float32)
    got = K.fma32(x, torch.tensor(1 + 2 ** -12), z).double().tolist()
    assert got == [1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -11]


# ---------------------------------------------------------------- gather

@pytest.mark.parametrize("stage,row_mod", [("p3a", 0), ("p3b", 2048)])
def test_p3_table_gather_matches_pallas(probe, monkeypatch, stage, row_mod):
    mod, pulled = probe("probe_pallas")
    orig = mod.time_calls
    monkeypatch.setattr(mod, "time_calls", lambda fn, mk, n=8: orig(fn, mk, n=1))
    with _interpret():
        assert getattr(mod, stage)()["ok"]
    table = _t(np.asarray(mod._table()))
    got = K.gather(table, _t(mod._mk_idx(0)), row_mod=row_mod).numpy()
    assert np.array_equal(got, pulled[0])


def test_p3c_scalar_loop_gather_matches_oracle(probe, monkeypatch):
    mod, _ = probe("probe_pallas")
    _no_timing(monkeypatch, mod, (0.0, [0.0]))
    with _interpret():
        assert mod.p3c()["ok"]          # the Pallas kernel met the stage's _check
    idx = mod._mk_idx(0)
    got = K.gather(_t(np.asarray(mod._table())), _t(idx)).numpy()
    assert np.array_equal(got, (idx.astype(np.int64) * 0.5).astype(np.float32))


def test_p3d_row_fetch_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas")
    orig = mod.time_calls
    monkeypatch.setattr(mod, "time_calls", lambda fn, mk, n=8: orig(fn, mk, n=1))
    with _interpret():
        assert mod.p3d()["ok"]
    t2 = np.asarray(mod._table()).reshape(128, 128)
    rows = np.random.default_rng(70).integers(0, 128, (8, 1), dtype=np.int32)
    assert np.array_equal(K.gather(_t(t2), _t(rows)).numpy(), pulled[0])


@pytest.mark.parametrize("n,dtype", [(1024, np.float32), (16384, np.float32), (4096, np.int32)])
def test_q1_axis0_gather_matches_pallas(n, dtype):
    mod = importlib.import_module("probes.probe_pallas2")
    flat = (np.arange(n, dtype=np.float32) * 0.25 if dtype == np.float32
            else np.arange(n, dtype=np.int32) * 3)
    t = np.tile(flat[:, None], (1, 128))
    idx = np.random.default_rng(100 if dtype == np.float32 else 5).integers(
        0, n, (n, 128), dtype=np.int32)
    with _interpret():
        want = np.asarray(mod._axis0_gather_fn(n, jnp.dtype(dtype))(t, idx))
    assert np.array_equal(K.gather(_t(t), _t(idx)).numpy(), want)


def test_q2_inrow_shuffle_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas2")
    _no_timing(monkeypatch, mod, 0.0)
    with _interpret():
        assert mod.q2()["ok"]
    for r, want in zip((8, 3584), pulled):
        t = np.random.default_rng(1).random((r, 128)).astype(np.float32)
        idx = np.random.default_rng(300).integers(0, 128, (r, 128), dtype=np.int32)
        assert np.array_equal(K.gather(_t(t), cols=_t(idx)).numpy(), want)


def test_q4_general_gather_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas2")
    _no_timing(monkeypatch, mod, 0.0)
    with _interpret():
        assert mod.q4()["ok"]
    t = np.random.default_rng(2).random((3584, 128)).astype(np.float32)
    rng = np.random.default_rng(400)
    r = rng.integers(0, 3584, (8, 128), dtype=np.int32)
    c = rng.integers(0, 128, (8, 128), dtype=np.int32)
    assert np.array_equal(K.gather(_t(t), _t(r), _t(c)).numpy(), pulled[0])


def test_w3_axis0_small_matches_pallas(probe):
    mod, pulled = probe("probe_pallas3")
    with _interpret():
        rec = mod.w3()
    assert rec["ok"] and rec["R8"] == "ok" and rec["R32"] == "ok"
    for r, want in zip((8, 32), pulled):
        t = (np.arange(r * 128) % 977).astype(np.float32).reshape(r, 128)
        idx = np.random.default_rng(3).integers(0, r, (r, 128), dtype=np.int32)
        assert np.array_equal(K.gather(_t(t), _t(idx)).numpy(), want)


def test_scan_gather_harness_matches_pallas():
    """The harness of tests/test_pallas.py:55 around kernel.py's
    _scan_gather, on its shapes and seed: both tables in one gather call,
    as the one pallas_call gathers them."""
    from volren_tpu.ops.pallas.kernel import _scan_gather
    from volren_tpu_torch.probes.scan_gather import ROWS, harness_inputs

    tf32, ti32, r, c = harness_inputs()

    def kernel(t1, t2, rr, cc, o1, o2):
        a, b = _scan_gather([t1[:], t2[:]], rr[:], cc[:], ROWS)
        o1[:] = a
        o2[:] = b

    out = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.int32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4,
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)),
        interpret=True,
    )(tf32, ti32, r, c)
    got = K.gather((_t(tf32), _t(ti32)), _t(r), _t(c))
    assert isinstance(got, tuple) and len(got) == 2
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert np.array_equal(got[0].numpy(), np.asarray(out[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(out[1]))


def _flat_words(t):
    """The whole storage under an int32 / float32 tensor, one word each, and
    the tensor's offset in it: what the kernel's pointer arithmetic reads."""
    n = t.untyped_storage().nbytes() // 4
    return torch.as_strided(t, (n,), (1,), 0).numpy(), t.storage_offset()


def _replay_gather(tables, rows, cols, row_mod, four_where_allowed=False):
    """csrc/probes.cu's gather_kernel, written out for every thread of the
    wrapper's plan (gather_words, gather_plan; or 4 words a thread wherever
    the arrays allow): returns the outputs, the words a thread and, per
    table, how often each output word was written. With 4 words a thread,
    each 16-byte access is checked to lie inside its row at an address that
    is a multiple of 16."""
    tables, _ = K._tables(tables)
    h, w, r_mode, c_mode = K._gather_plan(tables[0], rows, cols)
    vec_ok = K.gather_vec_ok(rows, cols, r_mode, c_mode)
    n = (4 if vec_ok and w % 4 == 0 else 1) if four_where_allowed else \
        K.gather_words(r_mode, c_mode, vec_ok, w)
    tx, ty, gx, gy = K.gather_plan(h, w, n)
    assert tx * ty <= K.GATHER_THREADS and gx * ty >= h
    n_cols = 1 if tables[0].dim() == 1 else tables[0].shape[1]
    bx, by, y, x = (a.ravel() for a in np.meshgrid(np.arange(gx), np.arange(gy), np.arange(ty),
                                                   np.arange(tx), indexing="ij"))
    i, q = bx * ty + y, by * tx + x
    i, q = i[i < h], q[i < h]
    outs = [np.zeros((h, w), np.int64) for _ in tables]
    writes = [np.zeros((h, w), np.int64) for _ in tables]
    mask = row_mod - 1 if row_mod and row_mod & (row_mod - 1) == 0 else -1

    def words(t, ld, j):   # load_words: one 16-byte load (n = 4) or one word
        flat, off = _flat_words(t)
        if n == 4:
            assert ((t.data_ptr() + 4 * (i * ld + j)) % 16 == 0).all()
        return [flat[off + i * ld + j + e] for e in range(n)]

    while q.size:
        live = q < w // n
        i, q = i[live], q[live]
        j = n * q
        assert (j + n <= w).all()
        if r_mode == 1:
            r = words(rows, K.index_pitch(rows), j)
        else:
            r0 = i if r_mode == 0 else _flat_words(rows)[0][rows.storage_offset()
                                                             + i * K.index_pitch(rows)]
            r = [r0] * n
        if row_mod:
            r = [v & mask if mask >= 0 else v % row_mod for v in r]
        c = words(cols, K.index_pitch(cols), j) if c_mode == 2 else \
            [j + e if c_mode == 1 else 0 * j for e in range(n)]
        for t, out, wr in zip(tables, outs, writes):
            flat = t.reshape(-1).view(torch.int32).numpy()
            for e in range(n):
                np.add.at(wr, (i, j + e), 1)
                out[i, j + e] = flat[r[e] * n_cols + c[e]]
        q = q + gy * tx
    return outs, n, writes


def _gather_arrays(w, layout, seed=0):
    """Tables (1-D and 2-D, f32 and i32) and index arrays for a (9, w)
    output: contiguous, sliced one column in (4 bytes off 16-byte
    alignment), or rows of a wider array (a pitch of w + 7 words)."""
    rng = np.random.default_rng(seed)
    h, n_rows, n_cols = 9, 40, -(-(w + 3) // 4) * 4
    t2 = [_t(rng.random((n_rows, n_cols)).astype(np.float32)),
          _t(rng.integers(-2 ** 31, 2 ** 31, (n_rows, n_cols)).astype(np.int32)),
          _t(rng.random((n_rows, n_cols)).astype(np.float32))]
    t1 = [_t(rng.random(4096).astype(np.float32)),
          _t(rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)),
          _t(rng.random(4096).astype(np.float32))]

    def index(lo, hi, width):
        a = _t(rng.integers(lo, hi, (h, width + 7)).astype(np.int32))
        return {"contiguous": a[:, :width].contiguous(), "unaligned": a[:, 1:width + 1],
                "strided": a[:, :width]}[layout]

    return t1, t2, {"r1": index(-2000, 2000, w), "rows": index(0, n_rows, w),
                    "row": index(0, n_rows, 1), "cols": index(0, n_cols, w),
                    "cols9": index(0, n_cols, w)[:, :w]}


GATHER_CALLS = {   # (1-D table?, rows, cols, row_mod)
    "1d": (True, "rows", None, 0), "1d_mod_mask": (True, "r1", None, 2048),
    "1d_mod": (True, "r1", None, 37), "rows": (False, "rows", None, 0),
    "row_fetch": (False, "row", None, 0), "cols": (False, None, "cols", 0),
    "rows_cols": (False, "rows", "cols", 0), "row_cols": (False, "row", "cols", 0),
    "rows_cols_mod": (False, "r1", "cols", 40)}


@pytest.mark.parametrize("layout", ["contiguous", "unaligned", "strided"])
@pytest.mark.parametrize("w", [127, 128, 130])
def test_gather_plan_writes_every_word_once(w, layout):
    """The gather kernel's plan (gather_words, gather_plan, gather_vec_ok)
    and its index arithmetic (csrc/probes.cu: gather_kernel, written out for
    every thread), for every mode the wrapper launches, 1 to 3 tables in
    one call, ragged widths and sliced index arrays, at the wrapper's words
    a thread and at 4 wherever the arrays allow: every output word of every
    table is written once, with the plain version's value; 4 words a
    thread are taken exactly where the widths, pitches and addresses allow
    them, and by the wrapper only for a gather within a row by cols."""
    t1, t2, idx = _gather_arrays(w, layout)
    for name, (one_d, rows, cols, row_mod) in GATHER_CALLS.items():
        rows, cols = (idx[k] if k else None for k in (rows, cols))
        for n_tables in (1, 2, 3):
            tables = tuple((t1 if one_d else t2)[:n_tables])
            for four in (False, True):
                outs, n, writes = _replay_gather(tables, rows, cols, row_mod, four)
                want = K.gather_plain(tables, rows, cols, row_mod)
                for t, out, wr, wt in zip(tables, outs, writes, want):
                    assert (wr == 1).all(), (name, n_tables, four)
                    assert np.array_equal(out, wt.view(torch.int32).numpy()), (name, n_tables)
                # rows of the output's shape and cols are read 4 words at a time
                ow = outs[0].shape[1]
                quads_read = cols is not None or (rows is not None and rows.shape[1] > 1)
                aligned = layout == "contiguous" or (layout == "strided" and (w + 7) % 4 == 0)
                allowed = ow % 4 == 0 and (aligned or not quads_read)
                row_local = cols is not None and (rows is None or rows.shape[1] == 1)
                assert n == (4 if allowed and (four or row_local) else 1), (name, four)


def test_gather_plan_fits_the_block_to_the_output():
    # 4 words a thread only for Q2's in-row shuffle (and rows (H, 1) with
    # cols); every other site one word a thread
    assert K.gather_words(0, 2, True, 128) == 4
    assert K.gather_words(2, 2, True, 128) == 4
    assert K.gather_words(0, 2, False, 128) == 1 and K.gather_words(0, 2, True, 130) == 1
    assert all(K.gather_words(r, c, True, 128) == 1 for r, c in ((1, 0), (1, 1), (2, 1), (1, 2)))
    # (8, 128): P3a-d, Q4, the harness, 4 blocks of 256; (32, 128): W3;
    # Q1; Q2 at 4 words
    assert K.gather_plan(8, 128, 1) == (32, 8, 1, 4)
    assert K.gather_plan(32, 128, 1) == (32, 8, 4, 4)
    assert K.gather_plan(16384, 128, 1) == (32, 8, 2048, 4)
    assert K.gather_plan(3584, 128, 4) == (32, 8, 448, 1)
    assert K.gather_plan(8, 130, 1) == (32, 8, 1, 5)
    assert K.gather_plan(1000, 8, 4) == (2, 128, 8, 1)     # a warp spans 16 rows
    assert K.gather_plan(3, 1, 1) == (1, 4, 1, 1)
    # more column blocks than the grid's second axis takes: the kernel loops
    assert K.gather_plan(1, 2 ** 30, 4) == (32, 1, 1, K.MAX_GRID_Y)


def test_gather_takes_up_to_four_tables_of_one_shape():
    rng = np.random.default_rng(5)
    tabs = [_t(rng.random((6, 8)).astype(np.float32)) for _ in range(5)]
    r = _t(rng.integers(0, 6, (3, 8)).astype(np.int32))
    got = K.gather(tabs[:4], r)
    assert isinstance(got, tuple) and len(got) == 4
    assert all(torch.equal(g, K.gather(t, r)) for g, t in zip(got, tabs))
    assert isinstance(K.gather(tabs[:1], r), tuple)
    with pytest.raises(ValueError):
        K.gather(tabs, r)
    with pytest.raises(ValueError):
        K.gather((tabs[0], tabs[1][:5]), r)
    with pytest.raises(ValueError):
        K.gather((), r)


# ---------------------------------------------------------------- index_copy

def test_q3_shape_ops_match_pallas(probe):
    mod, pulled = probe("probe_pallas2")
    with _interpret():
        rec = mod.q3()
    assert rec["ok"] and all(v == "ok" for k, v in rec.items()
                             if k not in ("ok", "stage", "wall_s"))
    x = _t(np.arange(8 * 128, dtype=np.float32).reshape(8, 128))
    big = _t(np.arange(256 * 128, dtype=np.float32).reshape(256, 128))
    port = [K.index_copy(x, "transpose"), K.index_copy(x, "tile_rows", 4),
            x.reshape(1, 1024), x.reshape(1024, 1), big.reshape(128, 256),
            K.index_copy(x, "roll_cols", 3), K.index_copy(x, "broadcast_row0", 3584),
            K.index_copy(x, "iota_plus", 3584)]
    assert len(pulled) == len(port)
    for got, want in zip(port, pulled):
        assert np.array_equal(got.numpy(), want)


def test_w4_transpose_matches_pallas(probe):
    mod, pulled = probe("probe_pallas3")
    with _interpret():
        rec = mod.w4()
    assert rec["ok"] and all(rec[f"{a}x{b}"] == "ok" for a, b in ((128, 1024), (1024, 128),
                                                                    (8, 1024)))
    for (a, b), want in zip(((128, 1024), (1024, 128), (8, 1024)), pulled):
        t = np.arange(a * b, dtype=np.float32).reshape(a, b)
        assert np.array_equal(K.index_copy(_t(t), "transpose").numpy(), want)



TRANSPOSE_SHAPES = ((128, 1024), (1024, 128), (8, 1024), (8, 128), (96, 160), (1, 1),
                    (37, 1029), (33, 31), (1029, 37))


@pytest.mark.parametrize("h,w", TRANSPOSE_SHAPES)
def test_transpose_plan_moves_every_word_once(h, w):
    """The transpose kernel's grid (transpose_plan) and its index arithmetic
    (csrc/probes.cu: transpose_kernel, written out here for every thread):
    its 4-word segments read every word of the array once and write every
    word of the output once, and on the 16-byte path a segment is wholly
    inside or wholly outside."""
    vec, tr, gx, gy = K.transpose_plan(h, w, w, 0)
    assert vec == (h % 4 == 0 and w % 4 == 0) and tr == (8 if h <= 8 else 32)
    bx, by = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
    t = np.arange(64)[None, :, None]
    i = np.arange(tr * K.T_COLS // 4 // 64)[None, None, :]
    c0, r0 = bx.reshape(-1, 1, 1) * K.T_COLS, by.reshape(-1, 1, 1) * tr
    row, col = np.broadcast_arrays(r0 + t // 8 + 8 * i, c0 + 4 * (t % 8))
    k = t + 64 * i
    orow, ocol = np.broadcast_arrays(c0 + k // (tr // 4), r0 + 4 * (k % (tr // 4)))
    for (a, q), (n_a, n_q) in (((row, col), (h, w)), ((orow, ocol), (w, h))):
        live = (a < n_a) & (q < n_q)
        words = np.zeros((n_a, -(-n_q // 4) * 4), np.int64)
        np.add.at(words, (a[live], q[live]), 1)
        for e in (1, 2, 3):
            np.add.at(words, (a[live], q[live] + e), 1)
        assert (words[:, :n_q] == 1).all()
        if vec:
            assert (q[live] + 4 <= n_q).all()


def test_transpose_plan_fits_the_tile_to_the_shape_and_checks_alignment():
    # W4's shapes: 128 blocks (one wave on 132 SMs), and (8, 1024) 32 blocks
    # of 8-row tiles; 8192^2: 65536 blocks
    assert K.transpose_plan(128, 1024, 1024, 0) == (True, 32, 32, 4)
    assert K.transpose_plan(1024, 128, 128, 0) == (True, 32, 4, 32)
    assert K.transpose_plan(8, 1024, 1024, 0) == (True, 8, 32, 1)
    assert K.transpose_plan(8192, 8192, 8192, 0) == (True, 32, 256, 256)
    assert K.transpose_plan(32 * K.MAX_GRID_Y, 4, 4, 0) == (True, 32, 1, K.MAX_GRID_Y)
    with pytest.raises(ValueError):                              # past the grid's 2nd axis
        K.transpose_plan(32 * K.MAX_GRID_Y + 1, 4, 4, 0)
    assert K.transpose_plan(128, 1024, 1024, 4)[0] is False      # x not 16-byte aligned
    assert K.transpose_plan(128, 1024, 1030, 0)[0] is False      # a pitch of 1030 words
    assert K.transpose_plan(128, 1022, 1024, 0)[0] is False      # ragged columns


def test_transpose_takes_a_column_slice():
    x = _t(np.arange(37 * 1029, dtype=np.float32).reshape(37, 1029))
    sl = x[:, 3:1026]
    assert np.array_equal(K.index_copy(sl, "transpose").numpy(), sl.numpy().T)



@pytest.mark.parametrize("name", sorted(variants.PATCHES))
def test_variants_edit_the_shipped_kernels_once(name):
    """The design comparison (python -m volren_tpu_torch.probes.variants)
    builds its alternatives by editing csrc/probes.cu: each edit still
    finds its text, and only the transpose kernel, or only the short
    loop's launch, changes."""
    src = open(K.SOURCE).read()
    patched = variants.patched_source(name)
    first, last = (("int probe_affine_loop(", "int probe_gather(") if name.startswith("short")
                   else ("template <int TR, bool VEC>", "// ---- tea8"))
    head, tail = src.split(first, 1)
    assert patched != src
    assert patched.startswith(head) and patched.endswith(tail.split(last, 1)[1])


@pytest.mark.parametrize("iters,x_ptr,out_ptr,dev_count,short", [
    (1, 0, 0, False, True), (4, 256, 4096, False, True),        # P0: the short kernel
    (0, 0, 0, False, False), (5, 0, 0, False, False),           # no steps, or a loop
    (64, 0, 0, False, False), (4096, 0, 0, False, False),       # P4, P1: one chain a thread
    (1, 0, 0, True, False),                                     # P2: a device trip count
    (1, 4, 0, False, False), (1, 0, 8, False, False)])          # not 16-byte aligned
def test_affine_short_path_is_the_host_known_short_loop(iters, x_ptr, out_ptr, dev_count, short):
    assert K.affine_short(iters, x_ptr, out_ptr, dev_count) is short


# ---------------------------------------------------------------- tea8, row_scan

def _tea8_np(v0, v1):   # the oracle of probes/probe_pallas2.py::q5
    s = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(8):
            s = np.uint32(s + np.uint32(0x9E3779B9))
            v0 = v0 + ((((v1 << np.uint32(4)) + np.uint32(0xA341316C)) ^ (v1 + s)
                        ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))))
            v1 = v1 + ((((v0 << np.uint32(4)) + np.uint32(0xAD90777D)) ^ (v0 + s)
                        ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))))
    return v0, v1


def test_q5_tea8_matches_pallas_oracle(probe):
    mod, _ = probe("probe_pallas2")
    with _interpret():
        rec = mod.q5()
    assert rec["ok"] and rec["tea_bitexact"]     # Pallas == the stage's tea8_np
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (8, 128), dtype=np.uint32)
    w0, w1 = _tea8_np(a.copy(), b.copy())
    g0, g1 = K.tea8(_t(a.astype(np.int64)), _t(b.astype(np.int64)))
    assert np.array_equal(g0.numpy(), w0) and np.array_equal(g1.numpy(), w1)
    b0, b1 = K.tea8(K.u32_bits(_t(a.astype(np.int64))), K.u32_bits(_t(b.astype(np.int64))))
    assert np.array_equal(b0.numpy().view(np.uint32), w0)
    assert np.array_equal(b1.numpy().view(np.uint32), w1)


def test_cumsum_row_scan_matches_pallas(probe, monkeypatch):
    mod, _ = probe("probe_pallas5")
    records = []
    monkeypatch.setattr(mod, "emit", records.append)
    with _interpret():
        mod.bench_cumsum()
    assert records[0]["ok"]           # Pallas cumsum within rtol 1e-5 of np.cumsum
    x = np.random.default_rng(0).random((8, 128), np.float32)
    got = K.row_scan(_t(x)).numpy()
    np.testing.assert_allclose(got, np.cumsum(x, axis=1), rtol=1e-5)


# ---------------------------------------------------------------- lcg_gather_sum

def _np_lane_acc(table, mode, lanes, iters, seed):
    """Per-lane float32 accumulators by the probes' numpy LCG (lcg_np)."""
    from volren_tpu_torch.probes._common import lcg_np, seeds_np

    r_n, c_n = table.shape
    sd = seeds_np(seed, lanes, 7919)
    acc = np.zeros(lanes, np.float32)
    i = np.arange(lanes[0])[:, None]
    for _ in range(iters):
        sd = lcg_np(sd)
        if mode == "row":
            idx = i * c_n + (sd >> np.uint32(8)).astype(np.int64) % c_n
        elif mode == "rc":
            r = (sd >> np.uint32(8)).astype(np.int64) % r_n
            sd = lcg_np(sd)
            idx = r * c_n + (sd >> np.uint32(8)).astype(np.int64) % c_n
        else:
            idx = ((sd >> np.uint32(8)) & np.uint32(0x7FFFFF)).astype(np.int64) % table.size
        acc = acc + table.reshape(-1)[idx].astype(np.float32)
    return acc


@pytest.mark.parametrize("name,r,dtype", [("W1_axis1_3584_f32", 3584, np.float32),
                                          ("W6_axis1_3584_i32", 3584, np.int32)])
def test_w1_w6_row_gather_sum_matches_pallas(probe, monkeypatch, name, r, dtype):
    mod, pulled = probe("probe_pallas3")
    _no_timing(monkeypatch, mod, (0.0, 0.0, 0.0))
    with _interpret():
        rec = mod._axis1_loop_probe(r, jnp.dtype(dtype), name)()
    assert rec["ok"] and rec["relerr"] <= TOTAL_BAR
    tn = (np.arange(r * 128) % 977).reshape(r, 128).astype(dtype)
    acc = K.lcg_gather_sum(_t(tn), "row", (r, 128), 3, 42)
    assert np.array_equal(acc.numpy(), _np_lane_acc(tn, "row", (r, 128), 3, 42))
    assert _relerr(_port_total(acc), float(pulled[0][0, 0])) <= TOTAL_BAR


def test_w2_wide_row_gather_sum_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas3")
    _no_timing(monkeypatch, mod, (0.0, 0.0, 0.0))
    with _interpret():
        rec = mod.w2()
    assert rec["ok"] and rec["relerr"] <= TOTAL_BAR
    tn = (np.arange(8 * 16384) % 977).astype(np.float32).reshape(8, 16384)
    acc = K.lcg_gather_sum(_t(tn), "row", (8, 16384), 3, 42)
    assert np.array_equal(acc.numpy(), _np_lane_acc(tn, "row", (8, 16384), 3, 42))
    assert _relerr(_port_total(acc), float(pulled[0][0, 0])) <= TOTAL_BAR


def test_w7_general_gather_sum_matches_pallas(probe, monkeypatch):
    mod, pulled = probe("probe_pallas3")
    _no_timing(monkeypatch, mod, (0.0, 0.0, 0.0))
    with _interpret():
        rec = mod.w7()
    assert rec["ok"] and rec["relerr"] <= TOTAL_BAR
    tn = np.random.default_rng(2).random((3584, 128)).astype(np.float32)
    acc = K.lcg_gather_sum(_t(tn), "rc", (1, 1024), 3, 42)
    assert np.array_equal(acc.numpy(), _np_lane_acc(tn, "rc", (1, 1024), 3, 42))
    assert _relerr(_port_total(acc), float(pulled[0][0, 0])) <= TOTAL_BAR


@pytest.mark.parametrize("name,r,dtype", [("X1_maskreduce_3584_i32", 3584, np.int32),
                                          ("X2_maskreduce_74_f32", 74, np.float32)])
def test_x1_x2_maskreduce_gather_sum_matches_pallas(probe, monkeypatch, name, r, dtype):
    mod, pulled = probe("probe_pallas4")
    _no_timing(monkeypatch, mod, (0.0, 0.0, 0.0))
    with _interpret():
        rec = mod._mask_reduce_probe(name, r, dtype)()
    assert rec["ok"] and rec["relerr"] <= TOTAL_BAR
    rng = np.random.default_rng(5)
    tn = (rng.integers(0, 2 ** 20, (r, 128)).astype(np.int32) if dtype == np.int32
          else rng.random((r, 128)).astype(np.float32))
    acc = K.lcg_gather_sum(_t(tn), "rc", (8, 128), 3, 42)
    assert np.array_equal(acc.numpy(), _np_lane_acc(tn, "rc", (8, 128), 3, 42))
    assert _relerr(_port_total(acc), float(pulled[0][0, 0])) <= TOTAL_BAR


@pytest.mark.parametrize("variant,r", [("v1_maskreduce", 74), ("v2_mxu", 74),
                                       ("v3_shuffle", 1), ("v4_group_fori", 74),
                                       ("v5_group_static", 8), ("v8_group_ilp", 896)])
def test_v_gather_formulations_match_pallas(probe, monkeypatch, variant, r):
    """Every TPU formulation computes one function; the port's "flat" gather
    is held to each one's Pallas run through the stage's relerr and to the
    numpy oracle per lane. (v8 asserts R % 4 == 0, so it runs at 896; v5
    unrolls one select per row, so it runs at 8 rows to keep the trace short.)"""
    mod, _ = probe("probe_pallas5")
    records = []
    monkeypatch.setattr(mod, "emit", records.append)
    fn = mod.VARIANTS.get(variant) or getattr(mod, variant)
    with _interpret():
        mod.bench_variant(variant, fn, r, n_iters=(1, 2), n_med=1)
    assert records[0]["ok"] and records[0]["relerr"] <= TOTAL_BAR, records[0]
    tn = ((np.arange(r * 128) * 13) % 997).astype(np.float32).reshape(r, 128)
    acc = K.lcg_gather_sum(_t(tn), "flat", (8, 128), 3, 42)
    assert np.array_equal(acc.numpy(), _np_lane_acc(tn, "flat", (8, 128), 3, 42))


# the divisors lcg_gather_sum's sites and stages pass (C of "row" and "rc",
# R of "rc", R * C of "flat" at each V stage's R of 1, 74 and 896) and edges
LCG_DIVISORS = (128, 16384, 3584, 9344, 74, 896 * 128, 1 * 128, 74 * 128,
                1, 2, 3, 7, 2 ** 23 - 1, 2 ** 23, 2 ** 24 - 1)


@pytest.mark.parametrize("d", LCG_DIVISORS)
def test_div_plan_divides_every_24_bit_numerator_exactly(d):
    """The kernel's x % d (csrc/probes.cu: mod24) for every numerator it
    can see, x < 2^24, replayed with the wrapper's (m, sh): q = umulhi(x
    << 8, m) >> sh is x // d exactly when x - q d lies in [0, d)."""
    m, sh = K.div_plan(d)
    assert 0 < m < 2 ** 32 and 0 <= sh < 32
    for lo in range(0, 1 << 24, 1 << 22):
        x = torch.arange(lo, lo + (1 << 22), dtype=torch.int64)
        r = (x << 8).mul_(m).bitwise_right_shift_(32 + sh).mul_(-d).add_(x)
        low, high = torch.aminmax(r)
        assert int(low) >= 0 and int(high) < d, (d, lo)


def test_div_plan_refuses_what_the_kernel_cannot_divide_by():
    for d in (0, -3, 2 ** 31):
        with pytest.raises(ValueError):
            K.div_plan(d)


@pytest.mark.parametrize("lanes,threads", [
    (1024, 32), (1, 32), (3 * 37, 32),               # V, X1/X2, W5/W7: 32 blocks, not 4
    (131 * 256, 32), (131 * 256 + 1, 256),           # the first size that fills 132 SMs
    (8 * 16384, 256), (3584 * 128, 256)])            # W2, W1/W6
def test_lcg_threads_spreads_small_lane_blocks_over_the_sms(lanes, threads):
    assert K.lcg_threads(lanes, 132) == threads


def test_schedule_constants_are_the_kernels():
    src = open(K.SOURCE).read()
    assert f"constexpr int LCG_UNROLL = {K.LCG_UNROLL};" in src
    assert f"constexpr int BLOCK_COPY_MAX = {K.BLOCK_COPY_MAX};" in src
    assert f"constexpr int CARRY_U = {K.CARRY_U};" in src
    assert f"constexpr int CARRY_PARTS = {K.CARRY_PARTS};" in src
    assert f"constexpr int GATHER_TABLES = {K.GATHER_TABLES};" in src


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_124row_gather_rounds_kernelILi3EEEvPKiPKjiiiiPj", "row_gather_rounds<3>"),
    ("_ZN12_GLOBAL__N_121lcg_gather_sum_kernelILb1ELi2EEEvPKjiNS_7DivisorES3_jjiiiPf",
     "lcg_gather_sum<1,2>"),
    ("_ZN12_GLOBAL__N_111tea8_kernelEPKjS1_PjS2_i", "tea8"),
    ("_ZN12_GLOBAL__N_113gather_kernelILi2ELi1ELb0ELb1EEEvNS_10GatherArgsE", "gather<2,1,0,1>")])
def test_kernel_names_carry_every_template_argument(mangled, name):
    assert K._kernel_name(mangled) == name


# ---------------------------------------------------------------- carry_loop

def test_x3_carry30_matches_pallas(probe, monkeypatch):
    """The stage's kernel total (seed 1, 64 steps) against the port's at
    1e-6, and the per-lane values bitwise against the kernel body run by
    XLA on this CPU (the same ops, outside Pallas)."""
    mod, pulled = probe("probe_pallas4")
    _no_timing(monkeypatch, mod, (0.0, 0.0, 0.0))
    with _interpret():
        assert mod.x3()["ok"]
    tn = np.random.default_rng(6).random((74, 128)).astype(np.float32)
    acc = K.carry30(_t(tn), 1, 64)
    assert _relerr(_port_total(acc), float(pulled[0][0, 0])) <= TOTAL_BAR

    @jax.jit
    def body_lanes(t):
        def body(carry):
            it, sd, *arrs = carry
            sd = mod.lcg(sd)
            r = (sd >> jnp.uint32(8)).astype(jnp.int32) % 74
            sd = mod.lcg(sd)
            cc = (sd >> jnp.uint32(8)).astype(jnp.int32) % 128
            prev = mod.mask_reduce_gather(t, r, cc, 74)
            new = []
            for a in arrs:
                a = a * 0.9999 + prev * 1e-4
                prev = a
                new.append(a)
            return (it + 1, sd, *new)

        sd0 = jnp.uint32(1) + lax.broadcasted_iota(jnp.uint32, (8, 128), 1)
        arrs0 = [jnp.full((8, 128), 0.01 * k, jnp.float32) for k in range(30)]
        out = lax.while_loop(lambda c: c[0] < 64, body, (jnp.int32(0), sd0, *arrs0))
        total = out[2]
        for a in out[3:]:
            total = total + a
        return total

    assert np.array_equal(acc.numpy(), np.asarray(body_lanes(jnp.asarray(tn))))


def _mod24(x, d):
    """csrc/probes.cu's mod24(x, Divisor) with the wrapper's div_plan."""
    m, sh = K.div_plan(d)
    return x - d * (((x << 8) & K.MASK) * m >> (32 + sh))


def _replay_carry30(table, seed, iters, lanes, u, parts):
    """csrc/probes.cu's carry30_kernel for every lane at once, in the
    kernel's order: each lane's 30 values split over ``parts`` threads (the
    last holding fewer); iters // u blocks of u steps, then the iters % u
    steps past them as blocks of one step, each run as a systolic pipeline,
    part q on block b - q in round b, each step's prev handed from part
    q - 1 to part q after the round, part 0's words loaded a round ahead,
    each word's row and column by mod24; then the values summed in order."""
    rows_t, cols_t = table.shape
    flat = table.reshape(-1)
    keep, mix = torch.tensor(K.C_KEEP), torch.tensor(K.C_MIX)
    s = K.lane_seeds(seed, lanes, 0, "cpu")
    m_part = -(-K.N_CARRY // parts)
    a = [torch.full(lanes, float(np.float32(0.01 * m))) for m in range(K.N_CARRY)]

    def word():
        nonlocal s
        s = K.lcg32(s)
        r = _mod24(s >> 8, rows_t)
        s = K.lcg32(s)
        return flat[r * cols_t + _mod24(s >> 8, cols_t)]

    def pipeline(blocks, u):
        w = [word() for _ in range(u)] if blocks > 0 else None
        from_prev = [None] * parts
        for b in range(blocks + parts - 1):
            p = [list(w) if q == 0 and w else from_prev[q] for q in range(parts)]
            if b + 1 < blocks:
                w = [word() for _ in range(u)]
            for q in range(parts):
                if 0 <= b - q < blocks:
                    for k in range(u):
                        for m in range(q * m_part, min((q + 1) * m_part, K.N_CARRY)):
                            a[m] = K.fma32(a[m], keep, p[q][k] * mix)
                            p[q][k] = a[m]
            from_prev = [None] + p[:-1]

    pipeline(iters // u, u)
    pipeline(iters % u, 1)
    acc = a[0]
    for v in a[1:]:
        acc = acc + v
    return acc


@pytest.mark.parametrize("u,parts", [(1, 4), (2, 2), (3, 16), (K.CARRY_U, K.CARRY_PARTS)])
def test_carry30_pipeline_is_the_plain_version(u, parts):
    """The kernel's schedule (a lane's values over ``parts`` threads, a
    systolic pipeline over blocks of u steps and then over the steps past
    them, the words loaded a round ahead, exact division) on a table with
    no power-of-two side: bitwise carry30_plain at step counts around the
    block and the pipeline's depth."""
    t = _t(np.random.default_rng(8).random((37, 100)).astype(np.float32))
    for iters in sorted({0, 1, u - 1, u, u + 1, 2 * u + 1, 3 * u, 33}):
        got = _replay_carry30(t, 11, iters, (3, 37), u, parts)
        assert torch.equal(got, K.carry30_plain(t, 11, iters, (3, 37))), iters


@pytest.mark.parametrize("d", [74, 128, 37, 100])
def test_carry30_plans_divide_exactly_and_spread_the_lanes(d):
    """carry30's launch: X3's (74, 128) table and the card tests' (37, 100)
    divide every 24-bit numerator exactly (mod24 with div_plan), and X3's
    1,024 lanes, 8,192 threads, run in 256 one-warp blocks."""
    x = torch.arange(1 << 24, dtype=torch.int64)
    r = _mod24(x, d)
    assert torch.equal(r, x % d)
    assert K.CARRY_PARTS == 8 and 32 % K.CARRY_PARTS == 0
    assert K.lcg_threads(8 * 128 * K.CARRY_PARTS, 132) == 32
    assert K.lcg_threads(3 * 37 * K.CARRY_PARTS, 132) == 32


def test_q6_march_matches_the_kernel_body():
    """The Q6 stage never ran its kernel on any backend: its body deletes
    `iota_n`, which makes the name local and unbound (see the stage's own
    line in probes/results/pallas2.jsonl). The port is held bitwise to the
    kernel body as written, minus that line, run by XLA on this CPU."""
    R = 4096
    t = np.random.default_rng(3).random((R, 128), np.float32)
    x = np.random.default_rng(4).random((8, 128)).astype(np.float32)
    s = np.random.default_rng(5).integers(0, 2 ** 32, (8, 128), dtype=np.uint32)

    @jax.jit
    def q6_body(tt, pos0, r0):
        def body(k, carry):
            pos, vel, rstate = carry
            rstate = rstate * jnp.uint32(1664525) + jnp.uint32(1013904223)
            jitter = (rstate >> jnp.uint32(9)).astype(jnp.float32) * (1.0 / 8388608.0)
            cell = jnp.clip((pos * 16.0).astype(jnp.int32), 0, R - 1)
            idx = jnp.broadcast_to(cell[0:1, :], (R, 128))
            maj = jnp.take_along_axis(tt, idx, axis=0)[0:8, :]
            step = jnp.where(maj > 0.5, 0.01, 0.05) * (0.5 + jitter[:8])
            pos = pos + vel * step
            vel = vel * 0.999
            return pos, vel, rstate

        vel0 = jnp.full((8, 128), 0.01, jnp.float32)
        pos, vel, _ = lax.fori_loop(0, 64, body, (pos0, vel0, r0))
        return pos + vel

    want = np.asarray(q6_body(jnp.asarray(t), jnp.asarray(x), jnp.asarray(s)))
    got = K.march(_t(t), _t(x), _t(s.astype(np.int64)), 64).numpy()
    assert np.array_equal(got, want)


def test_q6_stage_fails_as_recorded_on_the_tpu(probe):
    mod, _ = probe("probe_pallas2")
    with _interpret():
        rec = mod.q6()
    assert not rec["ok"] and "UnboundLocalError" in rec["error"] and "iota_n" in rec["error"]


# ---------------------------------------------------------------- row_gather_rounds

@pytest.fixture(scope="module")
def dma_table():
    rng = np.random.default_rng(7)
    tab = rng.integers(0, 2 ** 31 - 1, (65536, 128), dtype=np.int32)
    idx = rng.integers(0, 65536, (1, 128), dtype=np.int32)
    return tab, idx


def _port_rounds(dma_table, mode, rounds, n=128, use_mask=False):
    tab, idx = dma_table
    return K.row_gather_rounds(_t(idx), _t(tab), mode, rounds, n, use_mask).numpy()


@pytest.mark.parametrize("scalarize,n_dma", [("smem", 128), ("reduce", 32)])
def test_dmagather_rounds_match_pallas(dma_table, scalarize, n_dma):
    mod = importlib.import_module("probes.probe_dmagather")
    tab, idx = dma_table
    with _interpret():
        want = np.asarray(mod.make_fn(n_dma, scalarize, 3)(idx, tab))[0]
    assert np.array_equal(_port_rounds(dma_table, "staged", 3, n_dma), want)


@pytest.mark.parametrize("variant,mode,n,use_mask", [("full", "staged", 128, False),
                                                     ("nomod", "staged", 128, True),
                                                     ("dma8", "staged", 8, False)])
def test_dmagather2_rounds_match_pallas(dma_table, monkeypatch, variant, mode, n, use_mask):
    mod = importlib.import_module("probes.probe_dmagather2")
    monkeypatch.setattr(mod, "ROUNDS", 3)
    tab, idx = dma_table
    with _interpret():
        want = np.asarray(mod.make_fn(variant)(idx, tab))[0]
    got = _port_rounds(dma_table, mode, 3, n, use_mask)
    # dma8 lanes 8.. pick from rows nothing wrote: only lanes < 8 are defined
    assert np.array_equal(got[:n], want[:n])


@pytest.mark.parametrize("variant,mode", [("loop", "ids"), ("word4", "direct")])
def test_dmagather3_rounds_match_pallas(dma_table, monkeypatch, variant, mode):
    mod = importlib.import_module("probes.probe_dmagather3")
    monkeypatch.setattr(mod, "ROUNDS", 3)
    tab, idx = dma_table
    with _interpret():
        want = np.asarray(mod.make_fn(variant)(idx, tab))[0]
    assert np.array_equal(_port_rounds(dma_table, mode, 3, use_mask=True), want)


@pytest.mark.parametrize("variant,mode", [("loop", "ids"), ("dma128", "stage"),
                                          ("full", "staged")])
def test_dmagather4_rounds_match_pallas(dma_table, variant, mode):
    mod = importlib.import_module("probes.probe_dmagather4")
    tab, idx = dma_table
    with _interpret():
        want = np.asarray(mod.make_fn(variant, 2)(idx, tab))[0]
    assert np.array_equal(_port_rounds(dma_table, mode, 2, use_mask=True), want)


def test_stale_rounds_pick_the_zero_filled_buffer(dma_table):
    """diagonly / stageonly / load / gather / reduce / hoist / diag read a
    landing buffer that nothing wrote (undefined in Pallas); the port's is
    zero-filled, and its oracle is zeros."""
    tab, idx = dma_table
    assert not _port_rounds(dma_table, "stale", 5, use_mask=True).any()
    want = port_dmagather.ref_checksum(idx, tab, 128, 5, True, "stale")
    assert not want.any()


def test_staged_rounds_refuse_a_table_their_copies_cannot_take(dma_table):
    """stage and staged copy each 512-byte row in 16-byte pieces from
    16-byte aligned addresses: the wrapper refuses an offset view (4 bytes
    off) and a row pitch of 1024 bytes on every device, and never falls
    back; the modes that copy nothing still take them."""
    tab, idx = dma_table
    flat = _t(tab).reshape(-1)
    offset = torch.cat([flat[:4], flat])[1:flat.numel() + 1].view(-1, 128)
    assert offset.data_ptr() % 16 == 4 and offset.is_contiguous()
    wide = torch.zeros(1024, 256, dtype=torch.int32)[:, :128]
    for bad in (offset, wide):
        for mode in ("stage", "staged"):
            with pytest.raises(ValueError):
                K.row_gather_rounds(_t(idx), bad, mode, 2, 128, bad is offset)
        with pytest.raises(ValueError):
            K.check_staged_table(bad)
    want = K.row_gather_rounds(_t(idx), _t(tab), "direct", 2, 128, True)
    assert torch.equal(K.row_gather_rounds(_t(idx), offset, "direct", 2, 128, True),
                       K.row_gather_rounds_plain(_t(idx), offset, "direct", 2, 128, True))
    assert want.shape == (128,)
    K.check_staged_table(_t(tab))


@pytest.mark.parametrize("mode,rounds,words", [
    ("staged", 7, 7 * 128), ("direct", 7, 7 * 128),       # the words the checksum reads
    ("staged", 70000, 256 * 128), ("direct", 70000, 256 * 128),   # at most the table
    ("stage", 7, 0), ("ids", 7, 0), ("stale", 7, 0)])     # no table word
def test_row_sites_bound_counts_the_words_the_checksum_reads(mode, rounds, words):
    """A row site's bound counts the table words its checksum reads, at
    most the table, and the base ids in and the sums out: the rows the
    staged modes copy are not words the function needs."""
    from volren_tpu_torch.probes._common import Context
    from volren_tpu_torch.probes.sites import _rounds

    ctx = Context(torch.device("cpu"), rows=256)
    assert _rounds(ctx, mode, True, rounds).n_bytes == 4 * words + 2 * 128 * 4


# ---------------------------------------------------------------- wrappers, entry point

def test_wrappers_run_the_plain_version_on_cpu_and_raise_elsewhere():
    x = torch.ones(8, 128)
    before = {name: w.launches for name, w in K.WRAPPERS.items()}
    K.affine_loop(x, 2, 1.0, 1.0)
    K.gather(x, cols=torch.zeros(8, 128, dtype=torch.int32))
    K.row_scan(x)
    assert {name: w.launches for name, w in K.WRAPPERS.items()} == before
    meta = torch.empty(8, 128, device="meta")
    with pytest.raises(ValueError):
        K.affine_loop(meta, 2)
    with pytest.raises(ValueError):
        K.gather(meta, cols=torch.zeros(8, 128, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.index_copy(meta, "transpose")
    with pytest.raises(ValueError):
        K.row_scan(meta)
    with pytest.raises(ValueError):
        K.lcg_gather_sum(meta, "rc", (8, 128), 1, 0)
    with pytest.raises(ValueError):
        K.row_gather_rounds(torch.zeros(128, dtype=torch.int32), meta.to(torch.int32), "ids", 1)
    with pytest.raises(ValueError):
        K.lcg_gather_sum(x, "bogus", (8, 128), 1, 0)


def test_entry_point_runs_on_cpu_and_fails_loudly(monkeypatch, tmp_path, capsys):
    out = tmp_path / "probes.jsonl"
    only = "P0_trivial,Q4_general_gather,dmagather3:word4,harness_exact"
    assert port_probes.main(["--device", "cpu", "--only", only, "--out", str(out)]) == 0
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    stages = [r.get("stage") or r.get("tag") for r in lines if "mode" not in r]
    assert stages == ["P0_trivial", "Q4_general_gather", "word4", "harness_exact"]
    assert all(r["ok"] and r["device"] == "cpu" for r in lines if "mode" not in r)

    def broken(ctx):
        raise AssertionError("wrong answer")
    monkeypatch.setattr(port_probes.probe_pallas, "STAGES", (("P0_trivial", broken),))
    assert port_probes.main(["--device", "cpu", "--only", "P0_trivial"]) == 1
    assert '"ok": false' in capsys.readouterr().out
    with pytest.raises(ValueError):
        port_probes.select("no_such_stage")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_probes.main(["--only", "P0_trivial"])


def test_sites_cover_every_pallas_call_site_and_stage():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert len(SITES) == 28 and len({s.name for s in SITES}) == 28
    for site in SITES:
        path, line = site.replaces.rsplit(":", 1)
        with open(os.path.join(repo, path)) as f:
            assert "pl.pallas_call(" in f.readlines()[int(line) - 1], site.replaces
        assert site.family in K.WRAPPERS
    covered = sorted(n for s in SITES for _m, n, _f in port_probes.select(s.stages))
    assert covered == sorted(n for _m, n, _f in port_probes.select(None))
