"""The probe kernels: each wrapper launches its CUDA kernel
(``volren_tpu_torch/csrc/probes.cu``) on CUDA tensors and runs its plain
torch version on CPU tensors; any other device raises. Each wrapper counts
its kernel launches in ``<wrapper>.launches``.

They are the H100 counterparts of the Pallas probes' kernels
(``probes/probe_*.py``) and of the ``_scan_gather`` test harness; the
probe stages that drive them are ``volren_tpu_torch.probes``. Eight
families:

- ``affine_loop``: ``iters`` steps of ``v = v * a + b`` with one rounding
  (as XLA computes the probes' ``x * 1.0000001 + 1e-6``), the trip count
  from the host or read on the device;
- ``gather``: ``T[r, c]`` with r and c each an index array, the output's
  row / column number, or (a 1-D table) ``T[r % mod]``, for up to
  ``GATHER_TABLES`` tables in one launch (one word a thread, or 4 in
  16-byte accesses: ``gather_words``, ``gather_plan``);
- ``lcg_gather_sum``: per lane, ``iters`` LCG-indexed table words summed
  (exact multiply-high division, ``LCG_UNROLL`` loads in flight a lane);
- ``carry30`` and ``march`` (the ``carry_loop`` family): X3's 30 carried
  values (split over ``CARRY_PARTS`` threads, a systolic pipeline over
  blocks of ``CARRY_U`` steps) and Q6's march-like body;
- ``row_gather_rounds``: the dmagather checksum, rows staged in shared
  memory (16-byte cp.async, each warp copying its own lanes' rows, or the
  whole block a few rows) or words loaded directly;
- ``index_copy``: transpose, row tiling, column roll, row broadcast, iota;
- ``tea8``: 8 TEA rounds; ``row_scan``: cumsum along rows.

u32 values travel as int64 tensors holding [0, 2^32), as in ``ops/rng.py``;
``march`` and ``tea8`` also take int32 tensors holding the bits (``u32_bits``).
"""

from __future__ import annotations

import ctypes
import os
import re
import threading

import numpy as np
import torch

from ..rng import MASK
from . import build as _build

SOURCE = os.path.join(_build.CSRC, "probes.cu")
f32, i32, i64 = torch.float32, torch.int32, torch.int64
LANES = 128                 # row_gather_rounds: one block of 128 lanes, 512-byte rows
BLOCK_COPY_MAX = 64         # csrc/probes.cu: up to this n the whole block copies the rows
ROUND_STEP = 7919           # the dmagather index stride per round
ROW_GATHER_MODES = {"ids": 0, "direct": 1, "stage": 2, "staged": 3, "stale": 4}
LCG_MODES = {"row": 0, "rc": 1, "flat": 2}
INDEX_COPY_OPS = {"transpose": 0, "tile_rows": 1, "roll_cols": 2, "broadcast_row0": 3,
                  "iota_plus": 4}
# the float32 constants the probes' JAX code rounds its Python floats to
C_KEEP, C_MIX = np.float32(0.9999), np.float32(1e-4)                 # X3
VEL0, S_NEAR, S_FAR, DECAY = (np.float32(v) for v in (0.01, 0.01, 0.05, 0.999))  # Q6
N_CARRY = 30
CARRY_U = 16          # csrc/probes.cu: carry30's steps a block
CARRY_PARTS = 8       # csrc/probes.cu: the threads a carry30 lane's values are split over
GATHER_TABLES = 4     # csrc/probes.cu: the tables one gather launch takes
GATHER_THREADS = 256  # a gather block's threads, at most
MAX_GRID_Y = 65535    # CUDA's limit on a grid's second axis

_LIB = None
_LIB_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build(flags: list[str] = _build.NVCC_FLAGS) -> str:
    """Compile csrc/probes.cu into ``build/libvolren_probes_<hash>.so``."""
    return _build.build(SOURCE, "volren_probes", flags)


def _kernel_name(mangled: str) -> str:
    """The kernel's name without "_kernel", with its template arguments:
    "_ZN<n><anonymous namespace><n>row_gather_rounds_kernelILi3EE..." ->
    "row_gather_rounds<3>", "...lcg_gather_sum_kernelILb1ELi2EE..." ->
    "lcg_gather_sum<1,2>"."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    n = re.match(r"\d+", rest)
    if not n:
        return mangled
    name = rest[n.end():n.end() + int(n.group())].removesuffix("_kernel")
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest[n.end() + int(n.group()):])
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"


def resource_usage(lib_path: str) -> list[str]:
    """ptxas's register, stack and spill lines, one per kernel."""
    return _build.resource_usage(lib_path, _kernel_name)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            p, n, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
            ll = ctypes.c_longlong
            _LIB = _build.load(build(), {
                "probe_affine_loop": [p, p, n, n, p, f, f, n, p],
                "probe_gather": [p, p, n, n, p, ll, n, n, p, ll, n, n, n, n, n, n, n, n, p],
                "probe_lcg_gather_sum": [p, n, n, n, u, u, u, u, u, u, u, u, n, n, n, n,
                                         p, p],
                "probe_carry30": [p, n, u, u, u, u, u, u, u, n, n, n, f, f, n, p, p],
                "probe_march": [p, n, n, p, p, n, f, f, f, f, p, p],
                "probe_row_gather_rounds": [n, p, p, n, n, n, n, p, p],
                "probe_index_copy": [p, n, n, n, n, p, n, n, p],
                "probe_transpose": [p, n, n, ll, n, n, n, n, p, p],
                "probe_tea8": [p, p, p, p, n, p],
                "probe_row_scan": [p, p, n, n, p],
            })
    return _LIB


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(t: torch.Tensor, name: str, dtypes, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _launch(fn: str, *args, device):
    err = getattr(_lib(), fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def u32_bits(t: torch.Tensor) -> torch.Tensor:
    """u32 values (int64 in [0, 2^32), or int32 holding the bits) -> an
    int32 tensor with the same 32 bits."""
    if t.dtype == i32:
        return t.contiguous()
    t = t.to(i64) & MASK
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(i32).contiguous()


def _u32_values(t: torch.Tensor) -> torch.Tensor:
    """u32 values as int64 in [0, 2^32), from int64 values or int32 bits."""
    return t.to(i64) & MASK


# ---------------------------------------------------------------------------
# plain helpers
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(v)), dtype=f32, device=device)


def fma32(x: torch.Tensor, y, z: torch.Tensor) -> torch.Tensor:
    """x * y + z for float32 tensors with ONE rounding (an IEEE fma), as the
    kernels' __fmaf_rn and XLA's fused multiply-add compute it. The product
    is exact in float64; the float64 sum s and its error e come from TwoSum;
    the float32 rounding of s is the fma's unless s is exactly halfway
    between two float32 values and e != 0, and then s moves one float64 ulp
    towards the exact sum before it is rounded."""
    y = torch.as_tensor(y, dtype=f32, device=x.device)
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    t = s - p
    e = (p - (s - t)) + (zd - t)
    r = s.float()
    rd = r.double()
    inf = torch.tensor(float("inf"), dtype=f32, device=x.device)
    toward_s = torch.where(s > rd, inf, -inf)
    neighbour = torch.nextafter(r, toward_s).double()
    tie = (s != rd) & (s == (rd + neighbour) * 0.5)
    nudged = torch.nextafter(s, torch.where(e > 0, inf.double(), -inf.double())).float()
    return torch.where(tie & (e != 0), nudged, r)


def lcg32(s: torch.Tensor) -> torch.Tensor:
    """One LCG step, s * 1664525 + 1013904223 mod 2^32, on int64 u32."""
    return (s * 1664525 + 1013904223) & MASK


def lane_seeds(seed: int, lanes, row_mul: int, device) -> torch.Tensor:
    """(seed + i * row_mul + j) mod 2^32 for lane (i, j) of an (H, W) block."""
    h, w = lanes
    i = torch.arange(h, dtype=i64, device=device)[:, None]
    j = torch.arange(w, dtype=i64, device=device)[None, :]
    return (seed + i * row_mul + j) & MASK


# ---------------------------------------------------------------------------
# affine_loop
# ---------------------------------------------------------------------------

def affine_loop_plain(x, iters, a, b, iters_dev=None):
    n = int(iters_dev.reshape(-1)[0]) if iters_dev is not None else iters
    at = _f32(a, x.device)
    v = x
    for _ in range(n):
        v = fma32(v, at, _f32(b, x.device).expand_as(v))
    return v.clone()


SHORT_STEPS = 4   # csrc/probes.cu: the short kernel's longest loop


def affine_short(iters: int, x_ptr: int, out_ptr: int, dev_count: bool) -> bool:
    """Whether a call takes the short kernel (4 elements a thread, 16-byte
    accesses, the step count a template argument): a trip count from the
    host of 1 to SHORT_STEPS, x and out 16-byte aligned. Every other call
    runs the loop kernel, one element and one dependent chain a thread,
    which P1, P2 and P4 time."""
    return (not dev_count and 1 <= iters <= SHORT_STEPS and x_ptr % 16 == 0
            and out_ptr % 16 == 0)


def affine_loop(x: torch.Tensor, iters: int = 0, a=1.0, b=0.0,
                iters_dev: torch.Tensor | None = None) -> torch.Tensor:
    """``iters`` (or ``iters_dev[0]``, read inside the kernel) steps of
    ``v = fma(v, a, b)`` on every element of the float32 tensor ``x``."""
    if not _on_card(x):
        return affine_loop_plain(x, iters, a, b, iters_dev)
    _check(x, "x", (f32,))
    if iters_dev is not None:
        _check(iters_dev, "iters_dev", (i32,), (1,))
    out = torch.empty_like(x)
    short = affine_short(int(iters), x.data_ptr(), out.data_ptr(), iters_dev is not None)
    _launch("probe_affine_loop", x.data_ptr(), out.data_ptr(), x.numel(), int(iters),
            iters_dev.data_ptr() if iters_dev is not None else None,
            float(np.float32(a)), float(np.float32(b)), int(short), device=x.device)
    affine_loop.launches += 1
    return out


affine_loop.launches = 0


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def _gather_plan(table, rows, cols):
    """(H, W, r_mode, c_mode) of a gather; see ``gather``."""
    if table.dim() == 1:
        if rows is None or rows.dim() != 2 or cols is not None:
            raise ValueError("a 1-D table takes a 2-D rows index and no cols")
        return rows.shape[0], rows.shape[1], 1, 0
    if table.dim() != 2:
        raise ValueError("the table must be 1-D or 2-D")
    if cols is not None:
        h, w = cols.shape
        c_mode = 2
    elif rows is not None and rows.dim() == 2 and rows.shape[1] != 1:
        h, w = rows.shape
        c_mode = 1
    elif rows is not None:
        h, w = rows.shape[0], table.shape[1]
        c_mode = 1
    else:
        raise ValueError("a gather needs rows or cols")
    if rows is None:
        r_mode = 0
    elif tuple(rows.shape) == (h, w):
        r_mode = 1
    elif tuple(rows.shape) == (h, 1):
        r_mode = 2
    else:
        raise ValueError(f"rows has shape {tuple(rows.shape)}, output is {(h, w)}")
    return h, w, r_mode, c_mode


def _tables(table) -> tuple[tuple[torch.Tensor, ...], bool]:
    """(the tables, whether one tensor was given) of a gather's first
    argument: a tensor, or a tuple or list of up to GATHER_TABLES tensors of
    one shape on one device."""
    if isinstance(table, torch.Tensor):
        return (table,), True
    tables = tuple(table)
    if not 1 <= len(tables) <= GATHER_TABLES:
        raise ValueError(f"a gather takes 1 to {GATHER_TABLES} tables, got {len(tables)}")
    if any(t.shape != tables[0].shape or t.device != tables[0].device for t in tables):
        raise ValueError("the tables of one gather must have one shape and one device")
    return tables, False


def gather_plain(table, rows=None, cols=None, row_mod=0):
    tables, single = _tables(table)
    h, w, r_mode, c_mode = _gather_plan(tables[0], rows, cols)
    dev = tables[0].device
    if r_mode == 0:
        r = torch.arange(h, dtype=i64, device=dev)[:, None].expand(h, w)
    else:
        r = rows.to(i64).expand(h, w)
    if row_mod:
        r = r % row_mod
    if tables[0].dim() == 1:
        outs = tuple(t[r] for t in tables)
    else:
        c = (cols.to(i64) if c_mode == 2
             else torch.arange(w, dtype=i64, device=dev)[None, :].expand(h, w))
        outs = tuple(t[r, c] for t in tables)
    return outs[0] if single else outs


def gather_words(r_mode: int, c_mode: int, vec_ok: bool, w: int) -> int:
    """Words a thread of the gather kernel: 4, in 16-byte accesses, where a
    thread's words lie in one table row picked through a column index (r
    from the output's row or from rows of shape (H, 1), c from cols: Q2's
    in-row shuffle, 15% faster than one word a thread) and the arrays allow
    it (``vec_ok``, w % 4 == 0); else one word a thread, which measured as
    fast or faster where each word's row comes from an index array (P3a-c,
    Q1, Q4, W3, the harness) and for P3d's row fetch."""
    return 4 if vec_ok and w % 4 == 0 and c_mode == 2 and r_mode != 1 else 1


def gather_plan(h: int, w: int, words: int):
    """(tx, ty, gx, gy) of the gather kernel for an (h, w) output at
    ``words`` words a thread: blocks of tx x ty threads, tx a power of two
    that covers a row's threads, at most a warp, ty rows, up to
    GATHER_THREADS threads (at most h rounded up to a power of two); gx row
    bands by gy column blocks (at most MAX_GRID_Y: the kernel loops over the
    rest)."""
    per_row = w // words
    tx = min(32, 1 << max(per_row - 1, 0).bit_length())
    ty = min(GATHER_THREADS // tx, 1 << max(h - 1, 0).bit_length())
    return tx, ty, -(-h // ty), min(-(-per_row // tx), MAX_GRID_Y)


def index_pitch(t: torch.Tensor | None) -> int:
    """The row pitch (words) of a 2-D index array whose columns are
    adjacent (0 for no array); raises for another layout."""
    if t is None:
        return 0
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError("an index array must be 2-D with adjacent columns")
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def gather_vec_ok(rows, cols, r_mode: int, c_mode: int) -> bool:
    """Whether a gather's index arrays allow 4 words a thread in 16-byte
    accesses (beside w % 4 == 0): each array read 4 words at a time (rows of
    the output's shape, cols) 16-byte aligned with a pitch of a multiple of
    4 words."""
    return all(t.data_ptr() % 16 == 0 and index_pitch(t) % 4 == 0
               for t, quads in ((rows, r_mode == 1), (cols, c_mode == 2)) if quads)


def gather(table, rows: torch.Tensor | None = None, cols: torch.Tensor | None = None,
           row_mod: int = 0):
    """out[i, j] = table[r, c] for a 2-D float32 or int32 table: r is
    ``rows[i, j]``, ``rows[i, 0]`` (rows of shape (H, 1)) or i (rows None);
    c is ``cols[i, j]`` or j (cols None). A 1-D table gives
    ``table[rows % row_mod]`` (``row_mod`` 0: no modulo). ``table`` may be a
    tuple or list of up to GATHER_TABLES tables of one shape, float32 or
    int32 in any mix: one launch gathers them all at the same (r, c) and a
    tuple of outputs comes back. The index arrays are int32 with adjacent
    columns; their rows may lie any distance apart (a column slice). The
    indices must lie inside the table: the kernel does not check them."""
    tables, single = _tables(table)
    if not _on_card(tables[0]):
        return gather_plain(table, rows, cols, row_mod)
    for t in tables:
        _check(t, "table", (f32, i32))
    h, w, r_mode, c_mode = _gather_plan(tables[0], rows, cols)
    for t, name in ((rows, "rows"), (cols, "cols")):
        if t is not None and (not t.is_cuda or t.dtype != i32):
            raise ValueError(f"{name} must be an int32 CUDA tensor")
    r_ld, c_ld = index_pitch(rows), index_pitch(cols)
    if h * w >= 2 ** 31:
        raise ValueError("the kernel indexes the output with 32-bit integers")
    if not 0 <= row_mod < 2 ** 31:
        raise ValueError(f"row_mod must lie in [0, 2^31), got {row_mod}")
    outs = tuple(torch.empty(h, w, dtype=t.dtype, device=t.device) for t in tables)
    n_cols = 1 if tables[0].dim() == 1 else tables[0].shape[1]
    if h * w == 0:
        return outs[0] if single else outs
    words = gather_words(r_mode, c_mode, gather_vec_ok(rows, cols, r_mode, c_mode), w)
    tx, ty, gx, gy = gather_plan(h, w, words)
    ptrs = ctypes.c_void_p * GATHER_TABLES
    _launch("probe_gather", ptrs(*(t.data_ptr() for t in tables)),
            ptrs(*(o.data_ptr() for o in outs)), len(tables), n_cols,
            rows.data_ptr() if rows is not None else None, r_ld, r_mode, int(row_mod),
            cols.data_ptr() if cols is not None else None, c_ld, c_mode, h, w, words, tx, ty,
            gx, gy, device=tables[0].device)
    gather.launches += 1
    return outs[0] if single else outs


gather.launches = 0


# ---------------------------------------------------------------------------
# lcg_gather_sum
# ---------------------------------------------------------------------------

def lcg_gather_sum_plain(table, mode, lanes, iters, seed, row_mul):
    rows_t, cols_t = table.shape
    dev = table.device
    flat = table.reshape(-1)
    s = lane_seeds(seed, lanes, row_mul, dev)
    i = torch.arange(lanes[0], dtype=i64, device=dev)[:, None]
    acc = torch.zeros(lanes, dtype=f32, device=dev)
    for _ in range(iters):
        s = lcg32(s)
        if mode == "row":
            idx = i * cols_t + (s >> 8) % cols_t
        elif mode == "rc":
            r = (s >> 8) % rows_t
            s = lcg32(s)
            idx = r * cols_t + (s >> 8) % cols_t
        else:
            idx = ((s >> 8) & 0x7FFFFF) % (rows_t * cols_t)
        acc = acc + flat[idx].to(f32)
    return acc


LCG_UNROLL = 16           # csrc/probes.cu: the loads a lane of lcg_gather_sum keeps in flight


def div_plan(d: int) -> tuple[int, int]:
    """(m, sh) of the kernel's exact division by ``d`` >= 1 for numerators
    0 <= x < 2^24: x // d == ((x << 8) * m >> 32) >> sh, the high word of a
    32-bit product (__umulhi) shifted. With sh = ceil(log2 d) and m =
    ceil(2^(24 + sh) / d) = (2^(24 + sh) + e) / d, 0 <= e < d <= 2^sh:
    x m / 2^(24 + sh) = x // d + (x % d + x e / 2^(24 + sh)) / d, and
    x e / 2^(24 + sh) < 1, so the fraction stays below 1. m <= 2^25."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"a divisor must lie in [1, 2^31), got {d}")
    sh = (d - 1).bit_length()
    return -(-(1 << (24 + sh)) // d), sh


def lcg_threads(n_lanes: int, n_sms: int) -> int:
    """lcg_gather_sum's block size: 256 threads where that still gives each
    of the card's ``n_sms`` SMs a block, else one warp (1,024 lanes: 32
    blocks on 32 SMs rather than 4 blocks on 4)."""
    return 256 if -(-n_lanes // 256) >= n_sms else 32


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lcg_gather_sum(table: torch.Tensor, mode: str, lanes, iters: int, seed: int,
                   row_mul: int = 7919) -> torch.Tensor:
    """Per-lane sums over ``iters`` LCG steps of words of the (R, C) float32
    or int32 ``table`` (as float32), for an (H, W) lane block seeded
    ``seed + i * row_mul + j``. ``mode``: "row" T[i, (s >> 8) % C]; "rc"
    T[(s >> 8) % R, (s' >> 8) % C] with s' one LCG step on; "flat"
    T.flat[((s >> 8) & 0x7FFFFF) % (R * C)]. Returns the (H, W) float32
    accumulators; a total is their sum."""
    if mode not in LCG_MODES:
        raise ValueError(f"mode must be one of {sorted(LCG_MODES)}")
    h, w = lanes
    if mode == "row" and table.shape[0] != h:
        raise ValueError("mode 'row' gathers from the lane's own row: the table needs H rows")
    if not _on_card(table):
        return lcg_gather_sum_plain(table, mode, lanes, iters, seed, row_mul)
    _check(table, "table", (f32, i32))
    if h * w >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes lanes and the table with 32-bit integers")
    acc = torch.empty(h, w, dtype=f32, device=table.device)
    rows_t, cols_t = table.shape
    dc = cols_t if mode != "flat" else rows_t * cols_t
    dr = rows_t if mode == "rc" else 1
    _launch("probe_lcg_gather_sum", table.data_ptr(), int(table.dtype == i32), LCG_MODES[mode],
            cols_t, dc, *div_plan(dc), dr, *div_plan(dr), seed & MASK, row_mul & MASK, h, w,
            int(iters), lcg_threads(h * w, _sm_count(table.device)), acc.data_ptr(),
            device=table.device)
    lcg_gather_sum.launches += 1
    return acc


lcg_gather_sum.launches = 0


# ---------------------------------------------------------------------------
# carry_loop: carry30 (X3) and march (Q6)
# ---------------------------------------------------------------------------

def carry30_plain(table, seed, iters, lanes):
    rows_t, cols_t = table.shape
    dev = table.device
    s = lane_seeds(seed, lanes, 0, dev)
    keep, mix = _f32(C_KEEP, dev), _f32(C_MIX, dev)
    arrs = [torch.full(lanes, float(np.float32(0.01 * m)), dtype=f32, device=dev)
            for m in range(N_CARRY)]
    flat = table.reshape(-1)
    for _ in range(iters):
        s = lcg32(s)
        r = (s >> 8) % rows_t
        s = lcg32(s)
        prev = flat[r * cols_t + (s >> 8) % cols_t]
        for m in range(N_CARRY):
            arrs[m] = fma32(arrs[m], keep, prev * mix)
            prev = arrs[m]
    acc = arrs[0]
    for a in arrs[1:]:
        acc = acc + a
    return acc


def carry30(table: torch.Tensor, seed: int, iters: int, lanes=(8, 128)) -> torch.Tensor:
    """X3: 30 float32 values per lane (starting at 0.01 * m), ``iters``
    steps of one LCG (r, c) gather from the (R, C) float32 ``table`` chained
    through them, ``a = fma(a, 0.9999, prev * 1e-4)``; lane (i, j) seeded
    ``seed + j``. Returns the (H, W) per-lane sums of the 30."""
    if not _on_card(table):
        return carry30_plain(table, seed, iters, lanes)
    _check(table, "table", (f32,))
    rows_t, cols_t = table.shape
    n_lanes = lanes[0] * lanes[1]
    if n_lanes * CARRY_PARTS >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError("the kernel indexes threads and the table with 32-bit integers")
    out = torch.empty(lanes, dtype=f32, device=table.device)
    if n_lanes == 0:
        return out
    _launch("probe_carry30", table.data_ptr(), cols_t, rows_t, *div_plan(rows_t), cols_t,
            *div_plan(cols_t), seed & MASK, int(iters), n_lanes, lanes[1], float(C_KEEP),
            float(C_MIX), lcg_threads(n_lanes * CARRY_PARTS, _sm_count(table.device)),
            out.data_ptr(), device=table.device)
    carry30.launches += 1
    return out


carry30.launches = 0


def march_plain(table, x, s, iters):
    dev = table.device
    rows_t, w = table.shape[0], x.shape[1]
    col = torch.arange(w, dtype=i64, device=dev)
    near, far, decay = _f32(S_NEAR, dev), _f32(S_FAR, dev), _f32(DECAY, dev)
    half, inv = _f32(0.5, dev), _f32(1.0 / 8388608.0, dev)
    pos, vel, rs = x, torch.full_like(x, float(VEL0)), _u32_values(s)
    for _ in range(iters):
        rs = lcg32(rs)
        jitter = (rs >> 9).to(f32) * inv
        cell = torch.clamp((pos[0] * 16.0).to(i32), 0, rows_t - 1).to(i64)
        maj = table[cell, col]
        step = torch.where(maj > 0.5, near, far) * (half + jitter)
        pos = fma32(vel, step, pos)
        vel = vel * decay
    return pos + vel


def march(table: torch.Tensor, x: torch.Tensor, s: torch.Tensor, iters: int) -> torch.Tensor:
    """Q6: ``iters`` march-like steps of an (8, W) lane block (``x`` the
    float32 positions, ``s`` the u32 LCG states, int64 values or int32
    bits) against the (R, W)
    float32 majorant ``table``; every row reads the cell of row 0. Returns
    pos + vel."""
    if tuple(x.shape) != (8, table.shape[1]) or tuple(s.shape) != tuple(x.shape):
        raise ValueError("march takes (8, W) lanes over an (R, W) table")
    if not _on_card(table):
        return march_plain(table, x, s, iters)
    _check(table, "table", (f32,))
    _check(x, "x", (f32,))
    sb = u32_bits(s)
    out = torch.empty_like(x)
    _launch("probe_march", table.data_ptr(), table.shape[0], x.shape[1], x.data_ptr(),
            sb.data_ptr(), int(iters), float(VEL0), float(S_NEAR), float(S_FAR), float(DECAY),
            out.data_ptr(), device=table.device)
    march.launches += 1
    return out


march.launches = 0


# ---------------------------------------------------------------------------
# row_gather_rounds
# ---------------------------------------------------------------------------

def round_ids(base: torch.Tensor, k: torch.Tensor, rows: int, use_mask: bool) -> torch.Tensor:
    """The rows of rounds ``k`` (a column) for lanes ``base`` (a row)."""
    v = base.to(i64)[None, :] + ROUND_STEP * k.to(i64)[:, None]
    return v & 0xFFFF if use_mask else v % rows


def row_gather_rounds_plain(base, tab, mode, rounds, n, use_mask, chunk=4096):
    base = base.reshape(-1)
    dev = tab.device
    rows = tab.shape[0]
    acc = torch.zeros(LANES, dtype=i64, device=dev)
    lane = torch.arange(LANES, device=dev)
    for k0 in range(0, rounds, chunk):
        ids = round_ids(base, torch.arange(k0, min(rounds, k0 + chunk), device=dev), rows,
                        use_mask)
        if mode in ("ids", "stage"):
            acc += ids.sum(0)
        elif mode in ("direct", "staged"):
            words = tab[ids, ids & 127].to(i64)
            acc += torch.where(lane < n, words, 0).sum(0)
    return u32_bits(acc).to(i32)


def check_staged_table(tab: torch.Tensor):
    """Raise unless the staged modes' 16-byte copies can move ``tab``'s rows:
    (rows, 128) 32-bit words whose rows lie 512 bytes apart, from a 16-byte
    aligned address (cp.async's alignment). The staged modes take no other
    table, on any device: the kernel never falls back to another copy."""
    if (tab.dim() != 2 or tab.shape[1] != LANES or tab.element_size() != 4
            or tab.stride(1) != 1 or (tab.shape[0] > 1 and tab.stride(0) != LANES)):
        raise ValueError("the staged modes copy (rows, 128) 32-bit tables whose rows lie "
                         "512 bytes apart")
    if tab.data_ptr() % 16:
        raise ValueError("the staged modes' 16-byte copies need a 16-byte aligned table")


def row_gather_rounds(base: torch.Tensor, tab: torch.Tensor, mode: str, rounds: int,
                      n: int = LANES, use_mask: bool = False) -> torch.Tensor:
    """The dmagather checksum over ``rounds`` rounds: lane j's row in round
    k is (base[j] + 7919 k) % rows (& 0xFFFF with ``use_mask``), and lanes
    j < n add tab[row, row & 127] to a wrapping 32-bit sum. ``mode``:
    "direct" loads the word; "staged" copies the n rows into shared memory
    and picks the word there; "stage" copies them and adds the row number;
    "ids" adds the row number with no load; "stale" picks from a landing
    buffer that nothing wrote (zero-filled). Returns the (128,) int32 sums.
    "stage" and "staged" take only a table ``check_staged_table`` accepts."""
    if mode not in ROW_GATHER_MODES:
        raise ValueError(f"mode must be one of {sorted(ROW_GATHER_MODES)}")
    rows = tab.shape[0]
    if use_mask and rows < 0x10000:
        raise ValueError("the & 0xFFFF index needs a table of at least 65536 rows")
    if ROUND_STEP * rounds + rows >= 2 ** 31 or not 0 <= n <= LANES:
        raise ValueError("too many rounds or lanes")
    if mode in ("stage", "staged"):
        check_staged_table(tab)
    if not _on_card(tab):
        return row_gather_rounds_plain(base, tab, mode, rounds, n, use_mask)
    _check(tab, "tab", (i32,), (rows, LANES))
    base = base.reshape(-1)
    _check(base, "base", (i32,), (LANES,))
    out = torch.empty(LANES, dtype=i32, device=tab.device)
    _launch("probe_row_gather_rounds", ROW_GATHER_MODES[mode], base.data_ptr(), tab.data_ptr(),
            rows, int(use_mask), int(n), int(rounds), out.data_ptr(), device=tab.device)
    row_gather_rounds.launches += 1
    return out


row_gather_rounds.launches = 0


# ---------------------------------------------------------------------------
# index_copy, tea8, row_scan
# ---------------------------------------------------------------------------

def _index_copy_shape(x, op, arg):
    h, w = x.shape
    return {"transpose": (w, h), "tile_rows": (h * arg, w), "roll_cols": (h, w),
            "broadcast_row0": (arg, w), "iota_plus": (arg, w)}[op]


def index_copy_plain(x, op, arg=0):
    h, w = x.shape
    if op == "transpose":
        return x.t().clone()
    if op == "tile_rows":
        return x[torch.arange(h * arg, device=x.device) % h]
    if op == "roll_cols":
        return x[:, (torch.arange(w, device=x.device) - arg) % w]
    if op == "broadcast_row0":
        return x[0:1].expand(arg, w).clone()
    return torch.arange(arg, dtype=i32, device=x.device).to(f32)[:, None].expand(arg, w) + x[0, 0]


T_COLS = 32        # csrc/probes.cu: a transpose tile's columns (words); 64 threads a block


def transpose_plan(h: int, w: int, ld: int, ptr: int):
    """(vec, tile_rows, gx, gy) of the transpose kernel for an (h, w) array
    of 32-bit words whose rows lie ``ld`` words apart from address ``ptr``.
    vec: the 16-byte path (h, w and ld multiples of 4, ptr 16-byte aligned).
    A block moves a tile_rows x T_COLS tile: 8 rows for an array of at most
    8 rows (every thread busy), else 32. The grid is gx tiles across by gy
    down, one tile a block; more than MAX_GRID_Y tiles down raise."""
    vec = h % 4 == 0 and w % 4 == 0 and ld % 4 == 0 and ptr % 16 == 0
    tile_rows = 8 if h <= 8 else 32
    gy = -(-h // tile_rows)
    if gy > MAX_GRID_Y:
        raise ValueError(f"the transpose takes at most {MAX_GRID_Y * tile_rows} rows")
    return vec, tile_rows, -(-w // T_COLS), gy


def _transpose(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    ld = x.stride(0) if h > 1 else w
    if x.dtype not in (f32, i32) or (w > 1 and x.stride(1) != 1) or ld < w:
        raise ValueError("the transpose takes a float32 or int32 array of unit column "
                         "stride whose rows do not overlap")
    if h * w >= 2 ** 31 - 256:
        raise ValueError("the kernel indexes rows and columns with 32-bit integers")
    out = torch.empty(w, h, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec, tile_rows, gx, gy = transpose_plan(h, w, ld, x.data_ptr())
    _launch("probe_transpose", x.data_ptr(), h, w, ld, int(vec), tile_rows, gx, gy,
            out.data_ptr(), device=x.device)
    index_copy.launches += 1
    return out


def index_copy(x: torch.Tensor, op: str, arg: int = 0) -> torch.Tensor:
    """Data movement of a 2-D float32 / int32 array: "transpose"; "tile_rows"
    (``arg`` copies stacked on axis 0, as pltpu.repeat); "roll_cols" (by
    ``arg``, as jnp.roll on axis 1); "broadcast_row0" (row 0 to ``arg``
    rows); "iota_plus" (float32 row number + x[0, 0], ``arg`` rows). The
    transpose also takes an array whose rows are strided (a column slice);
    the other ops take contiguous arrays."""
    if op not in INDEX_COPY_OPS:
        raise ValueError(f"op must be one of {sorted(INDEX_COPY_OPS)}")
    if x.dim() != 2:
        raise ValueError("index_copy takes a 2-D array")
    if op == "iota_plus" and x.dtype != f32:
        raise ValueError("iota_plus adds to a float32 array")
    if not _on_card(x):
        return index_copy_plain(x, op, arg)
    if op == "transpose":
        return _transpose(x)
    _check(x, "x", (f32, i32))
    oh, ow = _index_copy_shape(x, op, arg)
    if oh * ow >= 2 ** 31:
        raise ValueError("the kernel indexes the output with 32-bit integers")
    out = torch.empty(oh, ow, dtype=x.dtype, device=x.device)
    param = arg if op == "roll_cols" else 0
    _launch("probe_index_copy", x.data_ptr(), x.shape[0], x.shape[1], INDEX_COPY_OPS[op], param,
            out.data_ptr(), oh, ow, device=x.device)
    index_copy.launches += 1
    return out


index_copy.launches = 0


def tea8_plain(a, b):
    v0, v1, s = _u32_values(a), _u32_values(b), 0
    for _ in range(8):
        s = (s + 0x9E3779B9) & MASK
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    if a.dtype == i32:
        return u32_bits(v0), u32_bits(v1)
    return v0, v1


def tea8(a: torch.Tensor, b: torch.Tensor):
    """8 TEA rounds of the u32 pairs (a, b): int64 tensors holding u32
    values, or int32 tensors holding their bits; returns (v0, v1) in the
    same form."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError("a and b must have the same shape and type")
    if not _on_card(a):
        return tea8_plain(a, b)
    ab, bb = u32_bits(a), u32_bits(b)
    o0, o1 = torch.empty_like(ab), torch.empty_like(bb)
    _launch("probe_tea8", ab.data_ptr(), bb.data_ptr(), o0.data_ptr(), o1.data_ptr(), ab.numel(),
            device=a.device)
    tea8.launches += 1
    if a.dtype == i32:
        return o0, o1
    return _u32_values(o0), _u32_values(o1)


tea8.launches = 0


def row_scan_plain(x):
    return torch.cumsum(x, dim=1)


def row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along each row of an (H, W <= 1024) float32
    array. The kernel adds in a tree order, so it agrees with a sequential
    cumsum to rounding (relative 1e-5 at the probe's shape), not bitwise."""
    if x.dim() != 2 or x.shape[1] > 1024:
        raise ValueError("row_scan takes an (H, W <= 1024) array")
    if not _on_card(x):
        return row_scan_plain(x)
    _check(x, "x", (f32,))
    out = torch.empty_like(x)
    _launch("probe_row_scan", x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            device=x.device)
    row_scan.launches += 1
    return out


row_scan.launches = 0

# every wrapper, by family name, for counters and reports
WRAPPERS = {"affine_loop": affine_loop, "gather": gather, "lcg_gather_sum": lcg_gather_sum,
            "carry30": carry30, "march": march, "row_gather_rounds": row_gather_rounds,
            "index_copy": index_copy, "tea8": tea8, "row_scan": row_scan}
