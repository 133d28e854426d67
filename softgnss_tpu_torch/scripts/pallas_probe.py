"""S5: the construct probes — six Hopper constructs, each against its plain
version, with its resources and its time.

Replaces ``scripts/pallas_probe.py``, which checked that Mosaic lowers six
constructs on the TPU (``_k_grid`` :31 via ``gridded`` :35, ``_k_acc`` :47
via ``gridded_acc`` :54, ``_k_conv`` :66 via ``conv`` :70, ``_k_3d`` :79
via ``batched3d`` :86, ``_k_bdot`` :96 via ``bdot`` :102, ``_k_dot`` :112
via ``dot2d`` :120).  Its counterpart here is ``csrc/pallas_probe.cu``:

* ``grid`` — ``x + 1``, (64, 128) float32, 8 CTAs of one (8, 128) block,
  one float4 per thread;
* ``acc`` — ``o[r] = sum_i sum_j x[8i + r, j]`` into (8, 1): ONE 8-CTA
  thread block cluster whose ranks push their partials one-sided into
  rank 0's shared memory (``st.async`` completing on rank 0's mbarrier;
  a consumer warp of rank 0 frees each slot with a remote mbarrier
  arrive), with no cluster barrier per rep; ``reps`` repeats that step,
  and ``(t(64) - t(1)) / 63`` is the cost of one rep's handoff, what B1's
  cluster pays per ms;
* ``conv`` — int32 -> float32, round to nearest even, (8, 128): 16-byte
  vectors, one CTA of one vector per thread (:func:`conv_plan`);
* ``onehot`` — ``o[c, k] = sum_w [h[c, w] == k] * b[c, w]``, (8, 256) ->
  (8, 32): one warp per row, each lane adding its run of columns into its
  own row of a per-warp table in shared memory, then lane k summing bin k
  over the lanes (:func:`onehot_plan`);
* ``bdot`` — (4, 8, 128) @ (4, 128, 8) on the tensor cores
  (``mma.sync`` m16n8k8 TF32): ``dot``'s kernel body, one CTA per batch
  (its 8 x 8 output tile), at ``dot_plan(8, K, 8)``;
* ``dot`` — ``4 * (a @ b)``, (32, 512) @ (512, 128), by a 4-step loop in
  the kernel on the tensor cores: one CTA per 8 x 8 output tile, its
  operands staged in shared memory once, K split across 8 warps
  (:func:`dot_plan`).

Every probe was redesigned for the card.  The first designs of grid,
acc, onehot, bdot and dot, and B1's former handoff for acc (one cluster
barrier per rep), lost every timing and were deleted; conv's first design
stays beside it (``conv_loop`` in :data:`VARIANTS`, its own wrapper and
launch count): it is faster at the script's shape and slower at B2's.
``conv`` and ``onehot`` are also run where they do real work
(:func:`receiver_inputs`): conv on one block of B2's frames, (64, 8,
9580) int32, and onehot at the JAX receiver's one-hot geometry, (4800,
128) -> (4800, 32).

The kernels of S4 (scripts.dma_probe) and S5 are the probes' own library,
:data:`PROBE_LIBRARY` (``csrc/dma_probe.cu`` and ``csrc/pallas_probe.cu``),
built at first use beside the receiver's and loaded by these two scripts
alone.  What "does it lower" was on the TPU is here what ptxas reports for
each kernel (registers, shared memory, stack, spills), parsed from that
library's ``-Xptxas -v`` log.

Run on a CUDA card from the repository root::

    python -m softgnss_tpu_torch.scripts.pallas_probe

It prints the card line and each kernel's resources, holds each kernel
(every design) against its own plain version (:data:`PLAINS`) on the TPU
script's own inputs (ones, arange), on seeded random inputs and, for conv
and onehot, at the receiver's geometry, printing ``[ok]`` or ``[FAIL]``
as the TPU script does (``grid``, ``acc``, ``conv`` and ``onehot``
bit-equal; ``bdot`` and ``dot`` within ``2^-10 * sum_k |a_ik b_kj|`` per
output, the TF32 rounding of both inputs, and bit-equal on the script's
ones), holds each :data:`LIBRARY` call to the same plain versions, then
times each kernel (conv's designs in turns; acc at 1 and 64 reps;
conv's and onehot's also L2-flushed and inside a CUDA graph, and
at the receiver's geometry), its plain version and one PyTorch call that
computes the same function (for bdot and dot with TF32 allowed, as the
kernels compute, and at PyTorch's default precision).
Without a CUDA card it raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
import sys
from typing import NamedTuple

import numpy as np
import torch

from softgnss_tpu_torch.scripts.inputs import SEED
from softgnss_tpu_torch.scripts.timing import (TF32_OPS_PER_S, bound_ms, card, cold_ms, cuda_ms,
                                               flushed_marginal_ms, graph_marginal_ms,
                                               require_cuda)
from softgnss_tpu_torch.track import cuda_lib

#: the probes' library: S4's and S5's kernels, loaded by scripts.dma_probe
#: and this script only
PROBE_LIBRARY = cuda_lib.Library("sgprobe", ("dma_probe.cu", "pallas_probe.cu"))
_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_GRID = PROBE_LIBRARY.entry("sg_probe_grid", [_vp, _vp, _i, _vp])
_ACC = PROBE_LIBRARY.entry("sg_probe_acc", [_vp, _vp, _i, _vp])
_CONV = PROBE_LIBRARY.entry("sg_probe_conv", [_vp, _vp, _ll, _i, _vp])
_CONV_LOOP = PROBE_LIBRARY.entry("sg_probe_conv_loop", [_vp, _vp, _ll, _vp])
_ONEHOT = PROBE_LIBRARY.entry("sg_probe_onehot", [_vp, _vp, _vp] + [_i] * 5 + [_vp])
_BDOT = PROBE_LIBRARY.entry("sg_probe_bdot", [_vp, _vp, _vp] + [_i] * 6 + [_vp])
_DOT = PROBE_LIBRARY.entry("sg_probe_dot", [_vp, _vp, _vp] + [_i] * 8 + [_vp])

PROBES = ("grid", "acc", "conv", "onehot", "bdot", "dot")
#: the TPU script's line number of each kernel's pl.pallas_call
REPLACES = {"grid": "scripts/pallas_probe.py:37", "acc": "scripts/pallas_probe.py:56",
            "conv": "scripts/pallas_probe.py:72", "onehot": "scripts/pallas_probe.py:89",
            "bdot": "scripts/pallas_probe.py:105", "dot": "scripts/pallas_probe.py:123"}
#: the TF32 bound of bdot and dot: |kernel - plain| <= TF32_REL * sum_k |a_ik b_kj|
TF32_REL = 2.0**-10
DOT_STEPS = 4
#: the reps of acc timed against one rep: their difference is 63 steps
ACC_REPS = 64
_BLOCK_ROWS, _COLS, _CLUSTER, _BINS = 8, 128, 8, 32


def _out(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _launch(name: str, fn, *args) -> None:
    dev = args[0].device if isinstance(args[0], torch.Tensor) else None
    with torch.cuda.device(dev):
        rc = fn(*[cuda_lib.ptr(a) if isinstance(a, torch.Tensor) else a for a in args],
                cuda_lib.stream(dev))
    cuda_lib.check(rc, name)


def require_vec4(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` is 16-byte aligned: the grid and dot kernels (dot's
    also runs bdot) move it by 16-byte loads (float4, cp.async) and have no
    scalar path to fall back on."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (its address is {t.data_ptr() % 16} "
                         "bytes past a 16-byte boundary)")


# --- 1. grid -----------------------------------------------------------------


def probe_grid_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def _require_grid(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] % _BLOCK_ROWS:
        raise ValueError(f"probe_grid: x must be (8n, 128), got {tuple(x.shape)}")
    cuda_lib.require(x, "x", torch.float32, (x.shape[0], _COLS), x.device)


def probe_grid(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for (8n, 128) float32 by kernel ``probe_grid_kernel`` (one
    float4 per thread; x contiguous and 16-byte aligned, else ValueError)
    on a CUDA tensor; :func:`probe_grid_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_grid_plain(x)
    _require_grid(x)
    require_vec4(x, "x")
    o = _out(x.shape, torch.float32, x)
    _launch("probe_grid", _GRID, x, o, x.shape[0] // _BLOCK_ROWS)
    probe_grid.launches += 1
    return o


probe_grid.launches = 0


# --- 2. acc: one 8-CTA cluster -----------------------------------------------


def probe_acc_plain(x: torch.Tensor) -> torch.Tensor:
    """(8, 1) float32: ``o[r] = sum_i sum_j x[8i + r, j]`` in the kernel's
    order: for CTA i and row r, lane l sums x[8i + r, l + 32q] over q in
    float64, a shuffle tree over the 32 lanes (offsets 16 .. 1), then
    rank 0 sums the 8 CTAs' partials in rank order; rounded once."""
    v = x.reshape(_CLUSTER, _BLOCK_ROWS, _COLS // 32, 32).to(torch.float64)
    lanes = v[:, :, 0]
    for q in range(1, _COLS // 32):
        lanes = lanes + v[:, :, q]
    off = 16
    while off:
        lanes = torch.cat([lanes[..., :off] + lanes[..., off:2 * off], lanes[..., off:]], -1)
        off //= 2
    part = lanes[..., 0]                                  # (rank, row)
    s = part[0]
    for q in range(1, _CLUSTER):
        s = s + part[q]
    return s.to(torch.float32)[:, None]


def _launch_acc(name: str, entry, x: torch.Tensor, reps: int) -> torch.Tensor:
    if reps < 1:
        raise ValueError(f"{name}: reps must be >= 1, got {reps}")
    cuda_lib.require(x, "x", torch.float32, (_CLUSTER * _BLOCK_ROWS, _COLS), x.device)
    o = _out((_BLOCK_ROWS, 1), torch.float32, x)
    _launch(name, entry, x, o, int(reps))
    return o


def probe_acc(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """:func:`probe_acc_plain` of (64, 128) float32 by kernel
    ``probe_acc_kernel``, one 8-CTA cluster run ``reps`` times, each rep
    pushed one-sided into rank 0's shared memory (``st.async`` onto rank
    0's mbarrier, the slot freed by a remote arrive from rank 0's consumer
    warp; no cluster barrier per rep), on a CUDA tensor; the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_acc_plain(x)
    o = _launch_acc("probe_acc", _ACC, x, reps)
    probe_acc.launches += 1
    return o


probe_acc.launches = 0


# --- 3. conv -----------------------------------------------------------------

#: threads per CTA of ``probe_conv_kernel`` and the 16-byte vectors a
#: thread loads before it stores (csrc's kConvThreads and kConvVecs); its
#: CTAs per SM at most, which sizes the grid at large n
CONV_THREADS = 256
CONV_VECS = 4
CONV_CTAS_PER_SM = 4


def probe_conv_plain(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


class ConvPlan(NamedTuple):
    """How ``probe_conv_kernel`` covers n elements: ``blocks`` CTAs of
    CONV_THREADS threads; thread t of the grid converts the 16-byte
    vectors :meth:`vectors_of` (t), CONV_VECS loaded before any is
    stored, and threads 0 .. tail - 1 the ``tail`` = n % 4 elements after
    the last whole vector."""

    vectors: int
    tail: int
    blocks: int

    @property
    def threads(self) -> int:
        return self.blocks * CONV_THREADS

    def vectors_of(self, thread: int) -> range:
        return range(thread, self.vectors, self.threads)


def conv_plan(n: int, sms: int) -> ConvPlan:
    """The launch plan of ``probe_conv_kernel`` for n int32 on a card of
    ``sms`` SMs: as many CTAs as give each thread at most CONV_VECS vectors
    (one CTA of one vector per thread at the script's 1 024 elements), and
    no more than CONV_CTAS_PER_SM per SM (where a thread then takes its
    vectors CONV_VECS at a time)."""
    if n < 0 or sms < 1:
        raise ValueError(f"probe_conv: {n} elements on {sms} SMs")
    vectors = n // 4
    blocks = min(-(-vectors // (CONV_THREADS * CONV_VECS)), sms * CONV_CTAS_PER_SM)
    return ConvPlan(vectors, n % 4, max(blocks, 1))


def probe_conv(x: torch.Tensor) -> torch.Tensor:
    """int32 -> float32 (round to nearest even): kernel ``probe_conv_kernel``
    (16-byte vectors at :func:`conv_plan`; x contiguous and 16-byte
    aligned, else ValueError) on a CUDA tensor, :func:`probe_conv_plain` on
    a CPU tensor."""
    if x.device.type == "cpu":
        return probe_conv_plain(x)
    cuda_lib.require(x, "x", torch.int32, tuple(x.shape), x.device)
    require_vec4(x, "x")
    plan = conv_plan(x.numel(), cuda_lib.sm_count(x.device.index))
    o = _out(x.shape, torch.float32, x)
    _launch("probe_conv", _CONV, x, o, x.numel(), plan.blocks)
    probe_conv.launches += 1
    return o


probe_conv.launches = 0


def probe_conv_loop(x: torch.Tensor) -> torch.Tensor:
    """:func:`probe_conv` by the first design's kernel
    ``probe_conv_loop_kernel`` (a grid-stride loop of 4-byte loads; any
    alignment) on a CUDA tensor: faster than probe_conv at the script's
    shape, slower at B2's block."""
    if x.device.type == "cpu":
        return probe_conv_plain(x)
    cuda_lib.require(x, "x", torch.int32, tuple(x.shape), x.device)
    o = _out(x.shape, torch.float32, x)
    _launch("probe_conv_loop", _CONV_LOOP, x, o, x.numel())
    probe_conv_loop.launches += 1
    return o


probe_conv_loop.launches = 0


# --- 4. onehot ---------------------------------------------------------------

#: warps (rows) per CTA of ``probe_onehot_kernel`` by default (the fastest
#: of the sweep at the script's shape and at the receiver's, PERF.md) and
#: at most (its launch bounds), and the counts ``measure`` times in turns
ONEHOT_WARPS = 2
ONEHOT_MAX_WARPS = 16
ONEHOT_WARP_SWEEP = (1, 2, 4, 8, 16)
#: the widest row it takes (8 vectors per lane)
ONEHOT_MAX_WIDTH = 1024
#: doubles per lane row of a warp's table: 32 bins and one of padding
_ONEHOT_PITCH = _BINS + 1


def probe_onehot_plain(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(rows, 32) float32: ``o[c, k] = sum_w [h[c, w] == k] * b[c, w]`` in
    ``probe_onehot_kernel``'s order: lane l's run of width / 32 columns
    summed in column order in float64, then bin k's 32 lane sums in lane
    order; rounded once.  The width is a multiple of 32."""
    rows, width = h.shape
    if width % 32:
        raise ValueError(f"probe_onehot: width {width} is not 32 lanes' runs of columns")
    cols = width // 32
    hl = h.reshape(rows, 32, cols)
    bl = b.to(torch.float64).reshape(rows, 32, cols)
    bins = torch.arange(_BINS, device=h.device)
    part = torch.zeros((rows, 32, _BINS), dtype=torch.float64, device=h.device)
    for j in range(cols):
        part = part + torch.where(hl[:, :, j, None] == bins, bl[:, :, j, None], 0.0)
    s = part[:, 0]
    for lane in range(1, 32):
        s = s + part[:, lane]
    return s.to(torch.float32)


class OnehotPlan(NamedTuple):
    """How ``probe_onehot_kernel`` covers (rows, width): warp w of CTA c
    sums row :meth:`row_of` (c, w), lane l of it the columns
    :meth:`columns_of` (l), read as ``vecs_per_lane`` 16-byte vectors.
    Each CTA launches with ``smem_bytes`` of dynamic shared memory, a
    table of 32 lanes x 33 doubles per warp."""

    rows: int
    width: int
    warps: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return -(-self.rows // self.warps)

    @property
    def vecs_per_lane(self) -> int:
        return self.width // 128

    def row_of(self, cta: int, warp: int) -> int | None:
        """The row warp ``warp`` of CTA ``cta`` sums; None past the last."""
        row = cta * self.warps + warp
        return row if row < self.rows else None

    def columns_of(self, lane: int) -> range:
        """The columns lane ``lane`` adds into its row of the table, in order."""
        cols = self.width // 32
        return range(lane * cols, (lane + 1) * cols)


def onehot_plan(rows: int, width: int, warps: int = ONEHOT_WARPS) -> OnehotPlan:
    """The launch plan of ``probe_onehot_kernel`` for (rows, width): one
    warp per row, ``warps`` rows per CTA (fewer where there are fewer
    rows).  Raises ValueError on a shape the kernel does not take: no
    row, or a width that is not a positive multiple of 128 (one 16-byte
    vector of h and of b per lane per step) up to ONEHOT_MAX_WIDTH; or on
    ``warps`` outside [1, ONEHOT_MAX_WARPS]."""
    if width <= 0 or width % 128 or width > ONEHOT_MAX_WIDTH:
        raise ValueError(f"probe_onehot: width {width} is not a multiple of 128 up to "
                         f"{ONEHOT_MAX_WIDTH} (one 16-byte vector per lane per step)")
    if rows < 1:
        raise ValueError(f"probe_onehot: {rows} rows")
    if not 1 <= warps <= ONEHOT_MAX_WARPS:
        raise ValueError(f"probe_onehot: {warps} warps, not in [1, {ONEHOT_MAX_WARPS}]")
    warps = min(warps, rows)
    return OnehotPlan(rows, width, warps, warps * 32 * _ONEHOT_PITCH * 8)


def _require_onehot(name: str, h: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be (rows, width), got {tuple(h.shape)}")
    rows, width = h.shape
    cuda_lib.require(h, "h", torch.int32, (rows, width), h.device)
    cuda_lib.require(b, "b", torch.float32, (rows, width), h.device)
    return rows, width


def probe_onehot(h: torch.Tensor, b: torch.Tensor, warps: int | None = None) -> torch.Tensor:
    """:func:`probe_onehot_plain` by kernel ``probe_onehot_kernel`` (one
    warp per row, a per-lane table in shared memory) at
    ``onehot_plan(rows, width, warps)`` (ONEHOT_WARPS by default; h and b
    contiguous and 16-byte aligned, else ValueError) on CUDA tensors, the
    plain version on CPU tensors.  ``probe_onehot.smem_bytes`` records the
    dynamic shared memory of the last launch."""
    if h.device.type == "cpu":
        return probe_onehot_plain(h, b)
    rows, width = _require_onehot("probe_onehot", h, b)
    plan = onehot_plan(rows, width, ONEHOT_WARPS if warps is None else warps)
    require_vec4(h, "h")
    require_vec4(b, "b")
    o = _out((rows, _BINS), torch.float32, h)
    _launch("probe_onehot", _ONEHOT, h, b, o, rows, width, plan.warps, plan.vecs_per_lane,
            plan.smem_bytes)
    probe_onehot.launches += 1
    probe_onehot.smem_bytes = plan.smem_bytes
    return o


probe_onehot.launches = 0
probe_onehot.smem_bytes = None


# --- 5. bdot, 6. dot: tensor cores -------------------------------------------


def probe_bdot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) float32: the batched product in float64, rounded once."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


def _require_bdot(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if a.dim() != 3 or a.shape[1] != 8 or a.shape[2] % 8:
        raise ValueError(f"probe_bdot: a must be (B, 8, 8n), got {tuple(a.shape)}")
    batch, _, k = a.shape
    cuda_lib.require(a, "a", torch.float32, (batch, 8, k), a.device)
    cuda_lib.require(b, "b", torch.float32, (batch, k, 8), a.device)
    return batch, k


def probe_bdot(a: torch.Tensor, b: torch.Tensor, warps: int | None = None) -> torch.Tensor:
    """(B, 8, K) @ (B, K, 8) on CUDA tensors by ``probe_dot_kernel``, the
    body of :func:`probe_dot`: one CTA per batch (its 8 x 8 output tile,
    steps = 1) at ``dot_plan(8, K, 8, warps)`` (BDOT_WARPS by default;
    K a multiple of 8 up to 1024, B <= 65535, a and b contiguous and
    16-byte aligned, else ValueError); :func:`probe_bdot_plain` on CPU
    tensors.  ``probe_bdot.smem_bytes`` records the dynamic shared memory
    of the last launch."""
    if a.device.type == "cpu":
        return probe_bdot_plain(a, b)
    batch, k = _require_bdot(a, b)
    if batch > 65535:
        raise ValueError(f"probe_bdot: {batch} batches, more than the grid's 65535")
    plan = dot_plan(8, k, 8, BDOT_WARPS if warps is None else warps)
    require_vec4(a, "a")
    require_vec4(b, "b")
    o = _out((batch, 8, 8), torch.float32, a)
    _launch("probe_bdot", _BDOT, a, b, o, batch, k, plan.warps, plan.slices_per_warp,
            plan.lda, plan.smem_bytes)
    probe_bdot.launches += 1
    probe_bdot.smem_bytes = plan.smem_bytes
    return o


probe_bdot.launches = 0
probe_bdot.smem_bytes = None


def probe_dot_plain(a: torch.Tensor, b: torch.Tensor, steps: int = DOT_STEPS) -> torch.Tensor:
    """(M, N) float32: ``steps * (a @ b)`` in float64, rounded once."""
    return (steps * (a.to(torch.float64) @ b.to(torch.float64))).to(torch.float32)


#: warps per CTA of ``probe_dot_kernel`` up to K = 512, and at most (its
#: launch bounds); K slices per warp at most (its register arrays of
#: fragments), so K <= 16 * 8 * 8 = 1024; floats of padding after each row
#: of a it stages.  The plan is made here alone: the launch takes warps,
#: slices per warp, row stride and shared memory from it, and refuses
#: (cudaErrorInvalidValue) a plan beyond the kernel's limits.
DOT_WARPS = 8
DOT_MAX_WARPS = 16
DOT_SLICES = 8
_DOT_PAD = 4
#: warps per CTA of bdot (``dot_plan(8, K, 8, BDOT_WARPS)``): one CTA per
#: batch and only K / 8 slices to deal (16 at the script's K = 128)
BDOT_WARPS = 4
#: the warp counts ``measure`` times bdot at, in turns
BDOT_WARP_SWEEP = (2, 4, 8)


class DotPlan(NamedTuple):
    """How ``probe_dot_kernel`` covers (M, K) @ (K, N): CTA c computes the
    8 x 8 output tile at :meth:`tile` (c), warp w of its ``warps`` the
    8-wide K slices :meth:`slices_of` (w).  Each CTA launches with
    ``smem_bytes`` of dynamic shared memory: its 8 rows of a at a stride
    of ``lda`` floats (K + 4: a fragment read then hits 32 distinct banks),
    its 8 columns of b as (K, 8), and ``warps`` partial 8 x 8 tiles."""

    tiles_m: int
    tiles_n: int
    slices: int
    warps: int
    slices_per_warp: int
    lda: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.tiles_m * self.tiles_n

    def tile(self, cta: int) -> tuple[int, int]:
        """(m0, n0), the first row and column of CTA ``cta``'s tile."""
        return 8 * (cta // self.tiles_n), 8 * (cta % self.tiles_n)

    def slices_of(self, warp: int) -> range:
        """The K slices (columns 8j .. 8j + 7 of a) warp ``warp`` sums."""
        j0 = min(warp * self.slices_per_warp, self.slices)
        return range(j0, min(j0 + self.slices_per_warp, self.slices))


def dot_plan(m: int, k: int, n: int, warps: int = DOT_WARPS) -> DotPlan:
    """The launch plan of ``probe_dot_kernel`` for (m, k) @ (k, n): one CTA
    per 8 x 8 output tile; ``warps`` warps per CTA, or as many more (up to
    DOT_MAX_WARPS) as keep each warp's K slices within DOT_SLICES, dealt in
    runs of ceil(K/8 / warps).  Raises ValueError on a shape the kernel
    does not take: an empty or ragged tile (m, k or n not a positive
    multiple of 8), or K > 1024; or on ``warps`` outside [1,
    DOT_MAX_WARPS]."""
    if min(m, k, n) <= 0 or m % 8 or k % 8 or n % 8:
        raise ValueError(f"probe_dot: ({m}, {k}) @ ({k}, {n}) is not a whole number of 8 x 8 "
                         "output tiles and 8-wide K slices")
    slices = k // 8
    if slices > DOT_MAX_WARPS * DOT_SLICES:
        raise ValueError(f"probe_dot: K = {k} is more than {DOT_MAX_WARPS} warps of "
                         f"{DOT_SLICES} slices hold in registers ({8 * DOT_MAX_WARPS * DOT_SLICES})")
    if not 1 <= warps <= DOT_MAX_WARPS:
        raise ValueError(f"probe_dot: {warps} warps, not in [1, {DOT_MAX_WARPS}]")
    warps = min(DOT_MAX_WARPS, max(warps, -(-slices // DOT_SLICES)))
    lda = k + _DOT_PAD
    smem = 4 * (8 * lda + 8 * k + warps * 64)
    return DotPlan(m // 8, n // 8, slices, warps, -(-slices // warps), lda, smem)


def _require_dot(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"probe_dot: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    cuda_lib.require(a, "a", torch.float32, (m, k), a.device)
    cuda_lib.require(b, "b", torch.float32, (k, n), a.device)
    return m, k, n


def probe_dot(a: torch.Tensor, b: torch.Tensor, steps: int = DOT_STEPS) -> torch.Tensor:
    """``steps * (a @ b)`` for (M, K) @ (K, N) on CUDA tensors, the
    ``steps``-step loop in the kernel on the tensor cores (mma.sync m16n8k8
    TF32, float32 accumulation): kernel ``probe_dot_kernel`` at
    :func:`dot_plan` (a and b contiguous and 16-byte aligned, else
    ValueError); :func:`probe_dot_plain` on CPU tensors.
    ``probe_dot.smem_bytes`` records the dynamic shared memory of the last
    launch."""
    if a.device.type == "cpu":
        return probe_dot_plain(a, b, steps)
    m, k, n = _require_dot(a, b)
    plan = dot_plan(m, k, n)
    require_vec4(a, "a")
    require_vec4(b, "b")
    o = _out((m, n), torch.float32, a)
    _launch("probe_dot", _DOT, a, b, o, m, k, n, int(steps), plan.warps,
            plan.slices_per_warp, plan.lda, plan.smem_bytes)
    probe_dot.launches += 1
    probe_dot.smem_bytes = plan.smem_bytes
    return o


probe_dot.launches = 0
probe_dot.smem_bytes = None


#: every S5 kernel's own wrapper by label (``.launches`` counts its
#: launches): ``<probe>`` the design the probe runs, ``conv_loop`` conv's
#: first design, timed beside it
VARIANTS = {"grid": probe_grid, "acc": probe_acc, "conv": probe_conv,
            "conv_loop": probe_conv_loop, "onehot": probe_onehot, "bdot": probe_bdot,
            "dot": probe_dot}
#: the probes also run where they do real work (:func:`receiver_inputs`)
RECEIVER_PROBES = ("conv", "onehot")


def probe_of(label: str) -> str:
    """The probe (a key of PROBES, LIBRARY) the kernel ``label`` of
    VARIANTS computes."""
    return label.split("_")[0]


def designs(name: str) -> list[str]:
    """The labels of VARIANTS that compute probe ``name``, the kept design
    first."""
    return [label for label in VARIANTS if probe_of(label) == name]


def kernel_of(label: str) -> str:
    """The CUDA kernel that the wrapper of ``label`` launches: bdot runs
    dot's body."""
    return "probe_dot_kernel" if label == "bdot" else f"probe_{label}_kernel"


#: every label's plain version: its probe's
PLAINS = {"grid": probe_grid_plain, "acc": probe_acc_plain, "conv": probe_conv_plain,
          "onehot": probe_onehot_plain, "bdot": probe_bdot_plain, "dot": probe_dot_plain}
PLAINS |= {label: PLAINS[probe_of(label)] for label in VARIANTS if label not in PLAINS}
#: one PyTorch call computing the same function on :func:`library_inputs`
#: (timed beside the kernel, never called by the port)
LIBRARY = {
    "grid": lambda x: x + 1.0,
    "acc": lambda x: x.view(_CLUSTER, _BLOCK_ROWS, _COLS).sum((0, 2))[:, None],
    "conv": lambda x: x.to(torch.float32),
    # columns 0 and 33 take what matches no bin (library_inputs' index)
    "onehot": lambda idx, b: torch.zeros((idx.shape[0], _BINS + 2), dtype=torch.float32,
                                         device=idx.device).scatter_add_(1, idx, b)[:, 1:_BINS + 1],
    "bdot": torch.bmm,
    "dot": lambda a, b, z: torch.addmm(z, a, b, beta=0.0, alpha=DOT_STEPS),
}
#: the probes on the tensor cores: their library calls are timed with TF32
#: allowed (what the kernels compute) and at PyTorch's default precision
TF32_PROBES = ("bdot", "dot")


def library_inputs(name: str, args) -> tuple:
    """The arguments of ``LIBRARY[name]``, made here, outside the call that
    is timed: the probe's inputs; for dot the bias that ``torch.addmm``
    ignores at beta=0; for onehot the index ``h.clamp(-1, 32) + 1`` in
    place of h, so that an h outside the bins lands in column 0 or 33 of
    the scatter's buffer and no index lies outside it (on a CUDA tensor
    an index out of range is a device-side assert, which ends the
    process's CUDA context)."""
    if name == "onehot":
        h, b = args
        return (h.clamp(-1, _BINS) + 1).long(), b
    if name != "dot":
        return tuple(args)
    a, b = args
    return a, b, torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)


@contextlib.contextmanager
def tf32_matmul(allow: bool):
    """``torch.backends.cuda.matmul.allow_tf32`` set to ``allow`` inside,
    restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --- inputs --------------------------------------------------------------------


def script_inputs(device) -> dict:
    """The TPU script's own inputs: ones, arange, tiled arange."""
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "grid": (ones(64, 128),),
        "acc": (ones(64, 128),),
        "conv": (torch.arange(8 * 128, dtype=torch.int32, device=device).reshape(8, 128),),
        "onehot": ((torch.arange(256, dtype=torch.int32, device=device) // 8).repeat(8, 1),
                   ones(8, 256)),
        "bdot": (ones(4, 8, 128), ones(4, 128, 8)),
        "dot": (ones(32, 512), ones(512, 128)),
    }


def seeded_inputs(device, seed: int = SEED) -> dict:
    """The same shapes from a numpy seed: normal float32, full-range int32
    for ``conv`` (rounding above 2^24), one-hot indices in [-4, 36) (bins
    outside [0, 32) match nothing)."""
    rng = np.random.default_rng(seed)
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    return {
        "grid": (f(64, 128),),
        "acc": (f(64, 128),),
        "conv": (torch.from_numpy(rng.integers(-2**31, 2**31, (8, 128)).astype(np.int32))
                 .to(device),),
        "onehot": (torch.from_numpy(rng.integers(-4, 36, (8, 256)).astype(np.int32)).to(device),
                   f(8, 256)),
        "bdot": (f(4, 8, 128), f(4, 128, 8)),
        "dot": (f(32, 512), f(512, 128)),
    }


#: the receiver's geometry at default_config(), the port's own numbers;
#: each names the JAX definition it mirrors (tests/test_torch_scripts.py
#: holds them against it).  _BINS is tables.onehot_width
#: (softgnss_tpu/track/tables.py:109).
RECEIVER_CHANNELS = 8       # config.number_of_channels (softgnss_tpu/config.py:31)
TRACK_TILE = 128            # config.track_tile (softgnss_tpu/config.py:222)
TRACK_PACK = 2              # config.track_pack at track_pack_size = 2 (config.py:346, :382)
N_TILES = 300               # tables.n_tiles, track_window // track_tile (tables.py:119)
SUBDIVISION = 2             # tables.subdivision at the 0.5-chip spacing (tables.py:65)
H_OFFSET = 2                # tables._H_OFFSET, sub-chips of margin below a tile's span (tables.py:62)
FRAME_SHIFT = 7             # tables._frame_shift_subchips (tables.py:82)
CHIPS_PER_SAMPLE = 1.023e6 / 38.192e6   # config.code_freq_basis / config.sampling_freq
#: B2's frames of one block on the port's main path, (track_block_ms, C,
#: track_window // 4) int32 (softgnss_tpu/config.py:229;
#: softgnss_tpu_torch/track/scan.py:311).  The port's window is whole
#: capture words, 38 320 samples (softgnss_tpu_torch/config.py:192); the
#: JAX package rounds its own up to whole tiles, 38 400 (9 600 words,
#: softgnss_tpu/config.py:435).
FRAME_MS = 64
FRAME_WORDS = 9580
#: the one-hot indices of :func:`receiver_inputs`: the tracker's phase
#: ramps, or uniform in [-4, 36) as in seeded_inputs
RECEIVER_CASES = ("receiver", "uniform")


def receiver_inputs(device, seed: int = SEED, case: str = "receiver") -> dict:
    """conv and onehot where they do real work, from a numpy seed.

    ``onehot`` at the JAX receiver's one-hot geometry: ``_correlate_onehot``
    (softgnss_tpu/track/scan.py:199-276) computes ``u = einsum("tkw,ctk->twc",
    onehot(h_local), bb)`` per channel every ms, so one row per (channel,
    plane, tile): RECEIVER_CHANNELS x 2 x N_TILES = 4 800 rows of
    TRACK_TILE lanes into _BINS bins.  Case "receiver": each (channel,
    tile) draws a base index and a phase of lane 0 above it, in [H_OFFSET
    - 1, H_OFFSET + FRAME_SHIFT + 1) sub-chips (the float of the ms start
    inside its frame); lane j's index is ``ceil(base + phase + step * j)``
    with step = TRACK_PACK * SUBDIVISION * CHIPS_PER_SAMPLE (0.107
    sub-chips), made local to the base and clipped to [-1, 32] (scan.py
    :241-264): ~14 bins per row.  Case "uniform": indices uniform in
    [-4, 36) at that shape, sentinels and indices past them included.  In
    both the I and Q planes share the tile's indices.  b: normal float32.

    ``conv`` (case "receiver" only) at B2's frame geometry: full-range
    int32 of shape (FRAME_MS, RECEIVER_CHANNELS, FRAME_WORDS)."""
    if case not in RECEIVER_CASES:
        raise ValueError(f"receiver_inputs: case {case!r}, not one of {RECEIVER_CASES}")
    rng = np.random.default_rng(seed)
    shape = (RECEIVER_CHANNELS, 2, N_TILES, TRACK_TILE)
    b = rng.standard_normal(shape).astype(np.float32)
    tiles = (RECEIVER_CHANNELS, 1, N_TILES, 1)
    if case == "uniform":
        h = rng.integers(-4, 36, tiles[:-1] + (TRACK_TILE,))
    else:
        base = rng.integers(0, 1 << 20, tiles)
        phase = rng.uniform(H_OFFSET - 1, H_OFFSET + FRAME_SHIFT + 1, tiles)
        step = TRACK_PACK * SUBDIVISION * CHIPS_PER_SAMPLE
        h = np.clip(np.ceil(base + phase + step * np.arange(TRACK_TILE)) - base, -1, _BINS)
    h = np.broadcast_to(h, shape)
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1, TRACK_TILE))  # noqa: E731
    out = {"onehot": (rows(h.astype(np.int32)).to(device), rows(b).to(device))}
    if case == "receiver":
        x = rng.integers(-2**31, 2**31, (FRAME_MS, RECEIVER_CHANNELS, FRAME_WORDS))
        out["conv"] = (torch.from_numpy(x.astype(np.int32)).to(device),)
    return out


def input_sets(device) -> dict:
    """{name: inputs} of every set the kernels are held to their plain
    versions on: the script's, seeded, and both receiver cases (conv and
    onehot only)."""
    return {"script": script_inputs(device), "seeded": seeded_inputs(device),
            "receiver": receiver_inputs(device), "receiver-uniform": receiver_inputs(device,
                                                                                     case="uniform")}


def tf32_tolerance(name: str, args) -> torch.Tensor | None:
    """``TF32_REL * sum_k |a_ik b_kj|`` per output of bdot and dot (None
    for the bit-equal probes)."""
    if name not in ("bdot", "dot"):
        return None
    a, b = (t.abs().to(torch.float64) for t in args)
    scale = a @ b
    return TF32_REL * (DOT_STEPS * scale if name == "dot" else scale)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, args, exact: bool) -> float:
    """Raise unless ``got`` equals ``want`` bit for bit (``exact``, or a
    bit-equal probe) or lies within the TF32 tolerance of the probe that
    ``name`` (a label of VARIANTS, or a probe) computes; returns the
    largest absolute difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"S5 {name}: {got.dtype} {tuple(got.shape)}, the plain version's "
                             f"{want.dtype} {tuple(want.shape)}")
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    worst = float(diff.max())
    tol = tf32_tolerance(probe_of(name), args)
    if tol is None or exact:
        if not torch.equal(got, want):
            raise AssertionError(f"S5 {name}: differs from the plain version "
                                 f"(max abs diff {worst:.3e})")
    elif not bool((diff <= tol).all()):
        raise AssertionError(f"S5 {name}: outside the TF32 bound (max abs diff {worst:.3e}, "
                             f"worst ratio to the bound {float((diff / tol).max()):.3f})")
    return worst


def onehot_scale(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_w [h[c, w] == k] |b[c, w]|`` in float64 per output of onehot:
    the scale of a float32 sum-order tolerance."""
    idx, _ = library_inputs("onehot", (h, b))
    return torch.zeros((h.shape[0], _BINS + 2), dtype=torch.float64, device=h.device).scatter_add_(
        1, idx, b.abs().to(torch.float64))[:, 1:_BINS + 1]


def check(device, verbose: bool = False) -> dict:
    """Every kernel of VARIANTS (grid, acc, both designs of conv, onehot,
    bdot and dot) against its own plain version, ``PLAINS[label]``, on
    every set of :func:`input_sets`: bit-equal on the script's inputs (all
    seven); on seeded inputs bit-equal, or within the TF32 bound for bdot
    and dot; the designs of conv and onehot bit-equal at the receiver's
    geometry (onehot in both cases, and at each warp count of
    ONEHOT_WARP_SWEEP).  acc at 2, 3 and ACC_REPS reps, and two launches
    bit-equal to each other (their reductions have a fixed order):
    ``probe_dot_kernel`` as dot and as bdot and acc on seeded inputs, each
    design of conv and onehot at the receiver's geometry.  Raises on the first failure.  Returns {label: largest
    absolute difference}."""
    worst = {}
    sets = input_sets(device)
    for which, inputs in sets.items():
        for label, wrapper in VARIANTS.items():
            name = probe_of(label)
            if name not in inputs:
                continue
            args = inputs[name]
            try:
                got = wrapper(*args)
                err = compare(label, got, PLAINS[label](*args), args, exact=which == "script")
            except (AssertionError, RuntimeError) as exc:
                if verbose:
                    print(f"[FAIL] {label} ({which} inputs): {type(exc).__name__}: {exc}")
                raise
            if verbose:
                print(f"[ok]   {label} ({which} inputs): {got.reshape(-1)[:4].tolist()}, "
                      f"max |kernel - plain| {err:.3e}")
            worst[label] = max(worst.get(label, 0.0), err)
    h, b = sets["receiver"]["onehot"]
    want = probe_onehot_plain(h, b)
    for warps in ONEHOT_WARP_SWEEP:
        compare(f"onehot at {warps} warps per CTA", probe_onehot(h, b, warps=warps), want,
                (h, b), True)
    acc_x = sets["seeded"]["acc"][0]
    for reps in (2, 3, ACC_REPS):
        compare(f"acc at {reps} reps", probe_acc(acc_x, reps), probe_acc_plain(acc_x), (acc_x,),
                True)
    for label in ("dot", "bdot", "acc", *(x for n in RECEIVER_PROBES for x in designs(n))):
        name = probe_of(label)
        args = sets["receiver" if name in RECEIVER_PROBES else "seeded"][name]
        if not torch.equal(VARIANTS[label](*args), VARIANTS[label](*args)):
            raise AssertionError(f"S5 {label}: two launches on the same inputs differ")
    torch.cuda.synchronize(device)
    return worst


def check_library(device) -> dict:
    """Each LIBRARY call against its probe's plain version, as the kernels
    are held: bit-equal on the script's inputs; on seeded inputs bdot and
    dot within the TF32 bound with TF32 allowed; at the receiver's
    geometry conv bit-equal and onehot (a float32 scatter, both cases, the
    sentinels and indices past them included) within 1e-5 of
    :func:`onehot_scale`.  Returns {probe: largest absolute difference}:
    on seeded inputs for bdot and dot, with TF32 allowed and at the
    default precision (the difference shows that the flag took effect);
    at the receiver's geometry for conv and onehot ({case: difference})."""
    out = {}
    for name in PROBES:
        args = script_inputs(device)[name]
        with tf32_matmul(name in TF32_PROBES):
            compare(f"library {name}", LIBRARY[name](*library_inputs(name, args)),
                    PLAINS[name](*args), args, exact=True)
    for name in TF32_PROBES:
        args = seeded_inputs(device)[name]
        want = PLAINS[name](*args)
        for allow in (True, False):
            with tf32_matmul(allow):
                got = LIBRARY[name](*library_inputs(name, args))
            out.setdefault(name, {})["tf32" if allow else "default"] = compare(
                name, got, want, args, exact=False)
    for case in RECEIVER_CASES:
        inputs = receiver_inputs(device, case=case)
        for name, args in inputs.items():
            got = LIBRARY[name](*library_inputs(name, args))
            want = PLAINS[name](*args)
            if name == "conv":
                err = compare(f"library {name}", got, want, args, exact=True)
            else:
                diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
                err = float(diff.max())
                if got.shape != want.shape or not bool((diff <= 1e-5 * onehot_scale(*args)).all()):
                    raise AssertionError(f"S5 library onehot ({case} inputs): outside 1e-5 of "
                                         f"sum |terms| (max abs diff {err:.3e})")
            out.setdefault(name, {})[case] = err
    torch.cuda.synchronize(device)
    return out


def bound(name: str, args) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time an H100 could take for
    ``name`` on ``args``: each input read once, each output written once,
    over 3.35 TB/s; operations over 67 TFLOP/s (float32) or 495 (TF32)."""
    n_in = sum(t.numel() * t.element_size() for t in args)
    if name in ("grid", "conv"):
        return bound_ms(2 * n_in, args[0].numel())
    if name == "acc":
        return bound_ms(n_in + _BLOCK_ROWS * 4, args[0].numel())
    if name == "onehot":
        h = args[0]
        return bound_ms(n_in + h.shape[0] * _BINS * 4, 2 * h.numel() * _BINS)
    a, b = args
    if name == "bdot":
        batch, m, k = a.shape
        n = b.shape[2]
        return bound_ms(n_in + batch * m * n * 4, 2 * batch * m * n * k, TF32_OPS_PER_S)
    m, k = a.shape
    n = b.shape[1]
    return bound_ms(n_in + m * n * 4, 2 * DOT_STEPS * m * n * k, TF32_OPS_PER_S)


def in_turns(fns: dict, timer) -> dict:
    """{key: [time, time]}: ``timer(fn)`` for each ``fn`` of ``fns`` in
    order, then in reverse order."""
    turns = {key: [] for key in fns}
    for key in [*fns, *reversed(fns)]:
        turns[key].append(timer(fns[key]))
    return turns


def _mean(ts) -> float:
    return float(np.mean(ts))


def measure(device, n: int = 200, n_cold: int = 50) -> dict:
    """{label: {...}} for every kernel of VARIANTS.  On the script's own
    inputs: "ms", "ms_turns", "plain_ms", "library_ms", "bound_ms",
    "bound_by" (a probe's designs timed in turns: each, then each in
    reverse order; "ms" is their mean), "library_default_ms" beside
    "library_ms" for bdot and dot (whose "library_ms" is with TF32
    allowed), dot's "ms_steps0" (the launch, the staging and the reduction
    without the loop), bdot's "ms_by_warps" ({warps: ms} at each of
    BDOT_WARP_SWEEP, in turns), and acc's "ms_reps" (ms of one launch at
    ACC_REPS reps) and "step_us", the cost of one rep's handoff of the
    partials to rank 0: (t(ACC_REPS) - t(1)) / (ACC_REPS - 1).

    For conv's designs and onehot also, each in turns with the other
    design and the library call: "ms_cold" and "graph_ms" at the script's
    shape (L2 flushed before each call; the marginal cost of one more call
    inside a CUDA graph, which leaves the launch out), beside
    "library_ms_cold" and "library_graph_ms"; and for each case of
    RECEIVER_CASES that has the probe, under the case's name: "ms",
    "ms_turns", "ms_cold", "ms_cold_turns", "ms_cold_marginal" (flushed,
    back to back: :func:`flushed_marginal_ms`), "plain_ms", "library_ms",
    "library_ms_cold", "library_ms_cold_marginal", "bound_ms", "bound_by"
    at the receiver's geometry.
    onehot's entry and its "receiver" also hold "ms_by_warps" and
    "ms_cold_by_warps" at each of ONEHOT_WARP_SWEEP, in turns."""
    inputs = script_inputs(device)
    warm = lambda fn: cuda_ms(fn, n, busy=True)               # noqa: E731
    cold = lambda fn: cold_ms(fn, n_cold, device)             # noqa: E731
    res = {}
    for name in PROBES:
        args = inputs[name]
        lib, largs = LIBRARY[name], library_inputs(name, args)
        b_ms, b_by = bound(name, args)
        common = {"bound_ms": b_ms, "bound_by": b_by}
        with tf32_matmul(name in TF32_PROBES):
            common["library_ms"] = warm(lambda: lib(*largs))
        if name in TF32_PROBES:
            with tf32_matmul(False):
                common["library_default_ms"] = warm(lambda: lib(*largs))
        labels = designs(name)
        turns = in_turns({label: functools.partial(VARIANTS[label], *args) for label in labels},
                         warm)
        for label in labels:
            res[label] = {"ms": _mean(turns[label]), "ms_turns": turns[label],
                          "plain_ms": cuda_ms(lambda: PLAINS[label](*args), 10), **common}
    a, b = inputs["dot"]
    res["dot"]["ms_steps0"] = warm(lambda: probe_dot(a, b, steps=0))
    a, b = inputs["bdot"]
    sweep = in_turns({w: functools.partial(probe_bdot, a, b, warps=w) for w in BDOT_WARP_SWEEP},
                     warm)
    res["bdot"]["ms_by_warps"] = {w: _mean(t) for w, t in sweep.items()}
    x = inputs["acc"][0]
    r = res["acc"]
    r["ms_reps"] = warm(lambda: probe_acc(x, ACC_REPS))
    r["step_us"] = (r["ms_reps"] - r["ms"]) * 1e3 / (ACC_REPS - 1)

    cases = {case: receiver_inputs(device, case=case) for case in RECEIVER_CASES}
    for name in RECEIVER_PROBES:
        labels = designs(name)

        def fns(args):
            return {**{label: functools.partial(VARIANTS[label], *args) for label in labels},
                    "library": functools.partial(LIBRARY[name], *library_inputs(name, args))}

        script = fns(inputs[name])
        t_cold, t_graph = in_turns(script, cold), in_turns(script, graph_marginal_ms)
        for label in labels:
            res[label].update(ms_cold=_mean(t_cold[label]), graph_ms=_mean(t_graph[label]),
                              library_ms_cold=_mean(t_cold["library"]),
                              library_graph_ms=_mean(t_graph["library"]))
        for case, case_inputs in cases.items():
            if name not in case_inputs:
                continue
            args = case_inputs[name]
            b_ms, b_by = bound(name, args)
            calls = fns(args)
            t_warm, t_cold = in_turns(calls, warm), in_turns(calls, cold)
            t_marg = in_turns(calls, lambda fn: flushed_marginal_ms(fn, n_cold, device))
            for label in labels:
                res[label][case] = {
                    "ms": _mean(t_warm[label]), "ms_turns": t_warm[label],
                    "ms_cold": _mean(t_cold[label]), "ms_cold_turns": t_cold[label],
                    "ms_cold_marginal": _mean(t_marg[label]),
                    "plain_ms": cuda_ms(lambda: PLAINS[label](*args), 5),
                    "library_ms": _mean(t_warm["library"]),
                    "library_ms_cold": _mean(t_cold["library"]),
                    "library_ms_cold_marginal": _mean(t_marg["library"]), "bound_ms": b_ms,
                    "bound_by": b_by}
    for r, (h, b) in ((res["onehot"], inputs["onehot"]),
                      (res["onehot"]["receiver"], cases["receiver"]["onehot"])):
        by_warps = {w: functools.partial(probe_onehot, h, b, warps=w) for w in ONEHOT_WARP_SWEEP}
        r["ms_by_warps"] = {w: _mean(t) for w, t in in_turns(by_warps, warm).items()}
        r["ms_cold_by_warps"] = {w: _mean(t) for w, t in in_turns(by_warps, cold).items()}
    return res


def report(res: dict) -> None:
    us = lambda ms: f"{ms * 1e3:.3f}"   # noqa: E731
    for label in VARIANTS:
        r = res[label]
        lib = f"library {us(r['library_ms'])} us"
        if "library_default_ms" in r:
            lib += f" (TF32 allowed; default precision {us(r['library_default_ms'])} us)"
        turns = ", ".join(us(t) for t in r["ms_turns"])
        print(f"S5 {label:11s}: kernel {us(r['ms'])} us (in turns: {turns}), "
              f"plain {us(r['plain_ms'])} us, {lib}, bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bound_by']}) per launch [{card()}]")
    print(f"S5 dot at steps=0 (launch, staging, reduction; no mma): "
          f"{us(res['dot']['ms_steps0'])} us against {us(res['dot']['ms'])} us at "
          f"{DOT_STEPS} steps [{card()}]")
    by_w = ", ".join(f"{w} warps {us(t)} us" for w, t in res["bdot"]["ms_by_warps"].items())
    print(f"S5 bdot by warps per CTA (in turns; the default is {BDOT_WARPS}): {by_w} [{card()}]")
    r = res["acc"]
    print(f"S5 acc (8-CTA cluster, one-sided st.async push onto rank 0's mbarrier): "
          f"{us(r['ms'])} us at 1 rep, {us(r['ms_reps'])} us at {ACC_REPS} reps: "
          f"{r['step_us']:.4f} us per rep [{card()}]")
    for name in RECEIVER_PROBES:
        for label in designs(name):
            r = res[label]
            print(f"S5 {label:11s} at the script's shape: L2 flushed {us(r['ms_cold'])} us, "
                  f"in a CUDA graph {us(r['graph_ms'])} us per call (library flushed "
                  f"{us(r['library_ms_cold'])}, graph {us(r['library_graph_ms'])}) [{card()}]")
            for case in RECEIVER_CASES:
                if case not in r:
                    continue
                c = r[case]
                print(f"S5 {label:11s} at the receiver's geometry ({case} inputs): L2 flushed "
                      f"{us(c['ms_cold'])} us (in turns: "
                      f"{', '.join(us(t) for t in c['ms_cold_turns'])}; back to back "
                      f"{us(c['ms_cold_marginal'])}), warm {us(c['ms'])} us "
                      f"(in turns: {', '.join(us(t) for t in c['ms_turns'])}), bound "
                      f"{us(c['bound_ms'])} us ({c['bound_by']}): "
                      f"{c['bound_ms'] / c['ms_cold']:.3f} of it flushed; plain "
                      f"{us(c['plain_ms'])} us; library flushed {us(c['library_ms_cold'])} us "
                      f"(back to back {us(c['library_ms_cold_marginal'])}), warm "
                      f"{us(c['library_ms'])} us [{card()}]")
    for where, r in (("the script's shape", res["onehot"]),
                     ("the receiver's geometry", res["onehot"]["receiver"])):
        by_w = ", ".join(f"{w} warps {us(r['ms_cold_by_warps'][w])} / {us(t)} us"
                         for w, t in r["ms_by_warps"].items())
        print(f"S5 onehot at {where} by warps per CTA (in turns, flushed / warm; the default "
              f"is {ONEHOT_WARPS}): {by_w} [{card()}]")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def resources(log: str) -> dict:
    """{mangled kernel name: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}} from nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            cur = out.setdefault(m.group(1), {"registers": 0, "smem": 0, "stack": 0,
                                              "spill_stores": 0, "spill_loads": 0})
        elif cur is not None and (m := _PTXAS_STACK.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _PTXAS_USED.search(line)):
            smem = _PTXAS_SMEM.search(line)
            cur.update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    return out


def probe_resources(log: str) -> dict:
    """{label: resources} of the kernel of every S5 label of VARIANTS
    (:func:`kernel_of`: bdot's is dot's), found by its exact name: the
    length-prefixed identifier in the mangled name, so that
    ``probe_dot_kernel`` never matches a kernel whose name only begins
    with it."""
    res = resources(log)
    out = {}
    for label in VARIANTS:
        kernel = kernel_of(label)
        found = [v for k, v in res.items() if f"{len(kernel)}{kernel}" in k]
        if len(found) != 1:
            raise KeyError(f"{kernel}: {len(found)} entries in the ptxas log")
        out[label] = found[0]
    return out


def main() -> int:
    device = require_cuda()
    print(card())
    lib = PROBE_LIBRARY.load()
    for label, r in probe_resources(lib.log).items():
        print(f"S5 {label:11s}: {r['registers']} registers, {r['smem']} B static shared, "
              f"{r['stack']} B stack, spills {r['spill_stores']} B stored / "
              f"{r['spill_loads']} B loaded")
    worst = check(device, verbose=True)
    print(f"worst |kernel - plain|: {worst}")
    print(f"S5 dot      : launched with {probe_dot.smem_bytes} B dynamic shared per CTA at "
          f"(32, 512) @ (512, 128); bdot with {probe_bdot.smem_bytes} B at (4, 8, 128) @ "
          f"(4, 128, 8); onehot with {probe_onehot.smem_bytes} B at the last warp count checked "
          f"({ONEHOT_WARP_SWEEP[-1]})")
    print(f"worst |library - plain| (seeded inputs; the receiver's geometry): "
          f"{check_library(device)}")
    report(measure(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
