"""Block-sparse HCGS layouts, the v3 block-sparse projection, the
block-sparse weight gradient and the legacy v1/v2 block-sparse matmul
(port of ``pytorch_kaldi_cgs_tpu/ops/block_sparse.py``: its host side and
its nine kernels).

HCGS keeps the same number R of level-1 blocks in every block row of a
mask, so the kept blocks of an (N, K) weight pack row-major into the
"w3" layout ``(Nb, bs, R*bs)`` (one out-block per slice, its R kept
column blocks side by side); G weights that share one mask stack along
the middle axis into ``(Nb, G*bs, R*bs)``. :class:`BlockLayout` holds the
static index structure, in numpy with the JAX package's field values.

Three TPU kernels become CUDA kernels for ``sm_90a``:

- ``_make_fwd_v3`` (``ops/block_sparse.py:656``): ``csrc/block_sparse_v3.cu``,
  :func:`block_sparse_v3_fwd` / :func:`block_sparse_v3_fwd_plain`:
  ``ys[g] = x @ w_eff_g.T`` over the kept blocks only;
- ``_make_dx_v3`` (``:744``): ``csrc/block_sparse_v3.cu``,
  :func:`block_sparse_v3_dx` / :func:`block_sparse_v3_dx_plain`;
- ``_make_dw_v3`` (``:856``): ``csrc/block_sparse_dw.cu``,
  :func:`block_sparse_dw` / :func:`block_sparse_dw_plain`, with the
  optional level-2 submask epilogue (``sub3``). It is the dw of the v3
  projection and the ``dU`` of the sparse fused recurrences
  (``ops.fused_lstm.sparse_dU``).

The forward and the dw run on one register-blocked float32 GEMM tile
(``csrc/bs_gemm.cuh``: 128 x 128 outputs a block, cp.async-staged
slabs); :func:`dw_plan` splits the dw's M where its grid is small, and
:func:`gemm_vec` picks the 16-byte-load instantiation.

Six more, the legacy API over packed (nnz, G*bs, bs) blocks (v1 is
G=1), become the three kernels of ``csrc/block_sparse_legacy.cu``, each
taken at G=1 and at G>1, float32 or bfloat16 operands, float32 sums:

- ``_make_fwd`` (``:198``) / ``_make_fwd_multi`` (``:380``):
  :func:`bsl_fwd` / :func:`bsl_fwd_multi`, twin :func:`bsl_fwd_plain`;
  the route is chosen up front (:func:`legacy_fwd_route`): float32 x
  runs the v3 forward's GEMM over the packed weight transposed once into
  float32 scratch, bf16 x and w the K-major tensor-core tile of
  ``csrc/bs_mma.cuh`` (``fwd_mma``), both in ``csrc/block_sparse_v3.cu``;
  bf16 x with float32 w keeps the legacy file's own forward;
- ``_make_dx`` (``:248``) / ``_make_dx_multi`` (``:439``): :func:`bsl_dx`
  / :func:`bsl_dx_multi`, twin :func:`bsl_dx_plain`; the route is chosen
  up front (:func:`legacy_dx_route`): float32 operands run the float32
  tile, bf16 ones a tensor-core tile with gy K-major and w MN-major
  (``dx_mma``), both in ``csrc/block_sparse_dx.cu`` over the work items
  of :func:`dx_plan`, which balances the layout's uneven columns; mixed
  pairs keep the legacy file's own dx;
- ``_make_dw`` (``:294``) / ``_make_dw_multi`` (``:487``): :func:`bsl_dw`
  / :func:`bsl_dw_multi`, twin :func:`bsl_dw_plain`; the route is chosen
  up front (:func:`legacy_dw_route`): float32 operands run the dw
  kernel's float32 tile with a packed-layout epilogue, bf16 ones the
  tensor-core tile of ``csrc/bs_mma.cuh`` (``dw_mma``), both in
  ``csrc/block_sparse_dw.cu`` with M split as :func:`dw_plan` says; mixed
  pairs keep the legacy file's own dw;

behind :func:`block_sparse_matmul` and :func:`block_sparse_matmul_multi`
(the JAX custom VJPs); :func:`block_sparse_matmul_xla` is the plain
reference. No model calls them.

The effective weight of the v3 pair is ``ceil_quant(w3) * sub3`` (the
8-bit weight quantizer and the level-2 submask applied to each weight
as the kernel reads it); :func:`block_sparse_matmul_v3` is the
differentiable entry point, the JAX package's ``block_sparse_matmul_v3``
custom VJP (straight-through quantizer, dw times the submask).

A wrapper launches its kernel on a CUDA tensor (or raises) and runs its
twin on a CPU tensor; its attribute ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# layout packing (host side, static per mask)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)   # identity hash: reuse layout objects
class BlockLayout:
    """Static index structure of one HCGS mask at block size ``bs``.

    For w of shape (N, K) with Nb x Kb block grid and R kept blocks per
    block-row:
      col_idx[j*R + k]  : in-block column of the k-th kept block of row j
      (transposed, padded to C = max blocks per column, with one zero
       block appended at packed position nnz)
      t_row_idx[c*C + k]: out-block row of the k-th block in column c
      t_perm[c*C + k]   : its packed position (nnz => pad, no block)
    """
    N: int
    K: int
    bs: int
    R: int
    C: int
    nnz: int
    col_idx: np.ndarray      # (Nb*R,) int32
    t_row_idx: np.ndarray    # (Kb*C,) int32
    t_perm: np.ndarray       # (Kb*C,) int32
    rows: np.ndarray         # (nnz,) out-block row per packed block
    cols: np.ndarray         # (nnz,) in-block col per packed block
    K_orig: int = 0          # pre-padding K (0 => K, no padding)

    @property
    def k_true(self) -> int:
        return self.K_orig or self.K

    @property
    def Nb(self) -> int:
        return self.N // self.bs

    @property
    def Kb(self) -> int:
        return self.K // self.bs

    def density(self) -> float:
        return self.nnz / (self.Nb * self.Kb)

    def device_index(self, name: str, device) -> torch.Tensor:
        """``col_idx`` / ``t_row_idx`` / ``t_perm`` as an int32 tensor on
        ``device``, made once per device."""
        cache = self.__dict__.setdefault("_dev_idx", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name), dtype=torch.int32,
                                         device=device)
        return cache[key]


def pack_layout(mask: np.ndarray, bs: int,
                pad_k: bool = False) -> BlockLayout:
    """Build the BlockLayout from a 0/1 mask (N, K). Requires equal kept
    count per block-row (guaranteed by HCGS generation).

    pad_k=True zero-pads the mask's column dim to the next multiple of
    ``bs`` (e.g. the 143-wide fMLLR input): ``layout.K`` becomes the
    padded width and ``layout.K_orig`` keeps the true one."""
    N, K = mask.shape
    K_orig = K
    if pad_k and K % bs:
        mask = np.concatenate(
            [np.asarray(mask), np.zeros((N, bs - K % bs), mask.dtype)],
            axis=1)
        K = mask.shape[1]
    if N % bs or K % bs:
        raise ValueError("mask %s not divisible by block %d" % (mask.shape, bs))
    Nb, Kb = N // bs, K // bs
    occ = mask.reshape(Nb, bs, Kb, bs).transpose(0, 2, 1, 3).any(axis=(2, 3))
    counts = occ.sum(axis=1)
    R = int(counts.max()) if counts.size else 0
    if not np.all(counts == R):
        raise ValueError("HCGS layout requires equal kept blocks per row, "
                         "got %s" % np.unique(counts))
    col_idx = np.zeros(Nb * R, np.int32)
    for j in range(Nb):
        col_idx[j * R:(j + 1) * R] = np.where(occ[j])[0]
    rows = np.repeat(np.arange(Nb, dtype=np.int32), R)
    cols = col_idx.copy()
    nnz = Nb * R
    # transposed (per in-block column) with padding
    percol = [[] for _ in range(Kb)]
    for p in range(nnz):
        percol[cols[p]].append(p)
    C = max(max((len(v) for v in percol), default=0), 1)
    t_row_idx = np.zeros(Kb * C, np.int32)
    t_perm = np.full(Kb * C, nnz, np.int32)  # nnz => pad
    for c in range(Kb):
        for k, p in enumerate(percol[c]):
            t_row_idx[c * C + k] = rows[p]
            t_perm[c * C + k] = p
    return BlockLayout(N=N, K=K, bs=bs, R=R, C=C, nnz=nnz, col_idx=col_idx,
                       t_row_idx=t_row_idx, t_perm=t_perm, rows=rows,
                       cols=cols, K_orig=K_orig if K_orig != K else 0)


def pack_blocks(w: np.ndarray, layout: BlockLayout) -> np.ndarray:
    """Gather dense (N, K) into packed (nnz, bs, bs). A K-padded layout
    accepts the original-width w and zero-pads the tail block columns."""
    w = np.asarray(w)
    if w.shape[1] < layout.K:
        w = np.concatenate(
            [w, np.zeros((w.shape[0], layout.K - w.shape[1]), w.dtype)],
            axis=1)
    bs = layout.bs
    out = np.zeros((layout.nnz, bs, bs), w.dtype)
    for p in range(layout.nnz):
        r, c = layout.rows[p], layout.cols[p]
        out[p] = w[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs]
    return out


def unpack_blocks(w_packed: np.ndarray, layout: BlockLayout) -> np.ndarray:
    bs = layout.bs
    out = np.zeros((layout.N, layout.K), np.asarray(w_packed).dtype)
    for p in range(layout.nnz):
        r, c = layout.rows[p], layout.cols[p]
        out[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = w_packed[p]
    return out[:, :layout.k_true]


def pack_w3(w: np.ndarray, layout: BlockLayout) -> np.ndarray:
    """Dense (N, K) -> packed (Nb, bs, R*bs) (host side, numpy)."""
    blocks = pack_blocks(np.asarray(w), layout)            # (nnz, bs, bs)
    return blocks.reshape(layout.Nb, layout.R, layout.bs, layout.bs) \
        .transpose(0, 2, 1, 3) \
        .reshape(layout.Nb, layout.bs, layout.R * layout.bs)


def unpack_w3(w3: np.ndarray, layout: BlockLayout) -> np.ndarray:
    """Packed (Nb, bs, R*bs) -> dense (N, K) with dropped blocks zero."""
    blocks = np.asarray(w3).reshape(layout.Nb, layout.bs, layout.R,
                                    layout.bs).transpose(0, 2, 1, 3) \
        .reshape(layout.nnz, layout.bs, layout.bs)
    return unpack_blocks(blocks, layout)


def stack_w3_gates(gate_w3s) -> np.ndarray:
    """Per-gate packed (Nb, bs, R*bs) -> the kernels' (Nb, G*bs, R*bs)."""
    return np.concatenate([np.asarray(w) for w in gate_w3s], axis=1)


# ---------------------------------------------------------------------------
# differentiable gathers (torch)
# ---------------------------------------------------------------------------

def gather_blocks_multi(ws: Sequence[torch.Tensor],
                        layout: BlockLayout) -> torch.Tensor:
    """Kept blocks of G dense (N, K) weights -> (nnz, G*bs, bs); the
    gradient scatters back into the dense weights."""
    bs = layout.bs
    rows = torch.as_tensor(layout.rows, dtype=torch.long, device=ws[0].device)
    cols = torch.as_tensor(layout.cols, dtype=torch.long, device=ws[0].device)
    parts = [w.reshape(layout.Nb, bs, layout.Kb, bs).permute(0, 2, 1, 3)
             [rows, cols] for w in ws]                      # (nnz, bs, bs)
    return torch.cat(parts, dim=1)


def v3_from_blocks(blocks: torch.Tensor, layout: BlockLayout,
                   G: int) -> torch.Tensor:
    """Packed (nnz, G*bs, bs) blocks -> the w3 kernel layout
    (Nb, G*bs, R*bs), differentiable (the JAX package's ``w3`` half;
    its column-oriented ``w3csc`` copy is read by no kernel)."""
    bs = layout.bs
    return blocks.reshape(layout.Nb, layout.R, G * bs, bs) \
        .permute(0, 2, 1, 3).reshape(layout.Nb, G * bs, layout.R * bs)


def pad_cols(x: torch.Tensor, K: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x`` to ``K`` (a K-padded layout),
    differentiably; ``x`` itself when already that wide."""
    if x.shape[-1] == K:
        return x
    return torch.nn.functional.pad(x, (0, K - x.shape[-1]))


def gather_w3(ws: Sequence[torch.Tensor], layout: BlockLayout
              ) -> torch.Tensor:
    """G dense (N, K_true) weights -> their kept blocks in the w3 layout
    (Nb, G*bs, R*bs), differentiable (the JAX package's ``gather_v3``,
    its ``w3`` half): the gradient scatters back into the dense weights,
    zero on the dropped blocks."""
    return v3_from_blocks(gather_blocks_multi(
        [pad_cols(w, layout.K) for w in ws], layout), layout, len(ws))


# ---------------------------------------------------------------------------
# the block-sparse weight gradient (TPU kernel _make_dw_v3)
# ---------------------------------------------------------------------------

def gather_cols(x: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """x (M, K) -> (Nb, M, R*bs): per out-block j, its R kept column
    blocks ``x[:, col_idx[j*R + k]*bs : +bs]`` side by side."""
    M, bs = x.shape[0], layout.bs
    idx = torch.as_tensor(layout.col_idx, dtype=torch.long, device=x.device)
    xg = x.reshape(M, layout.Kb, bs)[:, idx]               # (M, Nb*R, bs)
    return xg.reshape(M, layout.Nb, layout.R * bs).transpose(0, 1)


def block_sparse_dw_plain(dg_flat: torch.Tensor, x: torch.Tensor,
                          layout: BlockLayout, G: int,
                          sub3: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's plain twin: gather the R kept column blocks of x per
    out-block, then one batched matmul over M."""
    M = x.shape[0]
    dgb = dg_flat.reshape(M, layout.Nb, G * layout.bs).permute(1, 2, 0)
    dw = torch.matmul(dgb, gather_cols(x, layout))       # (Nb, G*bs, R*bs)
    return dw * sub3 if sub3 is not None else dw


@dataclass(frozen=True)
class GemmGrid:
    """What the dw kernel's split plan needs of the card and of a GEMM
    tile (csrc/bs_gemm.cuh's float32 one, csrc/bs_mma.cuh's bf16
    tensor-core one): the card's SMs, the tile's output rows and columns
    (TILE), its contraction rows per staged slab (BK), the blocks
    resident on an SM (MIN_BLOCKS of __launch_bounds__) and the cost of a
    last round in which the busiest SM holds fewer blocks than that, as
    a share of a full round (``PARTIAL_ROUND``)."""
    sms: int
    tile: int
    bk: int
    blocks_per_sm: int
    partial_round: float = 1.0


# the built library that reports each tile's constants
_TILE_LIBRARY = {"bs_gemm": "block_sparse_dw", "bs_mma": "block_sparse_dw",
                 "dx_mma": "block_sparse_dx"}


@functools.lru_cache(maxsize=None)
def _gemm_grid(index: int, tile_name: str) -> GemmGrid:
    from . import _build
    fn = getattr(_build.load(_TILE_LIBRARY[tile_name]), tile_name + "_config")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    tile = (ctypes.c_int * 3)()
    fn(tile)
    return GemmGrid(
        torch.cuda.get_device_properties(index).multi_processor_count, *tile,
        PARTIAL_ROUND.get(tile_name, 1.0))


def gemm_grid(dev, tile_name: str = "bs_gemm") -> GemmGrid:
    """The GemmGrid of CUDA device ``dev``: the tile ``tile_name``
    ("bs_gemm", the float32 tile, "bs_mma", the dw's bf16 one, or
    "dx_mma", the legacy dx's bf16 one) as the built library reports it
    (``<tile_name>_config``), the SM count as the device does."""
    dev = torch.device(dev)
    return _gemm_grid(torch.cuda.current_device() if dev.index is None
                      else dev.index, tile_name)


# the fewest rows of M one split of the dw kernel walks
DW_SPLIT_MIN_ROWS = 128
# a dw block's fixed cost in staged slabs: the pipeline's fill (the
# tile's three slabs in flight) and its epilogue. Counted from the design,
# not fitted to a measurement; with it the plan keeps one split where the
# tiles fill whole rounds of slots
DW_BLOCK_OVERHEAD_SLABS = 3
# GemmGrid.partial_round of each tile dw_plan reads. The float32 tile
# charges a full round: the model its plans (row 15's among them) were
# made and measured with. The bf16 tile's share is measured: on the H100
# one dw_mma block alone on its SM takes 0.50 of the time of two
# co-resident ones over the same rows (dw_split_sweep.py). dx_plan reads
# none (dx_mma's grid keeps 1.0)
PARTIAL_ROUND = {"bs_gemm": 1.0, "bs_mma": 0.50}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def dw_plan(M: int, Nb: int, G: int, R: int, bs: int, grid: GemmGrid):
    """The dw kernel's grid, from the shape and ``grid`` (:func:`gemm_grid`
    on the card): -> (tiles, splits, rows). ``tiles`` counts its tile x
    tile output tiles over the Nb (G*bs, R*bs) slices; M is cut into
    ``splits`` parts of ``rows`` rows (a multiple of grid.bk; the last
    part may be shorter), each at least DW_SPLIT_MIN_ROWS. The split
    minimises the modelled time: the blocks the busiest SM runs
    (tiles x splits over the SMs, rounded up) in rounds of
    blocks_per_sm, a last round with fewer blocks charged
    grid.partial_round of a full one, times the rows a block walks plus
    its fixed cost (DW_BLOCK_OVERHEAD_SLABS slabs). With partial_round 1
    (the float32 tile) that is the rounds of the resident slots (sms x
    blocks_per_sm) that tiles x splits blocks take. Small grids (the
    LibriSpeech GRU's dU: 16 tiles on the H100's 264 slots) split into
    about one full round; a grid that fills whole rounds keeps one
    split."""
    tiles = Nb * _cdiv(G * bs, grid.tile) * _cdiv(R * bs, grid.tile)
    overhead = DW_BLOCK_OVERHEAD_SLABS * grid.bk
    best = None
    for want in range(1, max(1, M // DW_SPLIT_MIN_ROWS) + 1):
        rows = _cdiv(_cdiv(max(M, 1), want), grid.bk) * grid.bk
        splits = _cdiv(max(M, 1), rows)
        full, part = divmod(_cdiv(tiles * splits, grid.sms),
                            grid.blocks_per_sm)
        cost = (full + (grid.partial_round if part else 0)) * (
            rows + overhead)
        if best is None or cost < best[0]:
            best = (cost, splits, rows)
    return tiles, best[1], best[2]


def gemm_vec(bs: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether the GEMM kernels take their 16-byte-load instantiation:
    bs a multiple of 4 (a float4 of columns then lies inside one kept
    block and one gate) and every operand 16-byte aligned; else the
    scalar-load one."""
    return bs % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0
                               for t in tensors)


def _dw_split(M, layout, G, dev, tile_name="bs_gemm"):
    """The dw's split of M on device ``dev`` (:func:`dw_plan` over the
    tile ``tile_name``) and its float32 partials' scratch: -> (splits,
    rows, scratch or None)."""
    _, splits, rows = dw_plan(M, layout.Nb, G, layout.R, layout.bs,
                              gemm_grid(dev, tile_name))
    part = None if splits == 1 else torch.empty(
        (splits,) + _w3_shape(layout, G), dtype=torch.float32, device=dev)
    return splits, rows, part


@functools.lru_cache(maxsize=None)
def _lib_fn(lib_name: str, name: str, n_ptrs: int, n_ints: int,
            n_floats: int = 0):
    """The launcher ``name`` of the built library ``lib_name``, its
    argument types set once: ``n_ptrs`` pointers, ``n_ints`` ints,
    ``n_floats`` floats and the stream; it returns a cudaError_t. ->
    (library, function)."""
    from . import _build
    lib = _build.load(lib_name)
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _raw_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream: PyTorch's raw
    getter (the one Triton's launcher calls), which builds no Stream
    object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(lib_name: str, name: str, dev, ptrs, ints, floats=()) -> None:
    """Call the launcher ``name`` of ``lib_name`` with ``ptrs``, ``ints``,
    ``floats`` and the current stream of device ``dev``, that device
    current (a device guard only where another one is); a failed launch
    raises (:func:`_build.check`). A call's host path: the argument types
    are set once (:func:`_lib_fn`), and neither a device context nor a
    Stream object is built where ``dev`` is current (``chip_smoke.py
    --gemm-times`` times each piece: ``host_path_us``)."""
    from . import _build
    lib, fn = _lib_fn(lib_name, name, len(ptrs), len(ints), len(floats))
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        rc = fn(*ptrs, *ints, *floats, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*ptrs, *ints, *floats, _raw_stream(index))
    _build.check(lib, rc, name)


def _dw_kernel(dg_flat, x, layout, G, sub3):
    M, dev = x.shape[0], x.device
    splits, rows, part = _dw_split(M, layout, G, dev)
    out = torch.empty(_w3_shape(layout, G), dtype=torch.float32, device=dev)
    _launch("block_sparse_dw", "block_sparse_dw", dev, (
        dg_flat.data_ptr(), x.data_ptr(),
        layout.device_index("col_idx", dev).data_ptr(),
        None if sub3 is None else sub3.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr()), (
        M, layout.K, layout.Nb, layout.R, layout.bs, G, splits, rows,
        int(gemm_vec(layout.bs, dg_flat, x, sub3))))
    block_sparse_dw.launches += 1
    return out


def block_sparse_dw(dg_flat: torch.Tensor, x: torch.Tensor,
                    layout: BlockLayout, G: int,
                    sub3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dw3g[j] = dg_flat[:, j*G*bs:(j+1)*G*bs].T @ concat_k x[:,
    col_idx[j*R+k]*bs : +bs]`` -> (Nb, G*bs, R*bs) float32, times the
    level-2 submask ``sub3`` (same layout) when given.

    ``dg_flat`` (M, Nb*G*bs): per out-block j, its G gates' bs-wide
    slices side by side; ``x`` (M, K). Float32, contiguous. CUDA tensors
    run the kernel (float32 FMAs, no TF32; M split as :func:`dw_plan`
    says, the partials summed in a fixed order by a second launch, so two
    calls give the same bits), CPU tensors the twin; ``launches`` counts
    calls."""
    M = x.shape[0]
    if _check_operands(dg_flat, (("dg_flat", dg_flat,
                                  (M, _flat_width(layout, G))),
                           ("x", x, (M, layout.K)),
                           ("sub3", sub3, _w3_shape(layout, G)))):
        return block_sparse_dw_plain(dg_flat, x, layout, G, sub3)
    return _dw_kernel(dg_flat, x, layout, G, sub3)


block_sparse_dw.launches = 0


def _w3_shape(layout: BlockLayout, G: int):
    return (layout.Nb, G * layout.bs, layout.R * layout.bs)


def _flat_width(layout: BlockLayout, G: int) -> int:
    """Columns of a flat cotangent: per out-block, its G gates' slices."""
    return layout.Nb * G * layout.bs


def _check_operands(lead: torch.Tensor, shapes,
                    dtypes=(torch.float32,)) -> bool:
    """Shapes, dtype (one of ``dtypes``), one device and (on the card)
    contiguity of a wrapper's operands ((name, tensor or None, shape)
    each). -> True for the CPU (run the twin), False for a CUDA device
    (launch)."""
    for name, t, shape in shapes:
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError("%s must be %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if t.dtype not in dtypes:
            raise ValueError("%s must be %s, got %s" % (
                name, " or ".join(str(d).split(".")[-1] for d in dtypes),
                t.dtype))
        if t.device != lead.device:
            raise ValueError("%s on %s, %s on %s" % (
                name, t.device, shapes[0][0], lead.device))
        if lead.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if lead.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % lead.device)
    return lead.device.type == "cpu"


# ---------------------------------------------------------------------------
# the v3 projection (TPU kernels _make_fwd_v3 and _make_dx_v3)
# ---------------------------------------------------------------------------

def ceil_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernels' weight quantizer (the JAX package's ``_ceil_quant``,
    equal to ``sparsity.quantize.quantize_weight``): clip to [-1, 1],
    ceil the magnitude to 2^(bits-1) levels, sign restored."""
    scale = 2.0 ** (bits - 1)
    w = torch.clamp(w, -1.0, 1.0)
    return torch.sign(w) * (torch.ceil(torch.abs(w) * scale) / scale)


def v3_weight(w3: torch.Tensor, qbits: int = 0,
              sub3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The effective weight both v3 kernels contract against:
    ``ceil_quant(w3, qbits) * sub3`` (either step skipped when off)."""
    w = ceil_quant(w3, qbits) if qbits else w3
    return w * sub3 if sub3 is not None else w


def block_sparse_v3_fwd_plain(x: torch.Tensor, w3: torch.Tensor,
                              layout: BlockLayout, G: int, qbits: int = 0,
                              sub3: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Twin of the v3 forward kernel: gather the R kept column blocks of
    x per out-block, one batched matmul against the effective weight,
    the G gates' output planes apart. -> (G, M, N)."""
    M, bs, Nb = x.shape[0], layout.bs, layout.Nb
    ys = torch.bmm(gather_cols(x, layout),
                   v3_weight(w3, qbits, sub3).transpose(1, 2))
    return ys.reshape(Nb, M, G, bs).permute(2, 1, 0, 3).reshape(G, M, layout.N)


def block_sparse_v3_dx_plain(gy_flat: torch.Tensor, w3: torch.Tensor,
                             layout: BlockLayout, G: int, qbits: int = 0,
                             sub3: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Twin of the v3 dx kernel: per out-block j, ``gy_j @ w_eff[j]``
    (M, R*bs), each kept block's slice added into its column block;
    column blocks no row keeps stay zero. -> (M, K)."""
    M, bs, Nb, R = gy_flat.shape[0], layout.bs, layout.Nb, layout.R
    gyb = gy_flat.reshape(M, Nb, G * bs).transpose(0, 1)      # (Nb, M, G*bs)
    part = torch.bmm(gyb, v3_weight(w3, qbits, sub3))         # (Nb, M, R*bs)
    parts = part.reshape(Nb, M, R, bs).transpose(0, 1).reshape(M, -1, bs)
    idx = torch.as_tensor(layout.col_idx, dtype=torch.long,
                          device=gy_flat.device)
    dx = gy_flat.new_zeros((M, layout.Kb, bs)).index_add_(1, idx, parts)
    return dx.reshape(M, layout.K)


def v3_weight_packed_plain(w3: torch.Tensor, layout: BlockLayout, G: int,
                           qbits: int = 0,
                           sub3: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Twin of the v3 dx's weight pass (``v3_weight_packed`` of
    csrc/block_sparse_dx.cu): the effective weight (:func:`v3_weight`) in
    the legacy packed layout, ``wp[j*R + k][n][c] = w_eff[j][n][k*bs +
    c]``. -> (nnz, G*bs, bs)."""
    bs = layout.bs
    return v3_weight(w3, qbits, sub3).reshape(
        layout.Nb, G * bs, layout.R, bs).permute(0, 2, 1, 3).reshape(
            layout.nnz, G * bs, bs)


def _qscale(qbits: int) -> float:
    return 2.0 ** (qbits - 1) if qbits else 0.0


def block_sparse_v3_fwd(x: torch.Tensor, w3: torch.Tensor,
                        layout: BlockLayout, G: int, qbits: int = 0,
                        sub3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The v3 forward (TPU kernel ``_make_fwd_v3``): ``ys[g][:, j*bs:
    (j+1)*bs] = concat_k x[:, col_idx[j*R+k]*bs : +bs] @ w_eff[j, g*bs:
    (g+1)*bs].T`` with ``w_eff = ceil_quant(w3, qbits) * sub3``.

    ``x`` (M, K) of a K-padded layout's padded width, ``w3`` and ``sub3``
    (Nb, G*bs, R*bs), float32. -> (G, M, N) float32. CUDA tensors run the
    kernel (float32 FMAs, no TF32: two launches, the effective weight
    written once into scratch, then the GEMM; ``launches`` counts calls),
    CPU tensors the twin; no autograd (:func:`block_sparse_matmul_v3`
    carries the backward)."""
    M = x.shape[0]
    if _check_operands(x, (("x", x, (M, layout.K)),
                           ("w3", w3, _w3_shape(layout, G)),
                           ("sub3", sub3, _w3_shape(layout, G)))):
        return block_sparse_v3_fwd_plain(x, w3, layout, G, qbits, sub3)
    ys = torch.empty((G, M, layout.N), dtype=torch.float32, device=x.device)
    wt = torch.empty((layout.Nb, layout.R * layout.bs, G * layout.bs),
                     dtype=torch.float32, device=x.device)
    _launch("block_sparse_v3", "block_sparse_v3_fwd", x.device, (
        x.data_ptr(), w3.data_ptr(),
        layout.device_index("col_idx", x.device).data_ptr(), wt.data_ptr(),
        None if sub3 is None else sub3.data_ptr(), ys.data_ptr()), (
        M, layout.K, layout.N, layout.Nb, layout.R, layout.bs, G,
        int(gemm_vec(layout.bs, x))), (_qscale(qbits),))
    block_sparse_v3_fwd.launches += 1
    return ys


block_sparse_v3_fwd.launches = 0


def block_sparse_v3_dx(gy_flat: torch.Tensor, w3: torch.Tensor,
                       layout: BlockLayout, G: int, qbits: int = 0,
                       sub3: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The v3 input gradient (TPU kernel ``_make_dx_v3``): ``gy_flat``
    (M, Nb*G*bs), per out-block its G gates' bs-wide cotangent slices
    side by side, against the forward's effective weight. -> dx (M, K)
    float32 (K the layout's padded width). CUDA tensors run the kernels
    (float32 FMAs, no TF32): ``v3_weight_packed`` writes the effective
    weight once into scratch in the legacy packed layout, then the legacy
    dx's float32 tile (``dx_gemm`` of csrc/block_sparse_dx.cu, its 16-byte
    loads as :func:`gemm_vec` says) runs the work items of
    :func:`dx_plan`, ``dx_reduce`` summing a split column's parts: two or
    three device kernels; ``launches`` counts calls. CPU tensors run the
    twin."""
    M = gy_flat.shape[0]
    if _check_operands(gy_flat, (
            ("gy_flat", gy_flat, (M, _flat_width(layout, G))),
            ("w3", w3, _w3_shape(layout, G)),
            ("sub3", sub3, _w3_shape(layout, G)))):
        return block_sparse_v3_dx_plain(gy_flat, w3, layout, G, qbits, sub3)
    dev, bs = gy_flat.device, layout.bs
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((M, layout.K), **f32)
    wp = torch.empty((layout.nnz, G * bs, bs), **f32)
    plan, table = _dx_work(layout, M, G, "gemm", dev)
    part = torch.empty((plan.parts, M, bs), **f32) if plan.parts else None
    n_items = len(plan.items)
    _launch("block_sparse_dx", "block_sparse_v3_dx", dev, (
        gy_flat.data_ptr(), w3.data_ptr(),
        None if sub3 is None else sub3.data_ptr(), wp.data_ptr(),
        layout.device_index("t_row_idx", dev).data_ptr(),
        layout.device_index("t_perm", dev).data_ptr(), table.data_ptr(),
        table.data_ptr() + 16 * n_items, dx.data_ptr(),
        None if part is None else part.data_ptr()), (
        M, layout.K, layout.Nb, layout.R, bs, G, layout.C, n_items,
        len(plan.reduce), int(gemm_vec(bs, gy_flat, wp))), (_qscale(qbits),))
    block_sparse_v3_dx.launches += 1
    return dx


block_sparse_v3_dx.launches = 0


def flatten_cotangent(gy: torch.Tensor, layout: BlockLayout) -> torch.Tensor:
    """(G, M, N) -> (M, Nb*G*bs): out-block j's columns hold all G gates'
    bs-wide slices for j (the JAX package's ``_flatten_cotangent``, the
    layout both backward kernels read)."""
    G, M = gy.shape[:2]
    return gy.reshape(G, M, layout.Nb, layout.bs).permute(1, 2, 0, 3) \
        .reshape(M, -1).contiguous()


class _BlockSparseV3(torch.autograd.Function):
    """The JAX package's ``block_sparse_matmul_v3`` custom VJP over
    (x, w3): forward kernel; backward dx kernel and dw through the dw
    kernel, both against the flat cotangent; the quantizer passes the
    gradient straight through and the submask multiplies dw."""

    @staticmethod
    def forward(ctx, x, w3, sub3, layout, G, qbits):
        xp = pad_cols(x, layout.K).contiguous()
        ctx.meta = (layout, G, qbits, x.shape[1])
        ctx.save_for_backward(xp, w3, sub3)
        return block_sparse_v3_fwd(xp, w3, layout, G, qbits, sub3)

    @staticmethod
    def backward(ctx, gy):
        layout, G, qbits, F = ctx.meta
        xp, w3, sub3 = ctx.saved_tensors
        gg = flatten_cotangent(gy, layout)
        dx = dw3 = None
        if ctx.needs_input_grad[0]:
            dx = block_sparse_v3_dx(gg, w3, layout, G, qbits, sub3)[:, :F]
        if ctx.needs_input_grad[1]:
            dw3 = block_sparse_dw(gg, xp, layout, G, sub3)
        return dx, dw3, None, None, None, None


def block_sparse_matmul_v3(x: torch.Tensor, w3: torch.Tensor,
                           layout: BlockLayout, G: int = 1, qbits: int = 0,
                           sub3: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``ys[g] = x @ w_eff_g.T`` over the kept blocks, differentiable in
    ``x`` (M, K_true) and ``w3`` (Nb, G*bs, R*bs); ``sub3`` is a constant.
    A K-padded layout pads x with zero columns (its gradient is sliced
    back). Float32 whatever the caller's compute dtype, as in the JAX
    package. -> (G, M, N)."""
    x = x.to(torch.float32).contiguous()
    w3 = w3.to(torch.float32)
    if torch.is_grad_enabled() and (x.requires_grad or w3.requires_grad):
        return _BlockSparseV3.apply(x, w3.contiguous(), sub3, layout, G,
                                    qbits)
    return block_sparse_v3_fwd(pad_cols(x, layout.K).contiguous(),
                               w3.contiguous(), layout, G, qbits, sub3)


# ---------------------------------------------------------------------------
# the legacy v1/v2 block-sparse matmul (TPU kernels _make_fwd, _make_dx,
# _make_dw and their _multi forms)
# ---------------------------------------------------------------------------

def pack_submasks(mask: np.ndarray, layout: BlockLayout) -> np.ndarray:
    """Level-2 fine masks inside kept blocks, packed like the weights
    (float32); multiply them into the packed blocks before the call."""
    return pack_blocks(mask.astype(np.float32), layout)


def pack_blocks_multi(ws, layout: BlockLayout) -> np.ndarray:
    """Stack G dense (N, K) matrices into (nnz, G*bs, bs): block p holds
    matrix g's kept block in rows g*bs .. (g+1)*bs."""
    G, bs = len(ws), layout.bs
    out = np.zeros((layout.nnz, G * bs, bs), np.asarray(ws[0]).dtype)
    for g, w in enumerate(ws):
        out[:, g * bs:(g + 1) * bs, :] = pack_blocks(np.asarray(w), layout)
    return out


def block_sparse_matmul_xla(x: torch.Tensor, w_packed: torch.Tensor,
                            layout: BlockLayout) -> torch.Tensor:
    """The plain reference of :func:`block_sparse_matmul` (the JAX
    package's name for its gather/einsum version), differentiable by
    autograd: per packed block, ``x[:, col_p] @ w_p.T``, summed over the
    blocks of each out-block row. x (M, K), w_packed (nnz, bs, bs) ->
    (M, N) in their promoted dtype."""
    bs, M = layout.bs, x.shape[0]
    dt = torch.promote_types(x.dtype, w_packed.dtype)
    cols = torch.as_tensor(layout.cols, dtype=torch.long, device=x.device)
    rows = torch.as_tensor(layout.rows, dtype=torch.long, device=x.device)
    xg = x.to(dt).reshape(M, layout.Kb, bs)[:, cols]         # (M, nnz, bs)
    yb = torch.einsum("mpk,pnk->pmn", xg, w_packed.to(dt))    # (nnz, M, bs)
    y = yb.new_zeros((layout.Nb, M, bs)).index_add(0, rows, yb)
    return y.transpose(0, 1).reshape(M, layout.N)


def bsl_fwd_plain(x: torch.Tensor, w: torch.Tensor, layout: BlockLayout,
                  G: int) -> torch.Tensor:
    """Twin of the legacy forward: the v3 twin over the packed blocks in
    the w3 layout, all in float32, rounded once to x's dtype. x (M, K),
    w (nnz, G*bs, bs) -> (G, M, N)."""
    return block_sparse_v3_fwd_plain(
        x.float(), v3_from_blocks(w.float(), layout, G), layout, G
    ).to(x.dtype)


def bsl_dx_plain(gy_flat: torch.Tensor, w: torch.Tensor, layout: BlockLayout,
                 G: int) -> torch.Tensor:
    """Twin of the legacy input gradient: the v3 dx twin, in float32,
    rounded once to gy's dtype; column blocks no row keeps stay zero.
    gy_flat (M, Nb*G*bs) -> (M, K)."""
    return block_sparse_v3_dx_plain(
        gy_flat.float(), v3_from_blocks(w.float(), layout, G), layout, G
    ).to(gy_flat.dtype)


def bsl_dw_plain(gy_flat: torch.Tensor, x: torch.Tensor, layout: BlockLayout,
                 G: int) -> torch.Tensor:
    """Twin of the legacy weight gradient: the v3 dw twin over all M in
    float32, its (Nb, G*bs, R*bs) blocks back in packed order, rounded
    once to gy's dtype. -> (nnz, G*bs, bs)."""
    bs = layout.bs
    dw3 = block_sparse_dw_plain(gy_flat.float(), x.float(), layout, G)
    return dw3.reshape(layout.Nb, G * bs, layout.R, bs).permute(0, 2, 1, 3) \
        .reshape(layout.nnz, G * bs, bs).to(gy_flat.dtype)


_LEGACY_DTYPES = (torch.float32, torch.bfloat16)


def _dtype_code(t: torch.Tensor) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _legacy_kernel(name, ptrs, out, codes, ints):
    """Launch ``name`` of ``csrc/block_sparse_legacy.cu`` through
    :func:`_launch`: the pointers, ``out``, the operands' dtype codes, the
    ints and the stream."""
    _launch("block_sparse_legacy", name, out.device,
            (*ptrs, out.data_ptr()), (*codes, *ints))


def legacy_fwd_route(x: torch.Tensor, w: torch.Tensor, bs: int) -> str:
    """The kernel of the legacy forward for these operands, chosen before
    the launch: "gemm" where x is float32, w float32 or bf16 (``v3_fwd_gemm``
    of csrc/block_sparse_v3.cu over the packed weight transposed into
    float32 scratch by ``packed_weight_t``: a bf16 w widens exactly; its
    16-byte loads as :func:`gemm_vec` says); "mma" where both are bf16, bs
    is a multiple of 8 and both are 16-byte aligned (``fwd_mma``, the
    K-major tensor-core tile of csrc/bs_mma.cuh: a 16-byte chunk is 8
    columns of one kept block); else "tile" (``bsl_fwd_tile`` of
    csrc/block_sparse_legacy.cu: bf16 x with float32 w, whose float32
    product needs w unrounded, and the other bf16 pairs)."""
    if x.dtype == torch.float32:
        return "gemm"
    if x.dtype == w.dtype == torch.bfloat16 and bs % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (x, w)):
        return "mma"
    return "tile"


def _packed_fwd_kernel(x, w, layout, G, route, ys):
    """The legacy forward on the "gemm" or "mma" route into ``ys`` (G, M,
    N): ``block_sparse_v3_fwd_packed`` of csrc/block_sparse_v3.cu, with a
    float32 scratch weight on "gemm"."""
    dev, bs = x.device, layout.bs
    gemm = route == "gemm"
    wt = torch.empty((layout.Nb, layout.R * bs, G * bs), dtype=torch.float32,
                     device=dev) if gemm else None
    _launch("block_sparse_v3", "block_sparse_v3_fwd_packed", dev, (
        x.data_ptr(), w.data_ptr(),
        layout.device_index("col_idx", dev).data_ptr(),
        None if wt is None else wt.data_ptr(), ys.data_ptr()), (
        _dtype_code(x), _dtype_code(w), x.shape[0], layout.K, layout.N,
        layout.Nb, layout.R, bs, G, int(gemm and gemm_vec(bs, x))))


def _legacy_fwd(x, w, layout, G, wrapper):
    """The forward at G: the twin on the CPU, else one call on the kernel
    :func:`legacy_fwd_route` picks, counted on ``wrapper``. -> (G, M, N)
    in x's dtype."""
    M = x.shape[0]
    if _check_operands(x, (("x", x, (M, layout.K)),
                           ("w", w, (layout.nnz, G * layout.bs, layout.bs))),
                       _LEGACY_DTYPES):
        return bsl_fwd_plain(x, w, layout, G)
    ys = torch.empty((G, M, layout.N), dtype=x.dtype, device=x.device)
    route = legacy_fwd_route(x, w, layout.bs)
    if route == "tile":
        _legacy_kernel("bsl_fwd", (x.data_ptr(), w.data_ptr(),
                                   layout.device_index("col_idx",
                                                       x.device).data_ptr()),
                       ys, (_dtype_code(x), _dtype_code(w)),
                       (M, layout.K, layout.N, layout.Nb, layout.R, layout.bs,
                        G))
    else:
        _packed_fwd_kernel(x, w, layout, G, route, ys)
    wrapper.launches += 1
    return ys


def legacy_dx_route(gy_flat: torch.Tensor, w: torch.Tensor, bs: int) -> str:
    """The kernel of the legacy dx for these operands, chosen before the
    launch: "gemm" where both are float32 (``dx_gemm`` of
    csrc/block_sparse_dx.cu, the float32 tile of csrc/bs_gemm.cuh, its
    16-byte loads as :func:`gemm_vec` says); "mma" where both are bf16, bs
    is a multiple of 8 and both are 16-byte aligned (``dx_mma``, gy
    K-major and w MN-major on the tensor-core tile of csrc/bs_mma.cuh: a
    16-byte chunk is 8 values of one entry's row or of one block row);
    else "tile" (``bsl_dx_tile`` of csrc/block_sparse_legacy.cu: the mixed
    pairs and the other bf16 ones)."""
    if gy_flat.dtype == w.dtype == torch.float32:
        return "gemm"
    if gy_flat.dtype == w.dtype == torch.bfloat16 and bs % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (gy_flat, w)):
        return "mma"
    return "tile"


# dx_plan's cost model, in microseconds on the H100. A slab of one block
# at two blocks an SM: the float32 tile's 16 rows at 0.20 us a row (the
# dw's measured rate on that tile), the bf16 tile's 64-deep slab at 1.1 us
# (fwd_mma's at the libri G=1 shape: 400 blocks of 8 slabs plus the fill
# in 24.1 us, two rounds of the 264 slots). A block's fixed cost is the
# dw's (DW_BLOCK_OVERHEAD_SLABS: the fill and the epilogue). A split plan
# pays its float32 partials, written and read once more, at the card's
# 3.35 TB/s and the reduce's launch and drain, DX_REDUCE_US: counted from
# the design, not fitted (``chip_smoke.py --gemm-times`` times the picks
# beside the forced alternatives, PERF.md)
DX_SLAB_US = {"gemm": 3.2, "mma": 1.1}
DX_REDUCE_US = 3.0
HBM_BYTES_PER_US = 3.35e6


class DxPlan(NamedTuple):
    """The legacy dx's work items over a layout's columns (:func:`dx_plan`).
    ``split`` (over, piece): the lists of columns with more than ``over``
    entries are cut into near-equal parts of at most ``piece`` entries;
    ``items``: (column, first entry, past-last entry, slot or -1), the
    heaviest first, one per column or part, every column once (a column no
    row keeps has the item (col, 0, 0, -1)); ``reduce``: (column, first
    slot, parts) of each split column, its parts on consecutive slots;
    ``parts``: the float32 partial planes (M, bs) the split parts write;
    ``cost_us``: the modelled time."""
    split: tuple
    items: tuple
    reduce: tuple
    parts: int
    cost_us: float


def column_counts(layout: BlockLayout) -> tuple:
    """The kept blocks of each column block (its real t_perm entries,
    which pack_layout lists first), made once per layout."""
    cache = layout.__dict__
    if "_column_counts" not in cache:
        cache["_column_counts"] = tuple(int(n) for n in (
            layout.t_perm.reshape(layout.Kb, layout.C) != layout.nnz
        ).sum(axis=1))
    return cache["_column_counts"]


def dx_splits(counts: tuple):
    """The plans dx_plan weighs, as (over, piece): no split first (over =
    the most entries a column has), then every over below it with every
    piece up to it."""
    top = max(max(counts, default=0), 1)
    return [(top, top)] + [(over, piece) for over in range(top - 1, 0, -1)
                           for piece in range(over, 0, -1)]


def _dx_items(counts: tuple, over: int, piece: int):
    """-> (items heaviest first, reduce list, partial planes) of a split."""
    items, reduce, slot = [], [], 0
    for col, n in enumerate(counts):
        parts = _cdiv(n, piece) if n > over else 1
        base, extra = divmod(n, parts)
        e0 = 0
        for i in range(parts):
            e1 = e0 + base + (i < extra)
            items.append((col, e0, e1, slot + i if parts > 1 else -1))
            e0 = e1
        if parts > 1:
            reduce.append((col, slot, parts))
            slot += parts
    items.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    return tuple(items), tuple(reduce), slot


@functools.lru_cache(maxsize=None)
def dx_plan(counts: tuple, M: int, GB: int, bs: int, grid: GemmGrid,
            slab_us: float, split: Optional[tuple] = None) -> DxPlan:
    """The legacy dx's plan over columns of ``counts`` entries (contraction
    G*bs = ``GB`` each) at M rows on ``grid`` (the route's tile on the
    card: :func:`gemm_grid`), a slab costing ``slab_us``: of the splits of
    :func:`dx_splits` (or ``split`` alone), the one of least modelled
    time. An item is cdiv(M, tile) x cdiv(bs, tile) blocks of cdiv(entries
    x GB, bk) slabs plus DW_BLOCK_OVERHEAD_SLABS, dispatched in item order
    to the earliest free of the card's sms x blocks_per_sm slots; a split
    adds its partials' bytes (written, then read) over the memory rate
    and DX_REDUCE_US. Ties keep the fewer parts: the unsplit plan first."""
    blocks = _cdiv(M, grid.tile) * _cdiv(bs, grid.tile)
    slots = grid.sms * grid.blocks_per_sm
    best = None
    for over, piece in [split] if split else dx_splits(counts):
        items, reduce, parts = _dx_items(counts, over, piece)
        busy = [0.0] * slots
        for _, e0, e1, _ in items:
            cost = _cdiv((e1 - e0) * GB, grid.bk) + DW_BLOCK_OVERHEAD_SLABS
            for _ in range(blocks):
                heapq.heapreplace(busy, busy[0] + cost)
        us = max(busy) * slab_us
        if parts:
            us += 2 * parts * M * bs * 4 / HBM_BYTES_PER_US + DX_REDUCE_US
        if best is None or us < best.cost_us:
            best = DxPlan((over, piece), items, reduce, parts, us)
    return best


# the tile (gemm_grid's name) of each legacy dx route
DX_TILE = {"gemm": "bs_gemm", "mma": "dx_mma"}


def legacy_dx_plan(layout: BlockLayout, M: int, G: int, route: str,
                   grid: GemmGrid, split: Optional[tuple] = None) -> DxPlan:
    """:func:`dx_plan` of a legacy dx call at M and G on ``route``
    ("gemm" or "mma") over ``grid`` (on the card ``gemm_grid(dev,
    DX_TILE[route])``), or of the forced ``split``."""
    return dx_plan(column_counts(layout), M, G * layout.bs, layout.bs, grid,
                   DX_SLAB_US[route], split)


def _dx_work(layout, M, G, route, dev):
    """The plan of this call (:func:`legacy_dx_plan`) and its items and
    reduce list as one int32 tensor on ``dev``, made once per (layout, M,
    G, route, device) and plan."""
    plan = legacy_dx_plan(layout, M, G, route,
                          gemm_grid(dev, DX_TILE[route]))
    cache = layout.__dict__.setdefault("_dx_tables", {})
    key = (M, G, route, str(dev))
    hit = cache.get(key)
    if hit is None or hit[0] is not plan:
        flat = [v for it in plan.items for v in it] + \
            [v for r in plan.reduce for v in r]
        hit = cache[key] = (plan, torch.tensor(flat, dtype=torch.int32,
                                               device=dev))
    return hit


def _packed_dx_kernel(gy_flat, w, layout, G, route, dx):
    """The legacy dx on the "gemm" or "mma" route into ``dx`` (M, K):
    ``block_sparse_dx_packed`` of csrc/block_sparse_dx.cu over the work
    items of :func:`dx_plan`, float32 partials in scratch where it
    splits."""
    M, dev, bs = gy_flat.shape[0], gy_flat.device, layout.bs
    plan, table = _dx_work(layout, M, G, route, dev)
    part = torch.empty((plan.parts, M, bs), dtype=torch.float32,
                       device=dev) if plan.parts else None
    n_items = len(plan.items)
    _launch("block_sparse_dx", "block_sparse_dx_packed", dev, (
        gy_flat.data_ptr(), w.data_ptr(),
        layout.device_index("t_row_idx", dev).data_ptr(),
        layout.device_index("t_perm", dev).data_ptr(), table.data_ptr(),
        table.data_ptr() + 16 * n_items, dx.data_ptr(),
        None if part is None else part.data_ptr()), (
        int(route == "mma"), M, layout.K, layout.Nb, bs, G, layout.C,
        n_items, len(plan.reduce),
        int(route == "gemm" and gemm_vec(bs, gy_flat, w))))


def _legacy_dx(gy_flat, w, layout, G, wrapper):
    """dx at G (see :func:`_legacy_fwd`) on the kernel
    :func:`legacy_dx_route` picks. -> (M, K) in gy's dtype."""
    M, dev = gy_flat.shape[0], gy_flat.device
    if _check_operands(gy_flat, (
            ("gy", gy_flat, (M, _flat_width(layout, G))),
            ("w", w, (layout.nnz, G * layout.bs, layout.bs))),
            _LEGACY_DTYPES):
        return bsl_dx_plain(gy_flat, w, layout, G)
    dx = torch.empty((M, layout.K), dtype=gy_flat.dtype, device=dev)
    route = legacy_dx_route(gy_flat, w, layout.bs)
    if route == "tile":
        _legacy_kernel("bsl_dx", (
            gy_flat.data_ptr(), w.data_ptr(),
            layout.device_index("t_row_idx", dev).data_ptr(),
            layout.device_index("t_perm", dev).data_ptr()), dx,
            (_dtype_code(gy_flat), _dtype_code(w)),
            (M, layout.K, layout.Nb, layout.bs, G, layout.C, layout.nnz))
    else:
        _packed_dx_kernel(gy_flat, w, layout, G, route, dx)
    wrapper.launches += 1
    return dx


def legacy_dw_route(gy_flat: torch.Tensor, x: torch.Tensor,
                    bs: int) -> str:
    """The kernel of the legacy dw for these operands, chosen before the
    launch: "gemm" where both are float32 (``dw_gemm`` of
    csrc/block_sparse_dw.cu, the float32 tile of csrc/bs_gemm.cuh, its
    16-byte loads as :func:`gemm_vec` says); "mma" where both are bf16, bs
    is a multiple of 8 and both are 16-byte aligned (``dw_mma``, the
    tensor-core tile of csrc/bs_mma.cuh: a 16-byte chunk is 8 columns of
    one kept block); else "tile" (``bsl_dw_tile`` of
    csrc/block_sparse_legacy.cu: the mixed pairs and the other bf16
    ones)."""
    if gy_flat.dtype == x.dtype == torch.float32:
        return "gemm"
    if gy_flat.dtype == x.dtype == torch.bfloat16 and bs % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (gy_flat, x)):
        return "mma"
    return "tile"


def _packed_dw_kernel(gy_flat, x, layout, G, route, dw):
    """The legacy dw on the "gemm" or "mma" route into ``dw`` (nnz, G*bs,
    bs): ``block_sparse_dw_packed`` of csrc/block_sparse_dw.cu, M split
    as :func:`dw_plan` says for that route's tile."""
    M, dev = x.shape[0], x.device
    mma = route == "mma"
    splits, rows, part = _dw_split(M, layout, G, dev,
                                   "bs_mma" if mma else "bs_gemm")
    _launch("block_sparse_dw", "block_sparse_dw_packed", dev, (
        gy_flat.data_ptr(), x.data_ptr(),
        layout.device_index("col_idx", dev).data_ptr(), dw.data_ptr(),
        None if part is None else part.data_ptr()), (
        int(mma), M, layout.K, layout.Nb, layout.R, layout.bs, G, splits,
        rows, int(not mma and gemm_vec(layout.bs, gy_flat, x))))


def _legacy_dw(gy_flat, x, layout, G, wrapper):
    """dw at G (see :func:`_legacy_fwd`) on the kernel
    :func:`legacy_dw_route` picks. -> (nnz, G*bs, bs) in gy's dtype."""
    M, dev = x.shape[0], x.device
    if _check_operands(gy_flat, (
            ("gy", gy_flat, (M, _flat_width(layout, G))),
            ("x", x, (M, layout.K))), _LEGACY_DTYPES):
        return bsl_dw_plain(gy_flat, x, layout, G)
    dw = torch.empty((layout.nnz, G * layout.bs, layout.bs),
                     dtype=gy_flat.dtype, device=dev)
    route = legacy_dw_route(gy_flat, x, layout.bs)
    if route == "tile":
        _legacy_kernel("bsl_dw", (
            gy_flat.data_ptr(), x.data_ptr(),
            layout.device_index("rows", dev).data_ptr(),
            layout.device_index("cols", dev).data_ptr()), dw,
            (_dtype_code(gy_flat), _dtype_code(x)),
            (M, layout.K, layout.Nb, layout.nnz, layout.bs, G))
    else:
        _packed_dw_kernel(gy_flat, x, layout, G, route, dw)
    wrapper.launches += 1
    return dw


def bsl_fwd(x: torch.Tensor, w_packed: torch.Tensor,
            layout: BlockLayout) -> torch.Tensor:
    """The v1 forward (TPU kernel ``_make_fwd``): ``y = x @
    scatter(w_packed).T`` over the kept blocks. x (M, K) and w_packed
    (nnz, bs, bs), each float32 or bfloat16 -> (M, N) in x's dtype,
    summed in float32. CUDA tensors run the kernel
    :func:`legacy_fwd_route` picks at G=1, CPU tensors the twin."""
    return _legacy_fwd(x, w_packed, layout, 1, bsl_fwd)[0]


def bsl_dx(gy: torch.Tensor, w_packed: torch.Tensor,
           layout: BlockLayout) -> torch.Tensor:
    """The v1 input gradient (TPU kernel ``_make_dx``): ``dx = gy @
    scatter(w_packed)``, gy (M, N) -> (M, K) in gy's dtype, on the kernel
    :func:`legacy_dx_route` picks (split columns' partials summed in a
    fixed order: two calls give the same bits)."""
    return _legacy_dx(gy, w_packed, layout, 1, bsl_dx)


def bsl_dw(gy: torch.Tensor, x: torch.Tensor,
           layout: BlockLayout) -> torch.Tensor:
    """The v1 weight gradient (TPU kernel ``_make_dw``): per packed block
    p, ``gy[:, row_p].T @ x[:, col_p]`` over all M -> (nnz, bs, bs) in
    gy's dtype, on the kernel :func:`legacy_dw_route` picks (split-M
    partials summed in a fixed order: two calls give the same bits)."""
    return _legacy_dw(gy, x, layout, 1, bsl_dw)


def bsl_fwd_multi(x: torch.Tensor, w_stacked: torch.Tensor,
                  layout: BlockLayout, G: int) -> torch.Tensor:
    """The v2 forward (TPU kernel ``_make_fwd_multi``): ``ys[g] = x @
    scatter(w_g).T`` for the G matrices stacked in w_stacked (nnz, G*bs,
    bs) -> (G, M, N) in x's dtype (the kernel writes the G planes, so no
    regroup follows)."""
    return _legacy_fwd(x, w_stacked, layout, G, bsl_fwd_multi)


def bsl_dx_multi(gy_flat: torch.Tensor, w_stacked: torch.Tensor,
                 layout: BlockLayout, G: int) -> torch.Tensor:
    """The v2 input gradient (TPU kernel ``_make_dx_multi``) from the
    flat cotangent (M, Nb*G*bs) (:func:`flatten_cotangent`) -> (M, K) in
    its dtype."""
    return _legacy_dx(gy_flat, w_stacked, layout, G, bsl_dx_multi)


def bsl_dw_multi(gy_flat: torch.Tensor, x: torch.Tensor,
                 layout: BlockLayout, G: int) -> torch.Tensor:
    """The v2 weight gradient (TPU kernel ``_make_dw_multi``) from the
    flat cotangent -> (nnz, G*bs, bs) in its dtype."""
    return _legacy_dw(gy_flat, x, layout, G, bsl_dw_multi)


for _w in (bsl_fwd, bsl_dx, bsl_dw, bsl_fwd_multi, bsl_dx_multi,
           bsl_dw_multi):
    _w.launches = 0
del _w


def _tile_m(M: int, tile_m: int) -> int:
    """The JAX package's row tiling rule: tile_m clamped to M, M a
    multiple of it (the kernels here take any M; the rule stays)."""
    tile_m = min(tile_m, M)
    if M % tile_m:
        raise ValueError("M=%d not divisible by tile_m=%d" % (M, tile_m))
    return tile_m


class _BlockSparseMatmul(torch.autograd.Function):
    """The JAX package's ``block_sparse_matmul`` custom VJP: forward
    kernel; dx and dw kernels against the cotangent."""

    @staticmethod
    def forward(ctx, x, w_packed, layout):
        ctx.layout = layout
        ctx.save_for_backward(x, w_packed)
        return bsl_fwd(x, w_packed, layout)

    @staticmethod
    def backward(ctx, gy):
        x, w_packed = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = bsl_dx(gy, w_packed, ctx.layout)
        if ctx.needs_input_grad[1]:
            dw = bsl_dw(gy, x, ctx.layout)
        return dx, dw, None


class _BlockSparseMatmulMulti(torch.autograd.Function):
    """The JAX package's ``block_sparse_matmul_multi`` custom VJP: the
    (G, M, N) cotangent flattened to (M, Nb*G*bs) (the JAX ``_regroup``),
    then the dx and dw kernels."""

    @staticmethod
    def forward(ctx, x, w_stacked, layout, G):
        ctx.meta = (layout, G)
        ctx.save_for_backward(x, w_stacked)
        return bsl_fwd_multi(x, w_stacked, layout, G)

    @staticmethod
    def backward(ctx, gy):
        layout, G = ctx.meta
        x, w_stacked = ctx.saved_tensors
        gg = flatten_cotangent(gy, layout)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = bsl_dx_multi(gg, w_stacked, layout, G)
        if ctx.needs_input_grad[1]:
            dw = bsl_dw_multi(gg, x, layout, G)
        return dx, dw, None, None


def block_sparse_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                        layout: BlockLayout,
                        tile_m: int = 256) -> torch.Tensor:
    """``y = x @ scatter(w_packed).T`` over the kept blocks,
    differentiable in x and w_packed (the legacy v1 API).

    x (M, layout.K): a K-padded layout takes x at its padded width;
    w_packed (nnz, bs, bs); float32 or bfloat16 each. -> (M, N) in x's
    dtype; dx and dw come in the cotangent's dtype (x's), and autograd
    casts dw to w_packed's. ``tile_m`` is the JAX package's row tile:
    clamped to M, and M must be a multiple of it."""
    _tile_m(x.shape[0], tile_m)
    return _BlockSparseMatmul.apply(x.contiguous(), w_packed.contiguous(),
                                    layout)


def block_sparse_matmul_multi(x: torch.Tensor, w_stacked: torch.Tensor,
                              layout: BlockLayout, n_mats: int,
                              tile_m: int = 256) -> torch.Tensor:
    """``ys[g] = x @ scatter(w_g).T`` for G = ``n_mats`` matrices sharing
    one layout (the legacy v2 API), differentiable. x (M, layout.K),
    w_stacked (nnz, G*bs, bs) (:func:`pack_blocks_multi`) -> (G, M, N) in
    x's dtype; ``tile_m`` as in :func:`block_sparse_matmul`."""
    _tile_m(x.shape[0], tile_m)
    return _BlockSparseMatmulMulti.apply(x.contiguous(),
                                         w_stacked.contiguous(), layout,
                                         n_mats)
