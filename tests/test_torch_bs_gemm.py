"""The GEMM kernels of the port's block-sparse ops
(pytorch_kaldi_cgs_tpu_torch/ops/block_sparse.py: the dw kernel,
``csrc/block_sparse_dw.cu``, and the v3 forward, ``csrc/block_sparse_v3.cu``,
on the register-blocked float32 tile of ``csrc/bs_gemm.cuh``; the legacy
v1/v2 dw, ``bsl_dw`` / ``bsl_dw_multi``, on that tile with a packed-layout
epilogue for float32 operands and on the bf16 tensor-core tile of
``csrc/bs_mma.cuh`` for bf16 ones; the legacy v1/v2 forward, ``bsl_fwd``
/ ``bsl_fwd_multi``, on the v3 forward's float32 GEMM over the packed
weight transposed into scratch for float32 x and on the K-major bf16
tensor-core tile of ``csrc/bs_mma.cuh`` for bf16 x and w).

- On the CPU: the pure-Python plan of the two grids. ``dw_plan`` splits M
  so that the dw kernel's small output grids (the LibriSpeech GRU's dU,
  the CGS-16x LSTM's) fill about two waves of the H100's 132 SMs (its
  two resident blocks each) and no more, that grids filling most of one
  round (the libri v3 dw) fill at least 90% of the rounds they take, and
  that grids filling whole rounds keep one split; its splits cover M
  exactly once (the dw over each split's rows, summed in order, is the
  dw within 1e-5 of its largest magnitude). The plan is checked on the
  H100's grid: 132 SMs and the tile constants of ``csrc/bs_gemm.cuh``.
  ``gemm_vec`` takes the 16-byte-load instantiation only where a float4
  of columns lies inside one gate and every operand is 16-byte aligned,
  and at bs = 128 every 128-column tile of the forward lies inside one
  gate.
- On the card (``cuda``, skipped here): both kernels against their plain
  twins on the same tensors at float32 atol 1e-5 of the twin's largest
  magnitude (the sums differ only in order), over ragged M (1, 7, 129,
  4,801), bs 8, 128 and 6 (the scalar-load instantiation), a K-padded
  layout at each, R from 2 to 6, G from 1 to 4, the level-2 submask on
  and off, the 8-bit weight quantizer on and off; the scalar loads also where bs is a multiple of 4 and one
  operand lies 4 bytes off a float4; one API call moves each launch
  counter by exactly one; two split-M dw calls give equal bits; the
  split plan's grid is the built library's tile and the card's SMs.
  Run there with ``python -m pytest --noconftest -q -m cuda
  tests/test_torch_bs_gemm.py``.
- The legacy dw: on the CPU, the route each dtype pair, bs and
  alignment takes (``legacy_dw_route``); the split plan of both tiles
  (the bf16 tile's constants read from ``csrc/bs_mma.cuh``) at the three
  timed shapes (the libri x-projection at G=1 and 3, M=6400; the CGS-16x
  LSTM's G=4, M=4800) and the bs=8 layouts; the packed epilogue's index
  map (``out_at<true>`` of the kernel, mirrored) over a CPU stand-in of
  the split sum against ``bsl_dw_plain``. On the card (``cuda``): the
  wrappers against ``bsl_dw_plain`` at every layout of
  ``chip_smoke.legacy_layouts()``, G 1, 3, 4, M 7, 16, 4801, 6400, the
  four dtype pairs (float32 within 1e-5 of the twin's largest magnitude,
  a bf16 output within one bf16 ulp of it: both round one float32 sum
  once); misaligned operands; two calls bit for bit; the device kernels
  of one call (``torch.profiler``).
- The legacy forward: on the CPU, the route each dtype pair, bs and
  alignment takes (``legacy_fwd_route``); the "gemm" route's packed
  transposer index map (``packed_weight_t``, mirrored) and the "mma"
  route's operand lines and epilogue column map (``fwd_mma``, mirrored)
  over CPU stand-ins against ``bsl_fwd_plain`` at the bs=8 layouts; the
  wrappers on CPU tensors return the twin in x's dtype. On the card
  (``cuda``): each route against ``bsl_fwd_plain`` at every layout of
  ``chip_smoke.legacy_layouts()``, G 1, 3, 4, M 7, 16, 4801, 6400, the
  four dtype pairs; a misaligned x and w; the device kernels of one call
  at the three timed shapes; ``block_sparse_matmul[_multi]`` forward and
  backward against the dense masked float32 product.
- The legacy dx (``bsl_dx`` / ``bsl_dx_multi``, ``csrc/block_sparse_dx.cu``):
  on the CPU, the route each dtype pair, bs and alignment takes
  (``legacy_dx_route``); ``dx_plan`` at the three timed shapes on the
  H100's grid (every entry of every column in one item, heaviest first,
  the least modelled time of the splits it weighs, the list schedule
  within one block of the mean load); both new routes' operand maps, the
  plan's items and the split columns' fixed-order reduce over CPU
  stand-ins (the plan's pick and the finest split) against
  ``bsl_dx_plain``. On the card (``cuda``): each route against
  ``bsl_dx_plain`` at every layout of ``chip_smoke.legacy_layouts()``, G
  1, 3, 4, M 7, 16, 4801, 6400, the four dtype pairs, columns no row
  keeps zero; the finest split forced; a misaligned gy and w; two calls
  bit for bit and the device kernels of one call at the timed shapes.
"""
import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

ATOL = 1e-5


def _tile_constants(header="bs_gemm.cuh"):
    """TILE, BK and MIN_BLOCKS as a tile's header defines them (the
    built library reports the same through ``bs_gemm_config`` and
    ``bs_mma_config``)."""
    with open(os.path.join(os.path.dirname(tbs.__file__), "csrc",
                           header)) as f:
        src = f.read()
    return [int(re.search(r"constexpr int %s = (\d+);" % n, src).group(1))
            for n in ("TILE", "BK", "MIN_BLOCKS")]


SMS = 132                       # the H100 SXM's
H100 = tbs.GemmGrid(SMS, *_tile_constants())
H100_MMA = tbs.GemmGrid(SMS, *_tile_constants("bs_mma.cuh"),
                        tbs.PARTIAL_ROUND["bs_mma"])

# name: (N, K, blocks, drops, bs): HCGS layouts, K-padded where K is not
# a multiple of bs
LAYOUTS = {
    "bs8_r2": (32, 64, [8], [75], 8),
    "bs8_r6": (32, 64, [8], [25], 8),
    "bs8_padk": (32, 44, [8, 2], [50, 50], 8),
    "bs128_cgs16x": (1024, 1024, [128, 8], [75, 75], 128),
    "bs128_padk143": (512, 143, [128, 4], [25, 62.5], 128),
    # bs not a multiple of 4: the kernels' scalar-load instantiation
    "bs6_r4": (24, 48, [6], [50], 6),
    "bs6_padk": (30, 44, [6], [60], 6),
}
MS = (1, 7, 129, 4801)
GS = (1, 2, 3, 4)


@functools.lru_cache(maxsize=None)
def _layout(name):
    N, K, blocks, drops, bs = LAYOUTS[name]
    mask = hcgs_mask(N, K, blocks, drops, rng=np.random.RandomState(5))
    return mask, tbs.pack_layout(mask, bs, pad_k=K % bs != 0)


# ---------------------------------------------------------------------------
# the plan (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (M, Nb, G, R, bs): the libri GRU's dU at G=1 and G=2, the CGS-16x
    # LSTM's dU, the CGS-16x Li-GRU's and minimalGRU/RNN's
    (6400, 8, 1, 2, 128), (6400, 8, 2, 2, 128), (4800, 8, 4, 2, 128),
    (2400, 8, 2, 2, 128), (2400, 8, 1, 2, 128)],
    ids=["libri_dU_G1", "libri_dU_G2", "cgs16x_lstm_G4", "cgs16x_G2",
         "cgs16x_G1"])
def test_dw_plan_fills_two_waves(shape):
    M, Nb, G, R, bs = shape
    tiles, splits, rows = tbs.dw_plan(M, Nb, G, R, bs, H100)
    assert tiles == Nb * (G * bs // H100.tile) * (R * bs // H100.tile)
    assert splits > 1
    # about two waves of 132 SMs, and no block waits for a second round
    assert 0.9 * 2 * SMS <= tiles * splits <= H100.blocks_per_sm * SMS
    assert rows % H100.bk == 0 and rows >= tbs.DW_SPLIT_MIN_ROWS
    assert (splits - 1) * rows < M <= splits * rows


@pytest.mark.parametrize("shape", [
    (6400, 32, 4, 8, 128),       # 1,024 tiles: whole rounds already
    (200, 8, 1, 2, 128),         # too few rows to split
    (1, 4, 4, 2, 8), (7, 4, 1, 6, 8)], ids=str)
def test_dw_plan_one_split_at_large_grids_and_short_m(shape):
    M, Nb, G, R, bs = shape
    tiles, splits, rows = tbs.dw_plan(M, Nb, G, R, bs, H100)
    assert splits == 1 and rows >= M and rows % H100.bk == 0


@pytest.mark.parametrize("shape", [
    (6400, 8, 3, 4, 128), (6368, 8, 3, 4, 128), (6400, 16, 3, 4, 128)],
    ids=["libri_v3_G3", "libri_v3_G3_serve_M", "192_tiles"])
def test_dw_plan_fills_the_rounds_it_takes(shape):
    """Where the tiles alone fill most of one round of slots (96 or 192
    of 264), M is split so that the blocks fill at least 90% of the
    rounds they take, and the modelled time beats one split's."""
    M, Nb, G, R, bs = shape
    tiles, splits, rows = tbs.dw_plan(M, Nb, G, R, bs, H100)
    slots = H100.blocks_per_sm * SMS
    rounds = -(-tiles * splits // slots)
    assert splits > 1 and tiles * splits >= 0.9 * rounds * slots
    fixed = tbs.DW_BLOCK_OVERHEAD_SLABS * H100.bk
    one = -(-tiles // slots) * (-(-M // H100.bk) * H100.bk + fixed)
    assert rounds * (rows + fixed) < one


def _modelled(grid, tiles, splits, rows):
    """dw_plan's modelled time of a plan: the busiest SM's blocks in
    rounds of blocks_per_sm, a last round with fewer blocks at the grid's
    partial_round of a full one, times the rows a block walks plus its
    fixed cost."""
    full, part = divmod(-(-tiles * splits // grid.sms), grid.blocks_per_sm)
    return (full + (grid.partial_round if part else 0)) * (
        rows + tbs.DW_BLOCK_OVERHEAD_SLABS * grid.bk)


@pytest.mark.parametrize("M", [300, 1000, 4801])
@pytest.mark.parametrize("with_sub", [False, True], ids=["plain", "sub"])
def test_dw_splits_cover_m_once(M, with_sub):
    """The kernel's two passes in plain ops: the dw of each split's rows
    (without the submask), summed in split order, then the submask, is
    the dw of all M."""
    mask, tl = _layout("bs8_r2")
    G = 3
    rng = np.random.RandomState(M)
    dg = torch.from_numpy(rng.randn(M, tl.Nb * G * 8).astype(np.float32))
    x = torch.from_numpy(rng.randn(M, tl.K).astype(np.float32))
    sub3 = torch.from_numpy(tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G)) \
        if with_sub else None
    _, splits, rows = tbs.dw_plan(M, tl.Nb, G, tl.R, 8, H100)
    assert splits > 1
    got = functools.reduce(torch.add, [
        tbs.block_sparse_dw_plain(dg[s * rows:(s + 1) * rows],
                                  x[s * rows:(s + 1) * rows], tl, G)
        for s in range(splits)])
    got = got * sub3 if sub3 is not None else got
    ref = tbs.block_sparse_dw(dg, x, tl, G, sub3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=ATOL * ref.abs().max().item())


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("bs", [4, 8, 12, 128, 256])
def test_fast_path_columns_stay_inside_one_gate(bs, G):
    """The forward's column tiles: a thread's float4 of columns (n = n0 +
    h*64 + tx*4 .. +3) lies inside one gate wherever gemm_vec allows the
    16-byte path, and at bs a multiple of 128 a whole 128-column tile
    does."""
    GB = G * bs
    assert tbs.gemm_vec(bs)
    for n0 in range(0, GB, H100.tile):
        tile = range(n0, min(n0 + H100.tile, GB))
        if bs % H100.tile == 0:
            assert len({n // bs for n in tile}) == 1
        for n in range(n0, min(n0 + H100.tile, GB), 4):
            assert n // bs == min(n + 3, GB - 1) // bs


def test_scalar_path_where_bs_or_alignment_forbids_float4():
    assert not tbs.gemm_vec(6)
    assert not tbs.gemm_vec(2)
    base = torch.zeros(64)
    assert tbs.gemm_vec(8, base, None)
    assert not tbs.gemm_vec(8, base[1:])       # 4 bytes off a float4


@pytest.mark.parametrize("name", ["bs6_r4", "bs6_padk"])
def test_scalar_layouts_take_the_scalar_path(name):
    """The cuda cases' layouts with bs not a multiple of 4 pack (one
    K-padded from 44 to 48) and take the scalar loads."""
    _, tl = _layout(name)
    assert tl.bs % 4 and tl.K % tl.bs == 0 and tl.R >= 2
    assert not tbs.gemm_vec(tl.bs, torch.zeros(4 * tl.K))


# ---------------------------------------------------------------------------
# on the card: both kernels against their twins (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=32)
def _operands(name, M, G, dev):
    """x (M, K; pad columns zero), w3 at 8-bit scale, sub3 and a flat
    cotangent (M, Nb*G*bs) on the card."""
    mask, tl = _layout(name)
    bs = tl.bs
    rng = np.random.RandomState(M + G)
    x = rng.randn(M, tl.K).astype(np.float32)
    x[:, tl.k_true:] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    w3 = rng.randn(tl.Nb, G * bs, tl.R * bs).astype(np.float32) * 0.6
    sub3 = tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G)
    dg = rng.randn(M, tl.Nb * G * bs).astype(np.float32)
    return tl, t(x), t(w3), t(sub3), t(dg)


@pytest.mark.cuda
@pytest.mark.parametrize("with_sub", [False, True], ids=["plain", "sub"])
@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_cuda_dw_matches_twin(cuda_device, name, M, G, with_sub):
    tl, x, _, sub3, dg = _operands(name, M, G, cuda_device)
    sub = sub3 if with_sub else None
    assert tbs.gemm_vec(tl.bs, dg, x, sub) == (tl.bs % 4 == 0)
    before = tbs.block_sparse_dw.launches
    got = tbs.block_sparse_dw(dg, x, tl, G, sub)
    assert tbs.block_sparse_dw.launches == before + 1
    ref = tbs.block_sparse_dw_plain(dg, x, tl, G, sub)
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("qbits,with_sub", [(0, False), (0, True), (8, False),
                                            (8, True)],
                         ids=["plain", "sub", "q8", "q8_sub"])
@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_cuda_v3_fwd_matches_twin(cuda_device, name, M, G, qbits, with_sub):
    tl, x, w3, sub3, _ = _operands(name, M, G, cuda_device)
    sub = sub3 if with_sub else None
    assert tbs.gemm_vec(tl.bs, x) == (tl.bs % 4 == 0)
    before = tbs.block_sparse_v3_fwd.launches
    got = tbs.block_sparse_v3_fwd(x, w3, tl, G, qbits, sub)
    assert tbs.block_sparse_v3_fwd.launches == before + 1
    ref = tbs.block_sparse_v3_fwd_plain(x, w3, tl, G, qbits, sub)
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
def test_cuda_dw_split_m_is_deterministic(cuda_device, G):
    """The LibriSpeech GRU's dU (M=6400, Kb=8, R=2, bs=128): M split in
    several parts, the partials summed in a fixed order; two calls give
    equal bits."""
    mask = hcgs_mask(1024, 1024, [128, 4], [75, 50],
                     rng=np.random.RandomState(7))
    tl = tbs.pack_layout(mask, 128)
    assert tbs.dw_plan(6400, tl.Nb, G, tl.R, 128,
                       tbs.gemm_grid(cuda_device))[1] > 1
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    dg = torch.randn(6400, tl.Nb * G * 128, device=cuda_device, generator=gen)
    x = torch.randn(6400, 1024, device=cuda_device, generator=gen)
    a = tbs.block_sparse_dw(dg, x, tl, G)
    b = tbs.block_sparse_dw(dg, x, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = tbs.block_sparse_dw_plain(dg, x, tl, G)
    np.testing.assert_allclose(a.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * max(1.0, ref.abs().max().item()))


def _offset(t):
    """A contiguous copy of ``t`` that starts one element (4 bytes in
    float32, 2 in bf16) past a 16-byte boundary (the caching allocator's
    blocks start on 512)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "dg", "sub3"])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", ["bs8_r2", "bs128_cgs16x"])
def test_cuda_dw_scalar_loads_on_a_misaligned_operand(cuda_device, name, M,
                                                      which):
    """bs a multiple of 4, one operand 4 bytes off a float4: the dw takes
    its scalar-load instantiation and agrees with its twin."""
    G = 3
    tl, x, _, sub3, dg = _operands(name, M, G, cuda_device)
    ops = {"dg": dg, "x": x, "sub3": sub3}
    ops[which] = _offset(ops[which])
    assert not tbs.gemm_vec(tl.bs, ops["dg"], ops["x"], ops["sub3"])
    got = tbs.block_sparse_dw(ops["dg"], ops["x"], tl, G, ops["sub3"])
    ref = tbs.block_sparse_dw_plain(dg, x, tl, G, sub3)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("qbits,with_sub", [(0, False), (8, True)],
                         ids=["plain", "q8_sub"])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", ["bs8_padk", "bs128_padk143"])
def test_cuda_v3_fwd_scalar_loads_on_a_misaligned_x(cuda_device, name, M,
                                                    qbits, with_sub):
    """bs a multiple of 4, x 4 bytes off a float4: the forward takes its
    scalar-load instantiation and agrees with its twin."""
    G = 3
    tl, x, w3, sub3, _ = _operands(name, M, G, cuda_device)
    sub = sub3 if with_sub else None
    xo = _offset(x)
    assert not tbs.gemm_vec(tl.bs, xo)
    got = tbs.block_sparse_v3_fwd(xo, w3, tl, G, qbits, sub)
    ref = tbs.block_sparse_v3_fwd_plain(x, w3, tl, G, qbits, sub)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
def test_cuda_gemm_grid_reads_the_library_and_the_card(cuda_device):
    """The split plan's grid: the tile as the built library reports it
    (the header's constants) and the device's SM count."""
    grid = tbs.gemm_grid(cuda_device)
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    assert grid == tbs.GemmGrid(props.multi_processor_count,
                                *_tile_constants())


# ---------------------------------------------------------------------------
# the legacy dw (rows 9 and 12): routes, plans, the packed epilogue (CPU)
# ---------------------------------------------------------------------------

DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("gy,x,bs,off,route", [
    ("f32", "f32", 128, None, "gemm"), ("f32", "f32", 6, None, "gemm"),
    ("f32", "f32", 128, "x", "gemm"), ("bf16", "bf16", 128, None, "mma"),
    ("bf16", "bf16", 8, None, "mma"), ("bf16", "bf16", 4, None, "tile"),
    ("bf16", "bf16", 12, None, "tile"), ("bf16", "bf16", 128, "gy", "tile"),
    ("bf16", "bf16", 128, "x", "tile"), ("f32", "bf16", 128, None, "tile"),
    ("bf16", "f32", 128, None, "tile")], ids=str)
def test_legacy_dw_route(gy, x, bs, off, route):
    """Both float32: the float32 tile (its scalar loads where gemm_vec
    says); both bf16 at bs a multiple of 8, 16-byte aligned: the
    tensor-core tile; the mixed pairs and the other bf16 ones: the
    legacy file's bsl_dw_tile."""
    ops = {}
    for name, dt in (("gy", gy), ("x", x)):
        base = torch.zeros(65, dtype=DT[dt])
        assert base.data_ptr() % 16 == 0
        ops[name] = base[1:] if off == name else base[:64]
    assert tbs.legacy_dw_route(ops["gy"], ops["x"], bs) == route
    if route == "gemm":
        assert tbs.gemm_vec(bs, ops["gy"], ops["x"]) == (bs % 4 == 0
                                                         and off is None)


# (M, Nb, G, R, bs) of the legacy dw's timed shapes: the libri
# x-projection (Kb=16, R=4) at G=1 and G=3, the CGS-16x LSTM's 1024 x 1024
# (Kb=8, R=2) at G=4
LEGACY_TIMED = {"libri_G1": (6400, 8, 1, 4, 128),
                "libri_G3": (6400, 8, 3, 4, 128),
                "cgs16x_G4": (4800, 8, 4, 2, 128)}


@pytest.mark.parametrize("grid", [H100, H100_MMA], ids=["f32", "bf16"])
@pytest.mark.parametrize("tag", sorted(LEGACY_TIMED))
def test_legacy_dw_plan_at_the_timed_shapes(tag, grid):
    """Both tiles split M at the three timed shapes: the splits cover M
    once, in rows a multiple of the tile's slab; every SM runs within 90%
    of the blocks of the busiest one, and the modelled time is below one
    split's and below twice as many splits'. The picks (float32 8, 8, 4;
    bf16 4, 4, 2) are the fastest of 1-16 splits on the H100 or within 5%
    of it (``dw_split_sweep.py``)."""
    M, Nb, G, R, bs = LEGACY_TIMED[tag]
    tiles, splits, rows = tbs.dw_plan(M, Nb, G, R, bs, grid)
    assert tiles == Nb * (G * bs // grid.tile) * (R * bs // grid.tile)
    assert splits == {
        H100: {"libri_G1": 8, "libri_G3": 8, "cgs16x_G4": 4},
        H100_MMA: {"libri_G1": 4, "libri_G3": 4, "cgs16x_G4": 2}}[grid][tag]
    assert (splits - 1) * rows < M <= splits * rows
    assert rows % grid.bk == 0 and rows >= tbs.DW_SPLIT_MIN_ROWS
    busiest = -(-tiles * splits // grid.sms)
    assert tiles * splits >= 0.9 * busiest * grid.sms
    cost = _modelled(grid, tiles, splits, rows)
    assert cost < _modelled(grid, tiles, 1, -(-M // grid.bk) * grid.bk)
    twice = -(-(-(-M // (2 * splits))) // grid.bk) * grid.bk
    assert cost < _modelled(grid, tiles, -(-M // twice), twice)


def _small_legacy_layouts():
    """chip_smoke.legacy_layouts()'s two bs=8 layouts: an HCGS 32 x 48
    (keep 3 of 6 a row) and the uneven one (Kb=6, R=2, C=4)."""
    small = tbs.pack_layout(hcgs_mask(32, 48, [8], [50],
                                      rng=np.random.RandomState(0)), 8)
    occ = np.zeros((4, 6), np.float32)
    for j, cs in enumerate(((0, 1), (1, 2), (1, 3), (1, 4))):
        occ[j, list(cs)] = 1
    uneven = tbs.pack_layout(np.kron(occ, np.ones((8, 8), np.float32)), 8)
    return {"small_hcgs": small, "small_uneven": uneven}


@pytest.mark.parametrize("grid", [H100, H100_MMA], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [7, 16, 300, 4801])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", ["small_hcgs", "small_uneven"])
def test_legacy_dw_plan_at_bs8(name, G, M, grid):
    """The bs=8 layouts (one mostly empty tile an out-block): one split
    below two DW_SPLIT_MIN_ROWS, else splits of at least that many rows
    that cover M once, in rows a multiple of the slab."""
    tl = _small_legacy_layouts()[name]
    tiles, splits, rows = tbs.dw_plan(M, tl.Nb, G, tl.R, tl.bs, grid)
    assert tiles == tl.Nb
    assert (splits - 1) * rows < M <= splits * rows and rows % grid.bk == 0
    if M < 2 * tbs.DW_SPLIT_MIN_ROWS:
        assert splits == 1
    else:
        assert splits > 1 and rows >= tbs.DW_SPLIT_MIN_ROWS


def _packed_epilogue(parts, layout, G, dtype):
    """The kernel's two passes on the CPU: the float32 partials (S, Nb,
    G*bs, R*bs) summed in split order, each (j, n, kk) written to the flat
    index the epilogue computes (j's base j*G*bs*R*bs plus
    ``out_at<true>``: ((kk / bs) * G*bs + n) * bs + kk % bs), rounded once
    to ``dtype``. -> (nnz, G*bs, bs)."""
    bs, R, Nb = layout.bs, layout.R, layout.Nb
    GB, RB = G * bs, R * bs
    dw3 = functools.reduce(torch.add, parts)
    j, n, kk = np.meshgrid(np.arange(Nb), np.arange(GB), np.arange(RB),
                           indexing="ij")
    flat = j * GB * RB + ((kk // bs) * GB + n) * bs + kk % bs
    assert sorted(flat.ravel()) == list(range(Nb * GB * RB))   # a bijection
    out = torch.empty(Nb * GB * RB)
    out[torch.from_numpy(flat.ravel())] = dw3.reshape(-1)
    return out.reshape(layout.nnz, GB, bs).to(dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("name", ["small_hcgs", "small_uneven"])
def test_legacy_dw_packed_epilogue_matches_twin(name, G, dt):
    """The split plan of the route's tile, a dw per split's rows, the
    partials summed in order and scattered through the epilogue's index
    map: the legacy twin within 1e-5 of its scale (float32) or one bf16
    ulp of it; the wrapper on CPU tensors is the twin."""
    tl = _small_legacy_layouts()[name]
    M, bs = 300, tl.bs
    rng = np.random.RandomState(G)
    gy = torch.from_numpy(rng.randn(M, tl.Nb * G * bs).astype(np.float32)
                          ).to(DT[dt])
    x = torch.from_numpy(rng.randn(M, tl.K).astype(np.float32)).to(DT[dt])
    route = tbs.legacy_dw_route(gy, x, bs)
    assert route == ("gemm" if dt == "f32" else "mma")
    _, splits, rows = tbs.dw_plan(M, tl.Nb, G, tl.R, bs,
                                  H100 if route == "gemm" else H100_MMA)
    assert splits > 1
    parts = [tbs.block_sparse_dw_plain(gy[s * rows:(s + 1) * rows].float(),
                                       x[s * rows:(s + 1) * rows].float(),
                                       tl, G) for s in range(splits)]
    got = _packed_epilogue(parts, tl, G, DT[dt])
    ref = tbs.bsl_dw_plain(gy, x, tl, G)
    wrapped = tbs.bsl_dw(gy, x, tl) if G == 1 else \
        tbs.bsl_dw_multi(gy, x, tl, G)
    assert got.dtype == ref.dtype == wrapped.dtype == DT[dt]
    assert torch.equal(wrapped, ref)
    scale = ref.float().abs().max().item()
    atol = ATOL * scale if dt == "f32" else \
        2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the legacy dw on the card (skips without one)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _legacy_layout(name):
    """chip_smoke.legacy_layouts()'s layouts: the two at bs=8, the libri
    GRU's x-projection (HCGS 128,4 at 75,50 on 1024 x 2048), the CGS-16x
    LSTM's 1024 x 1024 (128,8 at 75,75) and the flagship's 143-wide input
    (128,4 at 25,62.5, K-padded to 256)."""
    small = _small_legacy_layouts()
    if name in small:
        return small[name]
    N, K, blocks, drops, seed = {
        "libri_x": (1024, 2048, [128, 4], [75, 50], 170),
        "cgs16x": (1024, 1024, [128, 8], [75, 75], 171),
        "k_padded_143": (512, 143, [128, 4], [25, 62.5], 3)}[name]
    mask = hcgs_mask(N, K, blocks, drops, rng=np.random.RandomState(seed))
    return tbs.pack_layout(mask, 128, pad_k=K % 128 != 0)


LEGACY_NAMES = ("small_hcgs", "small_uneven", "libri_x", "cgs16x",
                "k_padded_143")
PAIRS = (("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32"))


def _legacy_operands(tl, G, M, dev, gdt, xdt, seed=0):
    """A flat cotangent (M, Nb*G*bs) and x (M, K; pad columns zero) on
    the card, in the asked dtypes."""
    gen = torch.Generator(device=dev).manual_seed(seed + M + G)
    x = torch.randn(M, tl.K, device=dev, generator=gen)
    x[:, tl.k_true:] = 0
    gy = torch.randn(M, tl.Nb * G * tl.bs, device=dev, generator=gen)
    return gy.to(DT[gdt]), x.to(DT[xdt])


def _legacy_dw_call(gy, x, tl, G):
    return tbs.bsl_dw(gy, x, tl) if G == 1 else \
        tbs.bsl_dw_multi(gy, x, tl, G)


def _assert_legacy_close(got, ref):
    assert got.dtype == ref.dtype
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    atol = 2.0 ** (np.floor(np.log2(scale)) - 7) if bf16 else ATOL * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("gdt,xdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("M", [7, 16, 4801, 6400])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_cuda_legacy_dw_matches_twin(cuda_device, name, G, M, gdt, xdt):
    """Each route against bsl_dw_plain on the same tensors: float32
    within 1e-5 of the twin's scale, a bf16 output within one bf16 ulp of
    it; one launch counted on the wrapper; the output in gy's dtype."""
    tl = _legacy_layout(name)
    gy, x = _legacy_operands(tl, G, M, cuda_device, gdt, xdt)
    want = {("f32", "f32"): "gemm", ("bf16", "bf16"): "mma"}.get(
        (gdt, xdt), "tile")
    assert tbs.legacy_dw_route(gy, x, tl.bs) == want
    wrapper = tbs.bsl_dw if G == 1 else tbs.bsl_dw_multi
    before = wrapper.launches
    got = _legacy_dw_call(gy, x, tl, G)
    assert wrapper.launches == before + 1
    ref = tbs.bsl_dw_plain(gy, x, tl, G)
    torch.cuda.synchronize()
    assert got.dtype == DT[gdt]
    _assert_legacy_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gy", "x"])
@pytest.mark.parametrize("dt,route", [("f32", "gemm"), ("bf16", "tile")])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", ["small_hcgs", "libri_x"])
def test_cuda_legacy_dw_misaligned_operand(cuda_device, name, M, dt, route,
                                           which):
    """One operand one element off a 16-byte boundary: float32 takes the
    float32 tile's scalar loads, bf16 the legacy file's bsl_dw_tile; both
    agree with the twin."""
    tl, G = _legacy_layout(name), 3
    ops = dict(zip(("gy", "x"), _legacy_operands(tl, G, M, cuda_device, dt,
                                                 dt)))
    ref = tbs.bsl_dw_plain(ops["gy"], ops["x"], tl, G)
    ops[which] = _offset(ops[which])
    assert tbs.legacy_dw_route(ops["gy"], ops["x"], tl.bs) == route
    if route == "gemm":
        assert not tbs.gemm_vec(tl.bs, ops["gy"], ops["x"])
    got = tbs.bsl_dw_multi(ops["gy"], ops["x"], tl, G)
    torch.cuda.synchronize()
    _assert_legacy_close(got, ref)


def _kernels_of(fn, tries=3):
    """The device kernels one call of ``fn`` launches, by short name, from
    torch.profiler's exported trace. A trace that holds fewer kernel
    records than the runtime's launch calls (the profiler drops some) is
    taken again, up to ``tries`` traces; where none was whole,
    ``{"cuda_launch_calls": n}`` of the launch calls."""
    import json
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        out, calls = {}, 0
        for e in events:
            name = str(e.get("name", ""))
            if e.get("cat") == "kernel":
                s = name.replace("(anonymous namespace)::", "")
                s = s[5:] if s.startswith("void ") else s
                k = re.match(r"[\w:]+", s).group(0).split("::")[-1]
                out[k] = out.get(k, 0) + 1
            elif e.get("cat") == "cuda_runtime" and name.startswith(
                    ("cudaLaunchKernel", "cuLaunchKernel")):
                calls += 1
        if out and sum(out.values()) >= calls:
            return out
    return {"cuda_launch_calls": calls}


@pytest.mark.cuda
@pytest.mark.parametrize("gdt,xdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("tag,M", [(t, LEGACY_TIMED[t][0])
                                   for t in sorted(LEGACY_TIMED)]
                         + [("libri_G3", 16)], ids=str)
def test_cuda_legacy_dw_device_kernels_and_bits(cuda_device, tag, M, gdt,
                                                xdt):
    """The timed shapes (and one M too short to split): two calls give the
    same bits; one call launches the route's tile, then dw_reduce where
    its plan splits M (bsl_dw_tile alone for the mixed pairs)."""
    G = LEGACY_TIMED[tag][2]
    tl = _legacy_layout("libri_x" if tag.startswith("libri") else "cgs16x")
    gy, x = _legacy_operands(tl, G, M, cuda_device, gdt, xdt, seed=7)
    route = tbs.legacy_dw_route(gy, x, tl.bs)
    a = _legacy_dw_call(gy, x, tl, G)
    b = _legacy_dw_call(gy, x, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if route == "tile":
        want = {"bsl_dw_tile": 1}
    else:
        grid = tbs.gemm_grid(cuda_device, "bs_mma" if route == "mma"
                             else "bs_gemm")
        splits = tbs.dw_plan(M, tl.Nb, G, tl.R, tl.bs, grid)[1]
        assert (splits > 1) == (M > 16)
        want = dict({"dw_mma" if route == "mma" else "dw_gemm": 1},
                    **({"dw_reduce": 1} if splits > 1 else {}))
    got = _kernels_of(lambda: _legacy_dw_call(gy, x, tl, G))
    assert got in (want, {"cuda_launch_calls": sum(want.values())})


@pytest.mark.cuda
def test_cuda_mma_grid_reads_the_library_and_the_card(cuda_device):
    """The bf16 tile's split grid: bs_mma.cuh's constants as the built
    library reports them, and the device's SM count."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    assert tbs.gemm_grid(cuda_device, "bs_mma") == tbs.GemmGrid(
        props.multi_processor_count, *_tile_constants("bs_mma.cuh"),
        tbs.PARTIAL_ROUND["bs_mma"])


# ---------------------------------------------------------------------------
# the legacy forward (rows 7 and 10): routes and the two new routes' index
# maps over CPU stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,w,bs,off,route", [
    ("f32", "f32", 128, None, "gemm"), ("f32", "f32", 6, None, "gemm"),
    ("f32", "f32", 128, "x", "gemm"), ("f32", "f32", 128, "w", "gemm"),
    ("f32", "bf16", 128, None, "gemm"), ("f32", "bf16", 8, "w", "gemm"),
    ("bf16", "bf16", 128, None, "mma"), ("bf16", "bf16", 8, None, "mma"),
    ("bf16", "bf16", 4, None, "tile"), ("bf16", "bf16", 12, None, "tile"),
    ("bf16", "bf16", 128, "x", "tile"), ("bf16", "bf16", 128, "w", "tile"),
    ("bf16", "f32", 128, None, "tile"), ("bf16", "f32", 8, None, "tile")],
    ids=str)
def test_legacy_fwd_route(x, w, bs, off, route):
    """float32 x (w either type): the v3 forward's float32 GEMM over the
    packed weight widened into scratch (its scalar loads where gemm_vec
    says: x is its only operand in global memory); both bf16 at bs a
    multiple of 8, 16-byte aligned: the K-major tensor-core tile; bf16 x
    with float32 w and the other bf16 pairs: the legacy file's
    bsl_fwd_tile."""
    ops = {}
    for name, dt in (("x", x), ("w", w)):
        base = torch.zeros(65, dtype=DT[dt])
        assert base.data_ptr() % 16 == 0
        ops[name] = base[1:] if off == name else base[:64]
    assert tbs.legacy_fwd_route(ops["x"], ops["w"], bs) == route
    if route == "gemm":
        assert tbs.gemm_vec(bs, ops["x"]) == (bs % 4 == 0 and off != "x")


def _small_fwd_operands(tl, G, M, xdt, wdt, seed):
    """x (M, K) and the packed w (nnz, G*bs, bs) on the CPU, in the asked
    dtypes."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, tl.K).astype(np.float32)).to(DT[xdt])
    w = torch.from_numpy((rng.randn(tl.nnz, G * tl.bs, tl.bs)
                          / np.sqrt(tl.R * tl.bs)).astype(np.float32)
                         ).to(DT[wdt])
    return x, w


def _legacy_fwd_call(x, w, tl, G):
    """The v1 wrapper at G=1 (as (1, M, N)), the v2 one above."""
    return tbs.bsl_fwd(x, w, tl)[None] if G == 1 else \
        tbs.bsl_fwd_multi(x, w, tl, G)


@pytest.mark.parametrize("wdt", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("name", ["small_hcgs", "small_uneven"])
def test_legacy_fwd_packed_transpose_matches_twin(name, G, wdt):
    """The "gemm" route on the CPU: packed_weight_t's index map
    (wt[j][kk][n] = w[j*R + kk / bs][n][kk % bs], a bijection, widened to
    float32) then the GEMM's contraction as block_sparse_v3_fwd_plain does
    it: bsl_fwd_plain within 1e-5 of its scale; the wrapper on CPU tensors
    is the twin, in x's dtype."""
    tl = _small_legacy_layouts()[name]
    bs, R, Nb = tl.bs, tl.R, tl.Nb
    GB, RB = G * bs, R * bs
    x, w = _small_fwd_operands(tl, G, 300, "f32", wdt, G)
    assert tbs.legacy_fwd_route(x, w, bs) == "gemm"
    j, kk, n = np.meshgrid(np.arange(Nb), np.arange(RB), np.arange(GB),
                           indexing="ij")
    src = ((j * R + kk // bs) * GB + n) * bs + kk % bs
    assert sorted(src.ravel()) == list(range(tl.nnz * GB * bs))
    wt = w.float().reshape(-1)[torch.from_numpy(src.ravel())] \
        .reshape(Nb, RB, GB)
    got = tbs.block_sparse_v3_fwd_plain(x, wt.transpose(1, 2), tl, G)
    ref = tbs.bsl_fwd_plain(x, w, tl, G)
    wrapped = _legacy_fwd_call(x, w.reshape(tl.nnz, GB, bs), tl, G)
    assert got.dtype == ref.dtype == wrapped.dtype == torch.float32
    assert torch.equal(wrapped, ref)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=ATOL * ref.abs().max().item())


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", ["small_hcgs", "small_uneven"])
def test_legacy_fwd_mma_operand_maps_match_twin(name, G):
    """The "mma" route on the CPU: fwd_mma's operand lines (A's line m,
    k = kk: x[m, col_idx[j*R + kk / bs]*bs + kk % bs]; B's line n:
    w[j*R + kk / bs][n][kk % bs]) contracted in float32, its epilogue's
    column map (n = g*bs + r -> ys[g][m, j*bs + r]) and one rounding to
    bf16: bsl_fwd_plain within one bf16 ulp of its scale; the wrapper on
    CPU tensors is the twin, in bf16."""
    tl = _small_legacy_layouts()[name]
    bs, R, Nb, M = tl.bs, tl.R, tl.Nb, 37
    GB, RB = G * bs, R * bs
    x, w = _small_fwd_operands(tl, G, M, "bf16", "bf16", 10 + G)
    assert tbs.legacy_fwd_route(x, w, bs) == "mma"
    kk = np.arange(RB)
    xcol = tl.col_idx.reshape(Nb, R)[:, kk // bs] * bs + kk % bs  # (Nb, RB)
    A = x.float()[:, torch.from_numpy(xcol.ravel())].reshape(M, Nb, RB)
    j, n, k = np.meshgrid(np.arange(Nb), np.arange(GB), kk, indexing="ij")
    B = w.float().reshape(-1)[torch.from_numpy(
        (((j * R + k // bs) * GB + n) * bs + k % bs).ravel())] \
        .reshape(Nb, GB, RB)
    acc = torch.einsum("mjk,jnk->jmn", A, B)                     # (Nb, M, GB)
    ys = torch.empty(G, M, tl.N)
    for jj in range(Nb):
        for nn in range(GB):
            g, r = divmod(nn, bs)
            ys[g, :, jj * bs + r] = acc[jj, :, nn]
    got = ys.to(torch.bfloat16)
    ref = tbs.bsl_fwd_plain(x, w, tl, G)
    wrapped = _legacy_fwd_call(
        x, w.reshape(tl.nnz, bs, bs) if G == 1 else w, tl, G)
    assert got.dtype == ref.dtype == wrapped.dtype == torch.bfloat16
    assert torch.equal(wrapped, ref)
    _assert_legacy_close(got, ref)


# ---------------------------------------------------------------------------
# the legacy forward on the card (skips without one)
# ---------------------------------------------------------------------------

FWD_ROUTE = {("f32", "f32"): "gemm", ("f32", "bf16"): "gemm",
             ("bf16", "bf16"): "mma", ("bf16", "f32"): "tile"}
FWD_KERNELS = {"gemm": {"packed_weight_t": 1, "v3_fwd_gemm": 1},
               "mma": {"fwd_mma": 1}, "tile": {"bsl_fwd_tile": 1}}


def _legacy_fwd_operands(tl, G, M, dev, xdt, wdt, seed=0):
    """x (M, K; pad columns zero) and the packed w (nnz, G*bs, bs; (nnz,
    bs, bs) at G=1) on the card, in the asked dtypes."""
    gen = torch.Generator(device=dev).manual_seed(seed + M + G)
    x = torch.randn(M, tl.K, device=dev, generator=gen)
    x[:, tl.k_true:] = 0
    w = torch.randn(tl.nnz, G * tl.bs, tl.bs, device=dev, generator=gen) \
        / np.sqrt(tl.R * tl.bs)
    return x.to(DT[xdt]), w.to(DT[wdt])


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("M", [7, 16, 4801, 6400])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_cuda_legacy_fwd_matches_twin(cuda_device, name, G, M, xdt, wdt):
    """Each route against bsl_fwd_plain on the same tensors: float32
    within 1e-5 of the twin's scale, a bf16 output within one bf16 ulp of
    it; one launch counted on the wrapper; the output in x's dtype."""
    tl = _legacy_layout(name)
    x, w = _legacy_fwd_operands(tl, G, M, cuda_device, xdt, wdt)
    assert tbs.legacy_fwd_route(x, w, tl.bs) == FWD_ROUTE[(xdt, wdt)]
    wrapper = tbs.bsl_fwd if G == 1 else tbs.bsl_fwd_multi
    before = wrapper.launches
    got = _legacy_fwd_call(x, w, tl, G)
    assert wrapper.launches == before + 1
    ref = tbs.bsl_fwd_plain(x, w, tl, G)
    torch.cuda.synchronize()
    assert got.dtype == DT[xdt] and got.shape == (G, M, tl.N)
    _assert_legacy_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["x", "w"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", ["small_hcgs", "libri_x"])
def test_cuda_legacy_fwd_misaligned_operand(cuda_device, name, M, dt, which):
    """One operand one element off a 16-byte boundary: float32 stays on
    the GEMM (x misaligned: its scalar loads; w is read by the transposer
    only), bf16 goes to bsl_fwd_tile; both agree with the twin."""
    tl, G = _legacy_layout(name), 3
    ops = dict(zip(("x", "w"), _legacy_fwd_operands(tl, G, M, cuda_device,
                                                    dt, dt)))
    ref = tbs.bsl_fwd_plain(ops["x"], ops["w"], tl, G)
    ops[which] = _offset(ops[which])
    route = tbs.legacy_fwd_route(ops["x"], ops["w"], tl.bs)
    assert route == ("gemm" if dt == "f32" else "tile")
    if route == "gemm":
        assert tbs.gemm_vec(tl.bs, ops["x"]) == (which == "w")
    got = tbs.bsl_fwd_multi(ops["x"], ops["w"], tl, G)
    torch.cuda.synchronize()
    _assert_legacy_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("tag", sorted(LEGACY_TIMED))
def test_cuda_legacy_fwd_device_kernels(cuda_device, tag, xdt, wdt):
    """The timed shapes: one call launches the route's kernels, the
    transposer and the GEMM on "gemm", fwd_mma alone on "mma",
    bsl_fwd_tile alone on "tile"; two calls give the same bits."""
    M, _, G, _, _ = LEGACY_TIMED[tag]
    tl = _legacy_layout("libri_x" if tag.startswith("libri") else "cgs16x")
    x, w = _legacy_fwd_operands(tl, G, M, cuda_device, xdt, wdt, seed=7)
    want = FWD_KERNELS[tbs.legacy_fwd_route(x, w, tl.bs)]
    a = _legacy_fwd_call(x, w, tl, G)
    b = _legacy_fwd_call(x, w, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    got = _kernels_of(lambda: _legacy_fwd_call(x, w, tl, G))
    assert got in (want, {"cuda_launch_calls": sum(want.values())})


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_cuda_legacy_api_matches_dense_masked(cuda_device, name, G):
    """block_sparse_matmul (G=1) / block_sparse_matmul_multi forward and
    backward on the card, float32, against the dense masked product
    (TF32 off): y, dx and dw within 1e-5 of their scale; one forward, one
    dx and one dw launch per call."""
    tl = _legacy_layout(name)
    M = 240
    x, w = _legacy_fwd_operands(tl, G, M, cuda_device, "f32", "f32", seed=3)
    bs, Nb, Kb = tl.bs, tl.Nb, tl.Kb
    rows = torch.as_tensor(tl.rows, dtype=torch.long, device=cuda_device)
    cols = torch.as_tensor(tl.cols, dtype=torch.long, device=cuda_device)
    dense = torch.zeros(G, Nb, Kb, bs, bs, device=cuda_device)
    dense[:, rows, cols] = w.reshape(tl.nnz, G, bs, bs).transpose(0, 1)
    W = dense.permute(0, 1, 3, 2, 4).reshape(G, tl.N, tl.K)
    cot = torch.randn(G, M, tl.N, device=cuda_device,
                      generator=torch.Generator(device=cuda_device)
                      .manual_seed(G))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    v = "" if G == 1 else "_multi"
    wrappers = [getattr(tbs, "bsl_%s%s" % (op, v))
                for op in ("fwd", "dx", "dw")]
    before = [f.launches for f in wrappers]
    if G == 1:
        y = tbs.block_sparse_matmul(xt, wt, tl, M)[None]
    else:
        y = tbs.block_sparse_matmul_multi(xt, wt, tl, G, M)
    y.backward(cot)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [1, 1, 1]
    dW = torch.einsum("gmn,mk->gnk", cot, x).reshape(
        G, Nb, bs, Kb, bs).permute(1, 3, 0, 2, 4)
    for got, ref in ((y.detach(), torch.einsum("mk,gnk->gmn", x, W)),
                     (xt.grad, torch.einsum("gmn,gnk->mk", cot, W)),
                     (wt.grad, dW[rows, cols].reshape(wt.shape))):
        _assert_legacy_close(got, ref)


# ---------------------------------------------------------------------------
# the legacy dx (rows 8 and 11): routes, the work plan and the two new
# routes' operand maps over CPU stand-ins
# ---------------------------------------------------------------------------

DX_GRID = {"gemm": H100,
           "mma": tbs.GemmGrid(SMS, *_tile_constants("block_sparse_dx.cu"))}


@pytest.mark.parametrize("gy,w,bs,off,route", [
    ("f32", "f32", 128, None, "gemm"), ("f32", "f32", 6, None, "gemm"),
    ("f32", "f32", 128, "gy", "gemm"), ("f32", "f32", 128, "w", "gemm"),
    ("bf16", "bf16", 128, None, "mma"), ("bf16", "bf16", 8, None, "mma"),
    ("bf16", "bf16", 4, None, "tile"), ("bf16", "bf16", 12, None, "tile"),
    ("bf16", "bf16", 128, "gy", "tile"), ("bf16", "bf16", 128, "w", "tile"),
    ("f32", "bf16", 128, None, "tile"), ("bf16", "f32", 128, None, "tile"),
    ("f32", "bf16", 8, None, "tile"), ("bf16", "f32", 8, None, "tile")],
    ids=str)
def test_legacy_dx_route(gy, w, bs, off, route):
    """Both float32: the float32 tile (its scalar loads where gemm_vec
    says); both bf16 at bs a multiple of 8, 16-byte aligned: the
    mixed-major tensor-core tile; the mixed pairs and the other bf16
    ones: the legacy file's bsl_dx_tile."""
    ops = {}
    for name, dt in (("gy", gy), ("w", w)):
        base = torch.zeros(65, dtype=DT[dt])
        assert base.data_ptr() % 16 == 0
        ops[name] = base[1:] if off == name else base[:64]
    assert tbs.legacy_dx_route(ops["gy"], ops["w"], bs) == route
    if route == "gemm":
        assert tbs.gemm_vec(bs, ops["gy"], ops["w"]) == (bs % 4 == 0
                                                         and off is None)


def _plan_of(tl, M, G, route, split=None):
    return tbs.legacy_dx_plan(tl, M, G, route, DX_GRID[route], split)


def _assert_plan_covers(plan, counts):
    """Every entry of every column in exactly one item, a column no row
    keeps in one empty item; the heaviest items first; the split columns'
    parts on consecutive slots, each slot once, listed in the reduce."""
    sizes = [e1 - e0 for _, e0, e1, _ in plan.items]
    assert sizes == sorted(sizes, reverse=True)
    by_col = {}
    for col, e0, e1, slot in plan.items:
        by_col.setdefault(col, []).append((e0, e1, slot))
    assert sorted(by_col) == list(range(len(counts)))
    slots = []
    for col, n in enumerate(counts):
        parts = sorted(by_col[col])
        covered = [e for e0, e1, _ in parts for e in range(e0, e1)]
        assert covered == list(range(n))
        if len(parts) == 1:
            assert parts[0][2] == -1
        else:
            first = min(s for _, _, s in parts)
            assert [s for _, _, s in parts] == list(
                range(first, first + len(parts)))
            assert (col, first, len(parts)) in plan.reduce
            slots += [s for _, _, s in parts]
    assert sorted(slots) == list(range(plan.parts))
    assert len(plan.reduce) == sum(1 for c in by_col.values() if len(c) > 1)


@pytest.mark.parametrize("route", ["gemm", "mma"])
@pytest.mark.parametrize("tag", sorted(LEGACY_TIMED))
def test_legacy_dx_plan_at_the_timed_shapes(tag, route):
    """The plan at the three timed shapes on the H100's grid: it covers
    every entry of every column once, is the least modelled time of the
    splits it weighs, and its list schedule fills the rounds it takes: the
    busiest slot ends within one of its heaviest blocks of the mean load.
    The picks: no split but at the CGS-16x G=4 in float32, where the
    4-entry column is cut into single entries (partials and a reduce)."""
    M, _, G, _, _ = LEGACY_TIMED[tag]
    tl = _legacy_layout("libri_x" if tag.startswith("libri") else "cgs16x")
    counts = tbs.column_counts(tl)
    assert counts == ((3, 4, 3, 3, 1, 0, 3, 3, 1, 2, 3, 1, 1, 1, 0, 3)
                      if tag.startswith("libri") else (4, 1, 2, 2, 2, 2, 2, 1))
    plan = _plan_of(tl, M, G, route)
    _assert_plan_covers(plan, counts)
    alts = [_plan_of(tl, M, G, route, sp) for sp in tbs.dx_splits(counts)]
    assert plan.cost_us == min(a.cost_us for a in alts)
    split = tag == "cgs16x_G4" and route == "gemm"
    assert (plan.parts > 0) == split
    assert plan.split == ((3, 1) if split else (4, 4))
    grid, GB = DX_GRID[route], G * tl.bs
    blocks = -(-M // grid.tile)
    cost = [-(-(e1 - e0) * GB // grid.bk) + tbs.DW_BLOCK_OVERHEAD_SLABS
            for _, e0, e1, _ in plan.items]
    mean = blocks * sum(cost) / (grid.sms * grid.blocks_per_sm)
    kernel = plan.cost_us - (2 * plan.parts * M * tl.bs * 4
                             / tbs.HBM_BYTES_PER_US + tbs.DX_REDUCE_US
                             if plan.parts else 0)
    assert mean <= kernel / tbs.DX_SLAB_US[route] <= mean + max(cost)


def _dx_emulated(gy, w, tl, G, plan):
    """The kernels' two passes on the CPU: per item, A's lines (gy[m,
    t_row_idx[e]*G*bs + n] at k = e*G*bs + n, the item's real entries
    only: no pad block) against B's k-lines (w[t_perm[e]][n][c]) in
    float32; an unsplit item rounds once into its column block of dx, a
    split part writes its float32 partial plane; then each split column's
    partials summed in part order and rounded once. Every element of dx
    is written (it starts NaN)."""
    M, bs, C = gy.shape[0], tl.bs, tl.C
    GB = G * bs
    dx = torch.full((M, tl.K), float("nan")).to(gy.dtype)
    part = torch.full((plan.parts, M, bs), float("nan"))
    gyf, wf = gy.float(), w.float().reshape(-1)
    for col, e0, e1, slot in plan.items:
        k = np.arange((e1 - e0) * GB)
        e, n = col * C + e0 + k // GB, k % GB
        p = tl.t_perm[e]
        assert (p < tl.nnz).all()
        A = gyf[:, torch.from_numpy(tl.t_row_idx[e] * GB + n)]
        B = wf[torch.from_numpy(((p * GB + n) * bs)[:, None]
                                + np.arange(bs)[None, :])]
        acc = A @ B if len(k) else torch.zeros(M, bs)
        if slot < 0:
            dx[:, col * bs:(col + 1) * bs] = acc.to(gy.dtype)
        else:
            part[slot] = acc
    for col, s0, parts in plan.reduce:
        acc = part[s0]
        for s in range(1, parts):
            acc = acc + part[s0 + s]
        dx[:, col * bs:(col + 1) * bs] = acc.to(gy.dtype)
    assert not torch.isnan(dx.float()).any()
    return dx


@pytest.mark.parametrize("split", ["plan", "finest"])
@pytest.mark.parametrize("route", ["gemm", "mma"])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", ["small_hcgs", "small_uneven"])
def test_legacy_dx_operand_maps_match_twin(name, G, route, split):
    """The "gemm" (float32) and "mma" (bf16) routes on the CPU: the plan
    (its own pick, or every column with more than one entry cut into
    single entries), the operand maps and the reduce (_dx_emulated):
    bsl_dx_plain within 1e-5 of its scale (float32) or one bf16 ulp of
    it; a column no row keeps is zero; the wrapper on CPU tensors is the
    twin, in gy's dtype."""
    tl = _small_legacy_layouts()[name]
    bs, M = tl.bs, 37
    dt = "f32" if route == "gemm" else "bf16"
    rng = np.random.RandomState(20 + G)
    gy = torch.from_numpy(rng.randn(M, tl.Nb * G * bs).astype(np.float32)
                          ).to(DT[dt])
    w = torch.from_numpy((rng.randn(tl.nnz, G * bs, bs) / np.sqrt(G * bs))
                         .astype(np.float32)).to(DT[dt])
    assert tbs.legacy_dx_route(gy, w, bs) == route
    counts = tbs.column_counts(tl)
    plan = _plan_of(tl, M, G, route,
                    None if split == "plan" else tbs.dx_splits(counts)[-1])
    _assert_plan_covers(plan, counts)
    if split == "finest":
        assert plan.parts == sum(n for n in counts if n > 1)
    got = _dx_emulated(gy, w, tl, G, plan)
    ref = tbs.bsl_dx_plain(gy, w, tl, G)
    wrapped = tbs.bsl_dx(gy, w.reshape(tl.nnz, bs, bs), tl) if G == 1 else \
        tbs.bsl_dx_multi(gy, w, tl, G)
    assert got.dtype == ref.dtype == wrapped.dtype == DT[dt]
    assert torch.equal(wrapped, ref)
    for col, n in enumerate(counts):
        if n == 0:
            assert not got[:, col * bs:(col + 1) * bs].float().any()
    _assert_legacy_close(got, ref)


# ---------------------------------------------------------------------------
# the legacy dx on the card (skips without one)
# ---------------------------------------------------------------------------

DX_ROUTE = {("f32", "f32"): "gemm", ("bf16", "bf16"): "mma",
            ("f32", "bf16"): "tile", ("bf16", "f32"): "tile"}


def _legacy_dx_operands(tl, G, M, dev, gdt, wdt, seed=0):
    """A flat cotangent (M, Nb*G*bs) and the packed w (nnz, G*bs, bs) on
    the card, in the asked dtypes."""
    gen = torch.Generator(device=dev).manual_seed(seed + M + G)
    gy = torch.randn(M, tl.Nb * G * tl.bs, device=dev, generator=gen)
    w = torch.randn(tl.nnz, G * tl.bs, tl.bs, device=dev, generator=gen) \
        / np.sqrt(G * tl.bs)
    return gy.to(DT[gdt]), w.to(DT[wdt])


def _legacy_dx_call(gy, w, tl, G):
    return tbs.bsl_dx(gy, w.reshape(tl.nnz, tl.bs, tl.bs), tl) if G == 1 \
        else tbs.bsl_dx_multi(gy, w, tl, G)


def _assert_empty_columns_zero(got, tl):
    for col, n in enumerate(tbs.column_counts(tl)):
        if n == 0:
            assert not got[:, col * tl.bs:(col + 1) * tl.bs].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("gdt,wdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("M", [7, 16, 4801, 6400])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_cuda_legacy_dx_matches_twin(cuda_device, name, G, M, gdt, wdt):
    """Each route against bsl_dx_plain on the same tensors: float32
    within 1e-5 of the twin's scale, a bf16 output within one bf16 ulp of
    it; columns no row keeps are zero; one launch counted on the wrapper;
    the output in gy's dtype; a second call gives the same bits."""
    tl = _legacy_layout(name)
    gy, w = _legacy_dx_operands(tl, G, M, cuda_device, gdt, wdt)
    assert tbs.legacy_dx_route(gy, w, tl.bs) == DX_ROUTE[(gdt, wdt)]
    wrapper = tbs.bsl_dx if G == 1 else tbs.bsl_dx_multi
    before = wrapper.launches
    got = _legacy_dx_call(gy, w, tl, G)
    assert wrapper.launches == before + 1
    again = _legacy_dx_call(gy, w, tl, G)
    ref = tbs.bsl_dx_plain(gy, w, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.dtype == DT[gdt] and got.shape == (M, tl.K)
    _assert_empty_columns_zero(got, tl)
    _assert_legacy_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_cuda_legacy_dx_split_plan(cuda_device, monkeypatch, name, G, M, dt):
    """The finest split of dx_splits forced (every column with more than
    one entry cut into single entries, each writing a float32 partial,
    dx_reduce summing them): the twin within the same bar, two calls bit
    for bit."""
    tl = _legacy_layout(name)
    gy, w = _legacy_dx_operands(tl, G, M, cuda_device, dt, dt, seed=5)
    finest = tbs.dx_splits(tbs.column_counts(tl))[-1]
    plan = tbs.dx_plan
    monkeypatch.setattr(tbs, "dx_plan",
                        lambda *a: plan(*a[:6], split=finest))
    a = _legacy_dx_call(gy, w, tl, G)
    b = _legacy_dx_call(gy, w, tl, G)
    ref = tbs.bsl_dx_plain(gy, w, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _assert_empty_columns_zero(a, tl)
    _assert_legacy_close(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gy", "w"])
@pytest.mark.parametrize("dt,route", [("f32", "gemm"), ("bf16", "tile")])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", ["small_hcgs", "libri_x"])
def test_cuda_legacy_dx_misaligned_operand(cuda_device, name, M, dt, route,
                                           which):
    """One operand one element off a 16-byte boundary: float32 takes the
    float32 tile's scalar loads, bf16 the legacy file's bsl_dx_tile; both
    agree with the twin."""
    tl, G = _legacy_layout(name), 3
    ops = dict(zip(("gy", "w"), _legacy_dx_operands(tl, G, M, cuda_device,
                                                    dt, dt)))
    ref = tbs.bsl_dx_plain(ops["gy"], ops["w"], tl, G)
    ops[which] = _offset(ops[which])
    assert tbs.legacy_dx_route(ops["gy"], ops["w"], tl.bs) == route
    if route == "gemm":
        assert not tbs.gemm_vec(tl.bs, ops["gy"], ops["w"])
    got = tbs.bsl_dx_multi(ops["gy"], ops["w"], tl, G)
    torch.cuda.synchronize()
    _assert_legacy_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("gdt,wdt", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("tag", sorted(LEGACY_TIMED))
def test_cuda_legacy_dx_device_kernels_and_bits(cuda_device, tag, gdt, wdt):
    """The timed shapes: two calls give the same bits; one call launches
    the route's tile, then dx_reduce where its plan splits (bsl_dx_tile
    alone for the mixed pairs)."""
    M, _, G, _, _ = LEGACY_TIMED[tag]
    tl = _legacy_layout("libri_x" if tag.startswith("libri") else "cgs16x")
    gy, w = _legacy_dx_operands(tl, G, M, cuda_device, gdt, wdt, seed=7)
    route = tbs.legacy_dx_route(gy, w, tl.bs)
    a = _legacy_dx_call(gy, w, tl, G)
    b = _legacy_dx_call(gy, w, tl, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if route == "tile":
        want = {"bsl_dx_tile": 1}
    else:
        grid = tbs.gemm_grid(cuda_device, tbs.DX_TILE[route])
        assert grid == dataclasses.replace(DX_GRID[route], sms=grid.sms)
        plan = tbs.legacy_dx_plan(tl, M, G, route, grid)
        want = dict({"dx_gemm" if route == "gemm" else "dx_mma": 1},
                    **({"dx_reduce": 1} if plan.parts else {}))
    got = _kernels_of(lambda: _legacy_dx_call(gy, w, tl, G))
    assert got in (want, {"cuda_launch_calls": sum(want.values())})


# ---------------------------------------------------------------------------
# the v3 dx on the legacy dx's float32 tile (TPU row 14): the effective
# weight packed once, then dx_gemm over dx_plan's items
# ---------------------------------------------------------------------------

def _v3_dx_operands(name, G, qbits, with_sub, M, seed=0, dev="cpu"):
    """LAYOUTS' layout, a flat cotangent (M, Nb*G*bs), w3 (Nb, G*bs,
    R*bs) with entries past the quantizer's clip, and the G gates' stacked
    submask (or None) on ``dev``."""
    mask, tl = _layout(name)
    rng = np.random.RandomState(seed + 31 * G + qbits)
    gy = rng.randn(M, tl.Nb * G * tl.bs).astype(np.float32)
    w3 = (rng.randn(tl.Nb, G * tl.bs, tl.R * tl.bs) * 0.6).astype(np.float32)
    sub3 = tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G) if with_sub \
        else None
    d = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return tl, d(gy), d(w3), d(sub3)


V3_DX_NAMES = ("bs8_r2", "bs8_padk", "bs6_r4", "bs6_padk")


@pytest.mark.parametrize("split", ["plan", "finest"])
@pytest.mark.parametrize("G,qbits,with_sub", [(1, 0, False), (3, 8, True)])
@pytest.mark.parametrize("name", V3_DX_NAMES)
def test_v3_dx_packed_weight_and_operand_maps_match_twin(name, G, qbits,
                                                         with_sub, split):
    """On the CPU: the weight pass's twin (v3_weight_packed_plain) read as
    the legacy packed weight through dx_gemm's operand maps, the plan's
    items and the reduce (_dx_emulated), at the plan's pick and at the
    finest split: the v3 dx twin within 1e-5 of its scale, columns no row
    keeps zero; bs 8 takes gemm_vec's 16-byte loads, bs 6 the 4-byte
    ones."""
    tl, gy, w3, sub3 = _v3_dx_operands(name, G, qbits, with_sub, 37)
    wp = tbs.v3_weight_packed_plain(w3, tl, G, qbits, sub3)
    assert tuple(wp.shape) == (tl.nnz, G * tl.bs, tl.bs)
    assert tbs.gemm_vec(tl.bs, gy, wp) == (tl.bs % 4 == 0)
    counts = tbs.column_counts(tl)
    plan = _plan_of(tl, gy.shape[0], G, "gemm",
                    None if split == "plan" else tbs.dx_splits(counts)[-1])
    _assert_plan_covers(plan, counts)
    got = _dx_emulated(gy, wp, tl, G, plan)
    ref = tbs.block_sparse_v3_dx_plain(gy, w3, tl, G, qbits, sub3)
    assert torch.equal(tbs.block_sparse_v3_dx(gy, w3, tl, G, qbits, sub3),
                       ref)
    _assert_empty_columns_zero(got, tl)
    _assert_legacy_close(got, ref)


@pytest.mark.parametrize("M, G", [(6400, 3), (6368, 3), (6400, 1), (24, 3)])
def test_v3_dx_plan_at_the_libri_layout(M, G):
    """dx_plan over the libri GRU's x-projection layout's column counts (0
    to 4 kept blocks a column) at its train M (T*B = 6400), serve M (398 x
    16) and a short M: every entry of every column once, the least
    modelled time of the splits it weighs; no split at the libri shapes
    (the 4-entry column's 4 x 3 x 128 contraction is 96 slabs of 16, the
    whole dispatch two rounds)."""
    tl = _legacy_layout("libri_x")
    counts = tbs.column_counts(tl)
    assert min(counts) == 0 and max(counts) == 4
    plan = _plan_of(tl, M, G, "gemm")
    _assert_plan_covers(plan, counts)
    alts = [_plan_of(tl, M, G, "gemm", sp) for sp in tbs.dx_splits(counts)]
    assert plan.cost_us == min(a.cost_us for a in alts)
    if M >= 6368:
        assert plan.split == (4, 4) and plan.parts == 0


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["plan", "finest"])
@pytest.mark.parametrize("G,qbits,with_sub", [(1, 0, False), (3, 8, True),
                                              (4, 8, False)])
@pytest.mark.parametrize("M", [7, 4801])
@pytest.mark.parametrize("name", V3_DX_NAMES + ("bs128_cgs16x",))
def test_cuda_v3_dx_matches_twin(cuda_device, monkeypatch, name, M, G, qbits,
                                 with_sub, split):
    """The v3 dx on the card (the weight pass, dx_gemm over the plan's
    items, dx_reduce where it splits) against its twin within 1e-5 of its
    scale at bs 8 and 128 (16-byte loads) and bs 6 (4-byte loads), with
    the quantizer and the submask, at the plan's pick and the finest
    split; two calls bit for bit; one launch counted a call."""
    tl, gy, w3, sub3 = _v3_dx_operands(name, G, qbits, with_sub, M,
                                       dev=cuda_device)
    if split == "finest":
        finest = tbs.dx_splits(tbs.column_counts(tl))[-1]
        plan = tbs.dx_plan
        monkeypatch.setattr(tbs, "dx_plan",
                            lambda *a: plan(*a[:6], split=finest))
    before = tbs.block_sparse_v3_dx.launches
    a = tbs.block_sparse_v3_dx(gy, w3, tl, G, qbits, sub3)
    b = tbs.block_sparse_v3_dx(gy, w3, tl, G, qbits, sub3)
    assert tbs.block_sparse_v3_dx.launches == before + 2
    ref = tbs.block_sparse_v3_dx_plain(gy, w3, tl, G, qbits, sub3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _assert_empty_columns_zero(a, tl)
    _assert_legacy_close(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [7, 6400])
def test_cuda_v3_dx_misaligned_gy_and_device_kernels(cuda_device, M):
    """The libri x-projection layout at G=3 with the quantizer and the
    submask: gy one element off a 16-byte boundary takes dx_gemm's 4-byte
    loads and agrees with the twin; an aligned call launches the weight
    pass, dx_gemm and, where its plan splits, dx_reduce."""
    tl, G = _legacy_layout("libri_x"), 3
    gen = torch.Generator(device=cuda_device).manual_seed(M)
    gy = torch.randn(M, tl.Nb * G * tl.bs, device=cuda_device, generator=gen)
    w3 = torch.randn(tl.Nb, G * tl.bs, tl.R * tl.bs, device=cuda_device,
                     generator=gen) * 0.6
    sub3 = (torch.rand(w3.shape, device=cuda_device, generator=gen)
            > 0.5).float()
    ref = tbs.block_sparse_v3_dx_plain(gy, w3, tl, G, 8, sub3)
    gyo = _offset(gy)
    assert not tbs.gemm_vec(tl.bs, gyo)
    got = tbs.block_sparse_v3_dx(gyo, w3, tl, G, 8, sub3)
    torch.cuda.synchronize()
    _assert_legacy_close(got, ref)
    grid = tbs.gemm_grid(cuda_device, "bs_gemm")
    plan = tbs.legacy_dx_plan(tl, M, G, "gemm", grid)
    want = dict({"v3_weight_packed": 1, "dx_gemm": 1},
                **({"dx_reduce": 1} if plan.parts else {}))
    got = _kernels_of(lambda: tbs.block_sparse_v3_dx(gy, w3, tl, G, 8, sub3))
    assert got in (want, {"cuda_launch_calls": sum(want.values())})
