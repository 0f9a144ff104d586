"""The register-blocked GEMM kernels of the port's block-sparse ops
(pytorch_kaldi_cgs_tpu_torch/ops/block_sparse.py: the dw kernel,
``csrc/block_sparse_dw.cu``, and the v3 forward, ``csrc/block_sparse_v3.cu``,
on the tile of ``csrc/bs_gemm.cuh``).

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
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

ATOL = 1e-5


def _tile_constants():
    """TILE, BK and MIN_BLOCKS as csrc/bs_gemm.cuh defines them (the
    built library reports the same through ``bs_gemm_config``)."""
    with open(os.path.join(os.path.dirname(tbs.__file__), "csrc",
                           "bs_gemm.cuh")) as f:
        src = f.read()
    return [int(re.search(r"constexpr int %s = (\d+);" % n, src).group(1))
            for n in ("TILE", "BK", "MIN_BLOCKS")]


SMS = 132                       # the H100 SXM's
H100 = tbs.GemmGrid(SMS, *_tile_constants())

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
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (the caching allocator's blocks start on 512)."""
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
