"""The plans and routes of the persistent chains (pytorch_kaldi_cgs_tpu_
torch/ops/fused_rnn.py over csrc/persist.cuh): the GRU BPTTs' reverse
chains, the liGRU recompute BPTT's and forward's, the minimalGRU
recompute BPTT's, the sparse GRU forward's and the dense GRU and
minimalGRU forward's, in pure Python: which route and grid each wrapper
picks for given shapes, SM counts and shared memory, the slabs a staged
row is cut into, the launches it then counts, and the staging layout's
claim that the 32 lanes of a warp read 32 banks. The kernels themselves
are held against their twins by the ``cuda`` cases of
tests/test_torch_gru.py, tests/test_torch_gru_cudnn.py,
tests/test_torch_ligru.py, tests/test_torch_libri_ligru.py and
tests/test_torch_mgru.py, and the dense GRU forward's by this file's
(every instantiated block shape and both routes)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

H100_SMS = 132


def _libri_layout():
    """The libri GRU's recurrent layout at chip_smoke.py's timed seed
    (HCGS 128,4 at 75,50 over 1024 x 1024)."""
    mask = hcgs_mask(1024, 1024, [128, 4], [75, 50],
                     rng=np.random.RandomState(150))
    return tbs.pack_layout(mask, 128)


# ---------------------------------------------------------------------------
# the torch-semantics GRU (TPU row 23)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, grid, smem", [
    (8, 550, 1, 69, 107968),       # the TIMIT GRU_cudnn layer
    (3, 18, 1, 3, 4 * (54 * 8 + 8 * 60 + 8 * 8 * 8)),
    (13, 45, 4, 6, 4 * (135 * 8 + 32 * 140 + 8 * 32 * 8)),
    (40, 61, 4, 16, 4 * (183 * 8 + 32 * 188 + 8 * 32 * 8)),
    (8, 1056, 1, 132, 204928),     # one block on each of the 132 SMs
])
def test_gru_torch_plan(B, H, bi, grid, smem):
    """Blocks of 8 units and 8 (B <= 8) or 32 rows; the shared memory is
    the units' 3H columns of W_hh, the staged rows (3H rounded up to 8,
    plus 4) and the dots' partials."""
    plan = tfr.gru_torch_bwd_plan(B, H)
    assert (plan.bi, plan.grid, plan.smem, plan.static) == (bi, grid, smem,
                                                            0)
    assert plan.resident == 4 * 3 * H * 8
    assert plan.staged == 4 * min(8 * bi, B) * 3 * H


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 550, 1, "persist"),
    (8, 1056, 1, "persist"),
    (8, 1064, 1, "step"),          # 133 blocks, one an SM
    (8, 1064, 2, "persist"),
    (8, 1200, 2, "step"),          # 232,576 bytes: more than a block has
    (16, 550, 1, "step"),          # 32 rows of 1650: 273,472 bytes
    (8, 2418, 1, "step"),          # the dense width limit: the step route
])
def test_gru_torch_route(B, H, blocks_per_sm, route):
    plan = tfr.gru_torch_bwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_gru_torch_route_needs_cooperative_launch_and_room():
    plan = tfr.gru_torch_bwd_plan(8, 550)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, 68) == "step"     # 69 blocks


def test_dense_width_limit_is_the_step_kernels():
    """The wrapper's width limit is the per-step kernels' (the route at
    the limit): the persistent chain's block stops fitting long before."""
    limit = tfl.dense_max_width("gru_torch", "recompute")
    assert limit == (tfl._SMEM_MAX - 256) // 96
    assert tfr.persist_route(tfr.gru_torch_bwd_plan(1, limit), 1,
                             H100_SMS) == "step"
    widest = max(h for h in range(8, limit, 8) if tfr.persist_route(
        tfr.gru_torch_bwd_plan(8, h), 1, H100_SMS) == "persist")
    assert widest == 1056


# ---------------------------------------------------------------------------
# the sparse GRU (TPU row 33)
# ---------------------------------------------------------------------------

def test_libri_layout_columns():
    """The timed layout's block columns hold 0-3 kept blocks: the heaviest
    block of the chain has 3 entries, one column none."""
    layout = _libri_layout()
    assert tbs.column_counts(layout) == (2, 2, 3, 0, 2, 3, 1, 3)
    assert layout.C == 3


@pytest.mark.parametrize("B, bi, units, grid", [
    (32, 2, 16, 128), (5, 1, 8, 128), (40, 2, 16, 192), (160, 2, 16, 640)])
def test_gru_sparse_plan_at_the_libri_layout(B, bi, units, grid):
    """16 units of one block column and 16 rows a block (8 and 8 at B <=
    8): 3 entries x 3bs floats a unit resident (rows of 16 padded to 20),
    the staged [dg_z | dg_r] rows and the dots' partials."""
    layout = _libri_layout()
    plan = tfr.gru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    bt = 8 * bi
    assert (plan.bi, plan.units, plan.grid) == (bi, units, grid)
    assert plan.resident == 4 * 3 * 3 * 128 * units
    assert plan.smem == (4 * 3 * 3 * 128 * (20 if units == 16 else 8)
                         + 4 * bt * 772 + 4 * 8 * bt * units)
    assert plan.static == 512
    assert plan.staged == 4 * min(bt, B) * 3 * 3 * 128


@pytest.mark.parametrize("bs, B, bi, units", [(8, 32, 4, 8), (16, 32, 2, 16),
                                              (8, 13, 4, 8), (16, 9, 2, 16)])
def test_gru_sparse_plan_takes_16_units_only_where_bs_holds_them(bs, B, bi,
                                                                 units):
    """A block's units lie in one block column: 16 of them need bs % 16 ==
    0; else 8 units and 32 rows."""
    plan = tfr.gru_bwd_sparse_plan(B, 64 * bs // 8, bs, 2)
    assert (plan.bi, plan.units) == (bi, units)


@pytest.mark.parametrize("B, blocks_per_sm, route", [
    (32, 1, "persist"),             # the libri train step: 128 blocks
    (16, 1, "persist"),
    (40, 1, "step"),                # 192 blocks
    (40, 2, "persist"),
    (160, 1, "step"),               # gru_large_batch: 640 blocks
])
def test_gru_sparse_route(B, blocks_per_sm, route):
    layout = _libri_layout()
    plan = tfr.gru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_gru_sparse_route_at_many_entries():
    """Columns of 4 kept 128-blocks fit (the libri cfg's layer 1), of 5
    they need 244,480 bytes: the step route."""
    plan = tfr.gru_bwd_sparse_plan(32, 1024, 128, 4)
    assert tfr.persist_route(plan, 1, H100_SMS) == "persist"
    plan = tfr.gru_bwd_sparse_plan(32, 1024, 128, 5)
    assert plan.smem + plan.static > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"


@pytest.mark.parametrize("route, qbits, bf16, n", [
    ("persist", 16, False, 6), ("persist", 0, False, 3),
    ("persist", 0, True, 5), ("persist", 16, True, 6),
    ("step", 16, False, 402), ("step", 0, True, 402)])
def test_gru_sparse_launches(route, qbits, bf16, n):
    """Kernels a T=200 call launches from its library: on the persistent
    route the scales, the two quantized operands where q or bf16 changes
    them, the z/r pass, a_pre and the chain; per step otherwise."""
    assert tfr.gru_bwd_sparse_launches(route, 200, qbits, bf16) == n


# ---------------------------------------------------------------------------
# the liGRU's recompute BPTT (TPU row 18)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid, slab, slabs, smem", [
    # TIMIT: 8 x 8 blocks, the whole dg_{t+1} row (2052 floats) at once
    (8, 1024, 1, 8, 128, 2048, 1,
     4 * (2048 * 8 + 8 * 2052 + 8 * 8 * 8)),
    # libri: 16 x 16 blocks (rows of 16 units padded to 20), 5 slabs of
    # 416 values, two in flight
    (32, 1024, 2, 16, 128, 416, 5,
     4 * (2048 * 20 + 2 * 16 * 420 + 8 * 16 * 16)),
    # 16 rows: 8 units x 16 rows, at once
    (16, 1024, 2, 8, 128, 2048, 1,
     4 * (2048 * 8 + 16 * 2052 + 8 * 16 * 8)),
    (8, 550, 1, 8, 69, 1104, 1, 4 * (1100 * 8 + 8 * 1108 + 8 * 8 * 8)),
    (5, 18, 1, 8, 3, 40, 1, 4 * (36 * 8 + 8 * 44 + 8 * 8 * 8)),
])
def test_ligru_bwd_plan(B, H, bi, units, grid, slab, slabs, smem):
    """A block owns its units' 2H-long columns of U and stages dg_{t+1}
    (2H floats a row): at once where it fits beside the weights and the
    dots' partials, else in the fewest slabs of a multiple of 32."""
    plan = tfr.ligru_bwd_plan(B, H)
    assert (plan.bi, plan.units, plan.grid, plan.slab, plan.slabs,
            plan.smem, plan.static) == (bi, units, grid, slab, slabs, smem,
                                        0)
    assert plan.resident == 4 * 2 * H * units
    assert plan.staged == 4 * min(8 * bi, B) * 2 * H
    assert plan.smem <= tfl._SMEM_MAX


def test_ligru_bwd_plan_forced_8_by_32_at_the_libri_shape():
    """The other block of 256 outputs at 32 rows: 8 units x 32 rows, 4
    slabs of 512, twice the staged bytes of 16 x 16."""
    plan = tfr.ligru_bwd_plan(32, 1024, (4, 8))
    assert (plan.grid, plan.slab, plan.slabs) == (128, 512, 4)
    assert plan.smem == 4 * (2048 * 8 + 2 * 32 * 516 + 8 * 32 * 8)
    assert plan.staged == 2 * tfr.ligru_bwd_plan(32, 1024).staged


def test_ligru_bwd_plan_slabs_cover_the_row():
    """Every slab but the last is full, a multiple of 32, and the slabs
    cover the 2H values; a single slab is the whole padded row."""
    for B, H in ((32, 1024), (40, 777), (17, 2000), (64, 1500)):
        plan = tfr.ligru_bwd_plan(B, H)
        K = 2 * H
        assert plan.slab % 32 == 0 or plan.slabs == 1
        assert (plan.slabs - 1) * plan.slab < K <= plan.slabs * plan.slab


def test_ligru_bwd_plan_too_wide_does_not_fit():
    """At H=3700 the 8 units' columns of U alone take 236,800 bytes: no
    slab fits, and the route is "step"."""
    plan = tfr.ligru_bwd_plan(8, 3700)
    assert 4 * 2 * 3700 * 8 > tfl._SMEM_MAX
    assert plan.smem > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 1024, 1, "persist"),        # TIMIT: 128 blocks
    (32, 1024, 1, "persist"),       # libri: 128 blocks
    (48, 1024, 1, "step"),          # 192 blocks, one an SM
    (8, 1100, 1, "step"),           # 138 blocks
    (8, 1100, 2, "persist"),
    (1, 2418, 1, "step"),           # the dense width limit: 303 blocks
])
def test_ligru_bwd_route(B, H, blocks_per_sm, route):
    plan = tfr.ligru_bwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_ligru_bwd_route_needs_cooperative_launch():
    plan = tfr.ligru_bwd_plan(8, 1024)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"


@pytest.mark.parametrize("route, T, qbits, n", [
    ("persist", 300, 16, 4), ("persist", 200, 0, 2), ("step", 300, 16, 300),
    ("step", 200, 0, 200)])
def test_ligru_bwd_launches(route, T, qbits, n):
    """On the persistent route the scales and q(h_prev) with the
    quantizer, the rebuild's GEMM and the chain; one a step otherwise."""
    assert tfr.ligru_bwd_launches(route, T, qbits) == n


# ---------------------------------------------------------------------------
# the sparse GRU forward (TPU row 32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, bi, units, grid", [
    (32, 2, 16, 128),               # libri train
    (16, 2, 8, 128),                # libri serve (8 utterances x 2)
    (5, 1, 8, 128),
    (80, 2, 16, 320),               # 160 rows
])
def test_gru_fwd_sparse_plan_at_the_libri_layout(B, bi, units, grid):
    """Units of one out-block and 8, 16 or 16 x 16 rows: the three gates'
    R*bs-long rows resident ([z | r] as 2 x units columns, rows of 32
    padded to 36 and of 16 to 20, the candidate's as units), the staged
    rows and the dots' partials; q(h_{t-1}) and q(s) staged a step."""
    layout = _libri_layout()
    plan = tfr.gru_fwd_sparse_plan(B, layout)
    bt, K3 = 8 * bi, layout.R * layout.bs
    assert (plan.bi, plan.units, plan.grid, plan.static) == (bi, units,
                                                             grid, 0)
    ws = {8: 20 + 8, 16: 36 + 20}[units]
    assert plan.smem == 4 * (K3 * ws + bt * (K3 + 4) + 8 * bt * 2 * units)
    assert plan.resident == 4 * 3 * K3 * units
    assert plan.staged == 2 * 4 * min(bt, B) * K3
    assert (plan.slab, plan.slabs) == (0, 1)


@pytest.mark.parametrize("bs, B, bi, units", [(8, 32, 4, 8), (16, 32, 2, 16),
                                              (8, 13, 2, 8), (16, 9, 2, 8),
                                              (128, 16, 2, 8)])
def test_gru_fwd_sparse_plan_takes_16_units_only_where_bs_holds_them(
        bs, B, bi, units):
    """Above 16 rows a block takes 16 units x 16 rows where bs is a
    multiple of 16, else 8 units x 32 rows; at 9-16 rows 8 x 16."""
    mask = hcgs_mask(8 * bs, 8 * bs, [bs], [50],
                     rng=np.random.RandomState(3))
    plan = tfr.gru_fwd_sparse_plan(B, tbs.pack_layout(mask, bs))
    assert (plan.bi, plan.units) == (bi, units)


@pytest.mark.parametrize("B, blocks_per_sm, route", [
    (32, 1, "persist"),             # the libri train step: 128 blocks
    (16, 1, "persist"),             # recognize: 128 blocks
    (80, 2, "step"),                # 160 rows: 320 blocks
    (80, 3, "persist"),
])
def test_gru_fwd_sparse_route(B, blocks_per_sm, route):
    layout = _libri_layout()
    plan = tfr.gru_fwd_sparse_plan(B, layout)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS,
                             coop=False) == "step"


def test_gru_fwd_sparse_route_too_many_kept_blocks():
    """R=8 kept blocks a row (1,024 staged values) at 16 units x 16 rows
    need more shared memory than a block has: "step"."""
    class Wide:
        bs, R, N = 128, 8, 1024
    plan = tfr.gru_fwd_sparse_plan(32, Wide)
    assert plan.smem > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"


@pytest.mark.parametrize("route, T, n", [("persist", 200, 1),
                                         ("persist", 398, 1),
                                         ("step", 200, 400),
                                         ("step", 398, 796)])
def test_gru_fwd_sparse_launches(route, T, n):
    """One cooperative launch a call, or two kernels a step."""
    assert tfr.gru_fwd_sparse_launches(route, T) == n


def test_chain_block_shapes_are_the_kernels():
    """The plans pick only the block shapes the kernels instantiate:
    (1, 8), (2, 8), (4, 8) and (2, 16) for the liGRU's chain; the sparse
    GRU and minimalGRU forward's from GRU_FWD_SPARSE_SHAPES and both
    sparse chains' from GRU_BWD_SPARSE_SHAPES, which are
    fused_gru_sparse.cu's instantiations (at bs 128 and 8); the dense GRU
    forward's from GRU_FWD_SHAPES, which are fused_gru.cu's."""
    shapes = {(1, 8), (2, 8), (4, 8), (2, 16)}
    layouts = (_libri_layout(), _cgs16x_layout(),
               tbs.pack_layout(hcgs_mask(64, 64, [8], [50],
                                         rng=np.random.RandomState(3)), 8))
    for B in (1, 5, 8, 9, 16, 17, 32, 100, 256):
        plan = tfr.ligru_bwd_plan(B, 1024)
        assert (plan.bi, plan.units) in shapes
        for layout in layouts:
            for G in (2, 3):
                plan = tfr.gru_fwd_sparse_plan(B, layout, G=G)
                assert (plan.bi, plan.units) in tfr.GRU_FWD_SPARSE_SHAPES
                plan = tfr._sparse_bwd_plan(B, layout.N, layout.bs,
                                            layout.C, G, None)
                assert (plan.bi, plan.units) in tfr.GRU_BWD_SPARSE_SHAPES
        for H, G in ((18, 3), (550, 3), (1024, 2), (1024, 3)):
            plan = tfr.gru_fwd_plan(B, H, G)
            assert (plan.bi, plan.units) in tfr.GRU_FWD_SHAPES
    csrc = pathlib.Path(tfr.__file__).parent / "csrc"
    for name, macro, table in (
            ("fused_gru.cu", "PK_FWD_SHAPE", tfr.GRU_FWD_SHAPES),
            ("fused_gru_sparse.cu", "PK_SPARSE_FWD_SHAPE",
             tfr.GRU_FWD_SPARSE_SHAPES),
            ("fused_gru_sparse.cu", "PK_SPARSE_BWD_SHAPE",
             tfr.GRU_BWD_SPARSE_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro,
                          (csrc / name).read_text(), re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table, macro


# ---------------------------------------------------------------------------
# the sparse minimalGRU forward and BPTT (TPU rows 34 and 35)
# ---------------------------------------------------------------------------

def _cgs16x_layout():
    """The CGS-16x minimalGRU's recurrent layout at chip_smoke.py's timed
    seed (HCGS 128,8 at 75,75 over 1024 x 1024: Kb=8, R=2)."""
    mask = hcgs_mask(1024, 1024, [128, 8], [75, 75],
                     rng=np.random.RandomState(421))
    return tbs.pack_layout(mask, 128)


def test_cgs16x_layout_columns():
    """The timed layout's block columns hold 0-5 kept blocks."""
    layout = _cgs16x_layout()
    assert (layout.R, layout.C) == (2, 5)
    assert tbs.column_counts(layout) == (5, 1, 2, 0, 0, 2, 4, 2)


@pytest.mark.parametrize("B, bi, units, grid", [
    (8, 1, 8, 128),                 # train (T=300) and serve (T=398)
    (16, 2, 8, 128),
    (32, 2, 16, 128),
    (256, 2, 16, 1024),             # MG_LARGE_ROWS
])
def test_mgru_fwd_sparse_plan_at_the_cgs16x_layout(B, bi, units, grid):
    """Row 34: the GRU's block shapes; the two gates' R*bs-long rows
    resident as rows (row_dots' order, no padding), the staged rows and
    one sum a row and unit (no warps' partials): 16 KB of w3g a block at
    8 units."""
    layout = _cgs16x_layout()
    plan = tfr.gru_fwd_sparse_plan(B, layout, G=2)
    bt, K3 = 8 * bi, 256
    assert (plan.bi, plan.units, plan.grid, plan.static) == (bi, units,
                                                             grid, 0)
    assert plan.resident == 4 * 2 * K3 * units
    assert plan.smem == 4 * (2 * units * K3 + bt * (K3 + 4) + bt * units)
    assert plan.staged == 2 * 4 * min(bt, B) * K3
    assert tfr.gru_fwd_sparse_plan(B, layout) == tfr.gru_fwd_sparse_plan(
        B, layout, G=3)
    if B == 8:
        assert plan.resident == 16384 and plan.smem == 24960


@pytest.mark.parametrize("B, bi, units, grid", [
    (8, 1, 8, 128), (16, 2, 16, 64), (32, 2, 16, 128), (256, 2, 16, 1024)])
def test_mgru_bwd_sparse_plan_at_the_cgs16x_layout(B, bi, units, grid):
    """Row 35: a block owns units of one block column, 2bs floats a unit
    and each of the column's (at most C = 5) entries resident (U_z's and
    U_h's columns; rows of 16 units padded to 20), dg_z's staged row (C*bs
    values) and the dots' partials; dg_z and dg_h staged per step."""
    layout = _cgs16x_layout()
    plan = tfr.mgru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    bt = 8 * bi
    assert (plan.bi, plan.units, plan.grid) == (bi, units, grid)
    assert plan.smem == 4 * (2 * 5 * 128 * (20 if units == 16 else 8)
                             + bt * (5 * 128 + 4) + 8 * bt * units)
    assert (plan.static, plan.resident) == (512, 4 * 2 * 5 * 128 * units)
    assert plan.staged == 4 * min(bt, B) * 2 * 5 * 128
    forced = tfr.mgru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C,
                                      (4, 8))
    assert (forced.bi, forced.units, forced.grid) == (4, 8, 128 * -(-B // 32))
    # the GRU's chain is the same plan at G=3
    assert tfr.gru_bwd_sparse_plan(B, 1024, 128, 5) == tfr._sparse_bwd_plan(
        B, 1024, 128, 5, 3, None)


@pytest.mark.parametrize("B, blocks_per_sm, fwd, bwd", [
    (8, 1, "persist", "persist"),   # train and serve: 128 blocks each
    (16, 1, "persist", "persist"),
    (32, 1, "persist", "persist"),
    (256, 1, "step", "step"),       # MG_LARGE_ROWS: 1,024 blocks
    (256, 7, "step", "step"),       # 924 co-resident
    (256, 8, "persist", "persist"),     # 1,056
])
def test_mgru_sparse_routes(B, blocks_per_sm, fwd, bwd):
    layout = _cgs16x_layout()
    f = tfr.gru_fwd_sparse_plan(B, layout, G=2)
    b = tfr.mgru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    assert tfr.persist_route(f, blocks_per_sm, H100_SMS) == fwd
    assert tfr.persist_route(b, blocks_per_sm, H100_SMS) == bwd
    for plan in (f, b):
        assert tfr.persist_route(plan, blocks_per_sm, H100_SMS,
                                 coop=False) == "step"
        assert tfr.persist_route(plan, 0, H100_SMS) == "step"


def test_mgru_sparse_routes_ask_their_kernels(monkeypatch):
    """Each route asks the occupancy entry of its own kernel (the
    minimalGRU's, not the GRU's) with its plan's ints, and takes "step"
    where the grid is not co-resident."""
    asked = []

    def occ(lib, entry, args, index):
        asked.append((lib, entry, args))
        return 1, H100_SMS, True
    monkeypatch.setattr(tfr, "_persist_occupancy", occ)
    layout = _cgs16x_layout()
    dev = torch.device("cuda", 0)
    route, plan = tfr.gru_fwd_sparse_route(8, layout, True, dev, 2)
    assert route == "persist" and plan.units == 8
    assert tfr.gru_fwd_sparse_route(256, layout, False, dev, 2)[0] == "step"
    route, bplan = tfr.mgru_bwd_sparse_route(8, layout, False, dev)
    assert route == "persist"
    assert asked == [
        ("fused_gru_sparse", "mgru_fwd_sparse_occupancy",
         (1, 1, 8, plan.smem)),
        ("fused_gru_sparse", "mgru_fwd_sparse_occupancy",
         (0, 2, 16, tfr.gru_fwd_sparse_plan(256, layout, G=2).smem)),
        ("fused_gru_sparse", "mgru_bwd_sparse_occupancy",
         (0, 1, bplan.smem))]


@pytest.mark.parametrize("route, T, qbits, n", [
    ("persist", 300, 16, 4), ("persist", 300, 0, 3), ("persist", 398, 16, 4),
    ("step", 300, 16, 602), ("step", 398, 0, 798)])
def test_mgru_bwd_sparse_launches(route, T, qbits, n):
    """On the persistent route the rebuild's two step kernels over all
    steps (after the per-step scales with the quantizer) and the chain;
    else the rebuild and two a reverse step."""
    assert tfr.mgru_bwd_sparse_launches(route, T, qbits) == n


@pytest.mark.parametrize("route, T, n", [("persist", 300, 1),
                                         ("persist", 398, 1),
                                         ("step", 300, 600),
                                         ("step", 398, 796)])
def test_mgru_fwd_sparse_launches(route, T, n):
    """The minimalGRU's forward counts as the GRU's: one cooperative
    launch a call, or two a step (1,592 a two-layer recognize at T=398
    on the step route, 2 on the persistent one)."""
    assert tfr.gru_fwd_sparse_launches(route, T) == n


# ---------------------------------------------------------------------------
# the sparse RNN forward and BPTT (TPU rows 36 and 37)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, bi, units, grid", [
    (8, 1, 8, 128),                 # train (T=300) and serve (T=398)
    (16, 2, 8, 128),
    (32, 2, 16, 128),
    (256, 2, 16, 1024),             # RS_LARGE_TBH
])
def test_rnn_fwd_sparse_plan_at_the_cgs16x_layout(B, bi, units, grid):
    """Row 36: the sparse GRU forward's block shapes; the units' R*bs-long
    rows of w3g resident as rows (row_dots' order, no padding), the
    staged rows of q(h_{t-1}) and one sum a row and unit: 8 KB of w3g a
    block at 8 units."""
    layout = _cgs16x_layout()
    plan = tfr.rnn_fwd_sparse_plan(B, layout)
    bt, K3 = 8 * bi, 256
    assert (plan.bi, plan.units, plan.grid, plan.static) == (bi, units,
                                                             grid, 0)
    assert plan.resident == 4 * units * K3
    assert plan.smem == 4 * (units * K3 + bt * (K3 + 4) + bt * units)
    assert plan.staged == 4 * min(bt, B) * K3
    if B == 8:
        assert (plan.resident, plan.staged, plan.smem) == (8192, 8192,
                                                           16768)
    forced = tfr.rnn_fwd_sparse_plan(B, layout, (4, 8))
    assert (forced.bi, forced.units, forced.grid) == (4, 8, 128 * -(-B // 32))


@pytest.mark.parametrize("B, bi, units, grid", [
    (8, 1, 8, 128), (16, 2, 8, 128), (32, 2, 16, 128), (256, 2, 16, 1024)])
def test_rnn_bwd_sparse_plan_at_the_cgs16x_layout(B, bi, units, grid):
    """Row 37: a block owns units of one block column with their columns
    of U at each of the column's (at most C = 5) entries resident as rows,
    bs floats a unit and an entry (no padding: the step kernel's dot
    order), the staged row of dg_{t+1} (C*bs values), one sum a row and
    unit, and the entry lists in static shared memory."""
    layout = _cgs16x_layout()
    plan = tfr.rnn_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    bt, KC = 8 * bi, 5 * 128
    assert (plan.bi, plan.units, plan.grid) == (bi, units, grid)
    assert (plan.static, plan.resident) == (512, 4 * units * KC)
    assert plan.smem == 4 * (units * KC + bt * (KC + 4) + bt * units)
    assert plan.staged == 4 * min(bt, B) * KC
    if B == 8:
        assert (plan.resident, plan.staged, plan.smem) == (20480, 20480,
                                                           41344)
    forced = tfr.rnn_bwd_sparse_plan(B, layout.N, layout.bs, layout.C,
                                     (4, 8))
    assert (forced.bi, forced.units, forced.grid) == (4, 8, 128 * -(-B // 32))


def test_rnn_sparse_rebuild_smem_at_the_cgs16x_layout():
    """The BPTT's rebuild block: 16 rows of w3g (R*bs = 256 floats), 32
    staged rows at a stride of 260 and their 32 x 16 sums, within a
    block's shared memory; R = 8 kept blocks of 128 still fit."""
    layout = _cgs16x_layout()
    assert tfr.rnn_sparse_rebuild_smem(layout) == 4 * (16 * 256 + 32 * 260
                                                       + 32 * 16) == 51712

    class Wide:
        bs, R = 128, 8
    assert tfr.rnn_sparse_rebuild_smem(Wide) <= tfl._SMEM_MAX


@pytest.mark.parametrize("B, blocks_per_sm, route", [
    (8, 1, "persist"),              # train and serve: 128 blocks each
    (16, 1, "persist"),
    (32, 1, "persist"),
    (256, 1, "step"),               # RS_LARGE_TBH: 1,024 blocks
    (256, 7, "step"),               # 924 co-resident
    (256, 8, "persist"),            # 1,056
])
def test_rnn_sparse_routes(B, blocks_per_sm, route):
    """Both plans take "persist" where their grids are co-resident (every
    block fits shared memory at the CGS-16x layout), "step" where not or
    without cooperative launches."""
    layout = _cgs16x_layout()
    f = tfr.rnn_fwd_sparse_plan(B, layout)
    b = tfr.rnn_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    for plan in (f, b):
        assert plan.smem + plan.static <= tfl._SMEM_MAX
        assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route
        assert tfr.persist_route(plan, blocks_per_sm, H100_SMS,
                                 coop=False) == "step"
        assert tfr.persist_route(plan, 0, H100_SMS) == "step"


def test_rnn_sparse_routes_ask_their_kernels(monkeypatch):
    """Each route asks the occupancy entry of its own kernel in
    fused_rnn_sparse with its plan's ints (w3g's dtype, the block shape,
    the dynamic shared memory) and takes "step" where the grid is not
    co-resident; the BPTT takes "step" without asking where bs is not a
    multiple of 32 (its chain's sums are the step kernel's only then)."""
    asked = []

    def occ(lib, entry, args, index):
        asked.append((lib, entry, args))
        return 1, H100_SMS, True
    monkeypatch.setattr(tfr, "_persist_occupancy", occ)
    layout = _cgs16x_layout()
    dev = torch.device("cuda", 0)
    route, plan = tfr.rnn_fwd_sparse_route(8, layout, True, dev)
    assert route == "persist" and (plan.bi, plan.units) == (1, 8)
    assert tfr.rnn_fwd_sparse_route(256, layout, False, dev)[0] == "step"
    route, bplan = tfr.rnn_bwd_sparse_route(8, layout, False, dev)
    assert route == "persist" and (bplan.bi, bplan.units) == (1, 8)
    assert tfr.rnn_bwd_sparse_route(32, layout, True, dev)[0] == "persist"
    small = tbs.pack_layout(hcgs_mask(64, 64, [16], [50],
                                      rng=np.random.RandomState(5)), 16)
    assert tfr.rnn_bwd_sparse_route(8, small, False, dev)[0] == "step"
    assert asked == [
        ("fused_rnn_sparse", "rnn_fwd_sparse_occupancy",
         (1, 1, 8, plan.smem)),
        ("fused_rnn_sparse", "rnn_fwd_sparse_occupancy",
         (0, 2, 16, tfr.rnn_fwd_sparse_plan(256, layout).smem)),
        ("fused_rnn_sparse", "rnn_bwd_sparse_occupancy",
         (0, 1, 8, bplan.smem)),
        ("fused_rnn_sparse", "rnn_bwd_sparse_occupancy",
         (1, 2, 16, tfr.rnn_bwd_sparse_plan(32, 1024, 128, 5).smem))]


@pytest.mark.parametrize("route, T, n", [("persist", 300, 1),
                                         ("persist", 398, 1),
                                         ("step", 300, 300),
                                         ("step", 398, 398)])
def test_rnn_fwd_sparse_launches(route, T, n):
    """One cooperative launch a call, or one kernel a step (1,592 a
    four-layer recognize at T=398 on the step route, 4 on the persistent
    one)."""
    assert tfr.rnn_fwd_sparse_launches(route, T) == n


@pytest.mark.parametrize("route, T, qbits, n", [
    ("persist", 300, 16, 4), ("persist", 300, 0, 2), ("persist", 1, 16, 4),
    ("step", 300, 16, 301), ("step", 300, 0, 301), ("step", 6, 0, 7)])
def test_rnn_bwd_sparse_launches(route, T, qbits, n):
    """On the persistent route the rebuild and the chain, and with the
    quantizer the per-step scales and q(h_prev); on the step route the
    rebuild and one kernel a reverse step (a CGS-16x RNN train step: 4 x
    (1 + 4) launches of rows 36-37 against 4 x (300 + 301))."""
    assert tfr.rnn_bwd_sparse_launches(route, T, qbits) == n


def test_rnn_sparse_block_shapes_are_the_kernels():
    """Both plans pick only block shapes the kernels instantiate, at bs
    128 and 8, and RNN_FWD_SPARSE_SHAPES / RNN_BWD_SPARSE_SHAPES are
    fused_rnn_sparse.cu's PK_RNN_SPARSE_FWD_SHAPE / _BWD_SHAPE lines."""
    layouts = (_cgs16x_layout(), _libri_layout(),
               tbs.pack_layout(hcgs_mask(64, 64, [8], [50],
                                         rng=np.random.RandomState(3)), 8))
    for B in (1, 5, 8, 9, 16, 17, 32, 100, 256):
        for layout in layouts:
            plan = tfr.rnn_fwd_sparse_plan(B, layout)
            assert (plan.bi, plan.units) in tfr.RNN_FWD_SPARSE_SHAPES
            assert layout.bs % plan.units == 0
            plan = tfr.rnn_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
            assert (plan.bi, plan.units) in tfr.RNN_BWD_SPARSE_SHAPES
    src = (pathlib.Path(tfr.__file__).parent / "csrc" / "fused_rnn_sparse.cu"
           ).read_text()
    for macro, table in (
            ("PK_RNN_SPARSE_FWD_SHAPE", tfr.RNN_FWD_SPARSE_SHAPES),
            ("PK_RNN_SPARSE_BWD_SHAPE", tfr.RNN_BWD_SPARSE_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro, src, re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table, macro


def _lane_order_col_dots(ent, bs, lane):
    """(entry, q) in the order lane ``lane`` of rnn_sparse_bwd_step's
    col_dots takes them: entry by entry, q = lane, lane + 32, ..."""
    return [(e, q) for e in range(ent) for q in range(lane, bs, 32)]


def _lane_order_resident(ent, bs, lane):
    """(entry, q) in the order lane ``lane`` of resident_dots over the
    chain's concatenated rows (k = e * bs + q) takes them: k = lane,
    lane + 32, ..."""
    return [divmod(k, bs) for k in range(lane, ent * bs, 32)]


@pytest.mark.parametrize("bs, same", [(128, True), (32, True), (64, True),
                                      (16, False), (8, False)])
def test_rnn_sparse_chain_lanes_take_col_dots_order(bs, same):
    """Row 37's chain gives the step route's bits only where bs is a
    multiple of 32: then each lane of resident_dots over the nv entries'
    concatenated bs-long rows takes the same (entry, q) products in the
    same order as col_dots' lane, before the same shuffle tree. Where bs
    is not, the lanes' shares differ once a column holds two entries,
    which is why rnn_bwd_sparse_route sends such layouts to the step
    route."""
    for nv in (0, 1, 2, 5):
        orders = [(_lane_order_col_dots(nv, bs, lane),
                   _lane_order_resident(nv, bs, lane))
                  for lane in range(32)]
        assert all(a == b for a, b in orders) == (same or nv <= 1)


# ---------------------------------------------------------------------------
# the dense GRU and minimalGRU forward (TPU rows 19 and 24)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, G, bi, units, grid, smem, staged", [
    # the TIMIT GRU (row 19)
    (8, 550, 3, 1, 8, 69, 4 * (3 * 8 * 550 + 8 * 556 + 8 * 16),
     2 * 4 * 8 * 552),
    # the minimalGRU (row 24)
    (8, 1024, 2, 1, 8, 128, 4 * (2 * 8 * 1024 + 8 * 1028 + 8 * 8),
     2 * 4 * 8 * 1024),
    # the GRU at H=1024, B=8 (the bf16 1024-wide layer's shape)
    (8, 1024, 3, 1, 8, 128, 4 * (3 * 8 * 1024 + 8 * 1028 + 8 * 16),
     2 * 4 * 8 * 1024),
    # 96 rows at H=1024: 16 x 16 blocks, 264,448 bytes
    (96, 1024, 3, 2, 16, 384, 4 * (3 * 16 * 1024 + 16 * 1028 + 16 * 32),
     2 * 4 * 16 * 1024),
    # the small ragged shape: 3 unit groups, the last of 2 units
    (5, 18, 3, 1, 8, 3, 4 * (3 * 8 * 18 + 8 * 28 + 8 * 16), 2 * 4 * 5 * 20),
    (5, 18, 2, 1, 8, 3, 4 * (2 * 8 * 18 + 8 * 28 + 8 * 8), 2 * 4 * 5 * 20),
])
def test_gru_fwd_plan(B, H, G, bi, units, grid, smem, staged):
    """A block owns its units' H-long rows of the G gates, stages its rows
    of q(h_{t-1}) and q(s) (H rounded up to 4 floats each) at a row
    stride of _row_stride(H), and keeps one sum a row and gate-unit; the
    last unit group is masked where units do not divide H."""
    plan = tfr.gru_fwd_plan(B, H, G)
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (bi, units, grid, smem, 0,
                                            4 * G * units * H, staged)
    assert (plan.slab, plan.slabs) == (0, 1)


@pytest.mark.parametrize("shape, grid, smem", [
    ((1, 4), 138, 4 * (3 * 4 * 550 + 8 * 556 + 8 * 8)),
    ((1, 16), 35, 4 * (3 * 16 * 550 + 8 * 556 + 8 * 32)),
])
def test_gru_fwd_plan_forced_at_the_timit_gru(shape, grid, smem):
    """The two other shapes timed at the TIMIT GRU's 8 rows: 4 units (138
    blocks, about 44 KB each) and 16 (35 blocks)."""
    plan = tfr.gru_fwd_plan(8, 550, 3, shape)
    assert (plan.bi, plan.units, plan.grid, plan.smem) == shape + (grid,
                                                                    smem)


@pytest.mark.parametrize("B, H, G, blocks_per_sm, route", [
    (8, 550, 3, 1, "persist"),      # the TIMIT GRU: 69 blocks
    (8, 1024, 2, 1, "persist"),     # the minimalGRU: 128 blocks
    (8, 1024, 3, 1, "persist"),
    (16, 1024, 3, 1, "persist"),    # 8 x 16 blocks, 165,120 bytes
    (8, 2048, 3, 1, "step"),        # 262,784 bytes: more than a block has
    (8, 2048, 2, 1, "step"),        # fits (196,992 bytes); 256 blocks
    (8, 1100, 2, 1, "step"),        # 138 blocks, one an SM
    (8, 1100, 2, 2, "persist"),
    (96, 1024, 3, 3, "step"),       # 16 x 16 does not fit
    (48, 550, 3, 1, "persist"),     # 16 x 16: 35 x 3 blocks
])
def test_gru_fwd_route(B, H, G, blocks_per_sm, route):
    plan = tfr.gru_fwd_plan(B, H, G)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_gru_fwd_route_needs_cooperative_launch_and_room():
    plan = tfr.gru_fwd_plan(8, 550, 3)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 68) == "step"      # 69 blocks


def test_gru_fwd_width_limit_is_the_step_kernels():
    """The dense forward's width limit (the step kernels' staged rows) is
    far past the widest persistent block at 8 rows."""
    for G, cell, widest in ((3, "gru", 1808), (2, "mgru", 2416)):
        limit = tfl.dense_max_width(cell)
        assert tfr.persist_route(tfr.gru_fwd_plan(1, limit, G), 1,
                                 H100_SMS) == "step"
        fits = [h for h in range(8, limit, 8) if tfr.gru_fwd_plan(
            8, h, G).smem <= tfl._SMEM_MAX]
        assert max(fits) == widest


@pytest.mark.parametrize("route, T, seeded, qbits, n", [
    ("persist", 300, False, 0, 1), ("persist", 300, False, 16, 1),
    ("persist", 100, True, 0, 1), ("persist", 100, True, 16, 1),
    ("step", 300, False, 16, 600), ("step", 398, False, 0, 796),
    ("step", 100, True, 0, 200), ("step", 100, True, 16, 201)])
def test_gru_fwd_launches(route, T, seeded, qbits, n):
    """One cooperative launch a call, a seed or not (its scale is taken
    inside the chain); two kernels a step otherwise, and the reduction of
    max|h0| first with a seed and the quantizer."""
    assert tfr.gru_fwd_launches(route, T, seeded, qbits) == n


@pytest.mark.parametrize("H, HP", [(550, 552), (18, 20), (1024, 1024),
                                   (1, 4), (4, 4), (1027, 1028)])
def test_gru_fwd_exchange_stride(H, HP):
    """The exchange buffers' rows start 16 bytes apart (cp.async copies
    16-byte chunks), hold the row and fit the staged row's stride."""
    stride = tfr.gru_fwd_exchange_stride(H)
    assert stride == HP and (4 * stride) % 16 == 0 and H <= stride < H + 4
    assert stride <= tfr._row_stride(H)


# ---------------------------------------------------------------------------
# the liGRU forward (TPU row 16)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid, smem, staged", [
    # the TIMIT Li-GRU: 8 x 8 blocks, about 97 KB
    (8, 1024, 1, 8, 128, 4 * (2 * 8 * 1024 + 8 * 1028 + 8 * 16),
     4 * 8 * 1024),
    # the libri Li-GRU's 32 rows: 8 units x 32 rows, 64 KB resident + 132
    # KB staged
    (32, 1024, 4, 8, 128, 4 * (2 * 8 * 1024 + 32 * 1028 + 32 * 16),
     4 * 32 * 1024),
    # its recognize (8 utterances x 2 directions): 8 units x 16 rows
    (16, 1024, 2, 8, 128, 4 * (2 * 8 * 1024 + 16 * 1028 + 16 * 16),
     4 * 16 * 1024),
    # H=550: 69 unit groups, the last of 6 units; exchange rows of 552
    (8, 550, 1, 8, 69, 4 * (2 * 8 * 550 + 8 * 556 + 8 * 16), 4 * 8 * 552),
    # the small ragged shape: 3 unit groups, the last of 2 units
    (5, 18, 1, 8, 3, 4 * (2 * 8 * 18 + 8 * 28 + 8 * 16), 4 * 5 * 20),
])
def test_ligru_fwd_plan(B, H, bi, units, grid, smem, staged):
    """A block owns its units' H-long rows of Uh and Uz, stages its rows of
    q(h_{t-1}) (H rounded up to 4 floats) at a row stride of
    _row_stride(H), and keeps one sum a row and gate-unit; the last unit
    group is masked where units do not divide H."""
    plan = tfr.ligru_fwd_plan(B, H)
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (bi, units, grid, smem, 0,
                                            4 * 2 * units * H, staged)
    assert (plan.slab, plan.slabs) == (0, 1)
    assert plan.smem <= tfl._SMEM_MAX


def test_ligru_fwd_plan_forced_16_by_16_at_the_libri_shape():
    """The other block of 256 outputs at 32 rows: 16 units x 16 rows,
    twice the resident bytes of the plan's 8 x 32 and half the staged
    ones."""
    plan = tfr.ligru_fwd_plan(32, 1024, (2, 16))
    wide = tfr.ligru_fwd_plan(32, 1024)
    assert (plan.grid, plan.smem) == (
        128, 4 * (2 * 16 * 1024 + 16 * 1028 + 16 * 32))
    assert (plan.resident, 2 * plan.staged) == (2 * wide.resident,
                                                wide.staged)


def test_ligru_fwd_plan_too_wide_goes_to_the_step_route():
    """At H=3700 the 8 units' rows of Uh and Uz alone take 236,800 bytes,
    more than a block has: "step"."""
    plan = tfr.ligru_fwd_plan(8, 3700)
    assert plan.resident == 236800 > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 1024, 1, "persist"),        # TIMIT train and serve: 128 blocks
    (32, 1024, 1, "persist"),       # libri train: 128 blocks
    (16, 1024, 1, "persist"),       # libri serve: 128 blocks
    (48, 1024, 1, "step"),          # 256 blocks of 8 x 32, one an SM
    (8, 1100, 1, "step"),           # 138 blocks
    (8, 1100, 2, "persist"),
    (8, 550, 1, "persist"),         # 69 blocks
])
def test_ligru_fwd_route(B, H, blocks_per_sm, route):
    plan = tfr.ligru_fwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_ligru_fwd_route_needs_cooperative_launch_and_room():
    plan = tfr.ligru_fwd_plan(8, 1024)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 127) == "step"     # 128 blocks


@pytest.mark.parametrize("route, T, n", [
    ("persist", 300, 1), ("persist", 398, 1), ("persist", 100, 1),
    ("step", 300, 300), ("step", 200, 200)])
def test_ligru_fwd_launches(route, T, n):
    """One cooperative launch a call, seeded or not (a seed's scale is
    taken inside the chain); one step kernel a step otherwise."""
    assert tfr.ligru_fwd_launches(route, T) == n


# ---------------------------------------------------------------------------
# the dense minimalGRU's recompute BPTT (TPU row 26)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid, smem, staged", [
    # the minimalGRU's training shape: 8 x 8 blocks, about 98 KB
    (8, 1024, 1, 8, 128, 4 * (2 * 1024 * 8 + 8 * 1028 + 8 * 8 * 8),
     2 * 4 * 8 * 1024),
    # 32 rows: 8 units x 32 rows (16 x 16, its rows of U's columns padded
    # to 20 floats, would take 237,824 bytes)
    (32, 1024, 4, 8, 128, 4 * (2 * 1024 * 8 + 32 * 1028 + 8 * 32 * 8),
     2 * 4 * 32 * 1024),
    (16, 1024, 2, 8, 128, 4 * (2 * 1024 * 8 + 16 * 1028 + 8 * 16 * 8),
     2 * 4 * 16 * 1024),
    # the small ragged shape: 3 unit groups, exchange rows of 20
    (4, 18, 1, 8, 3, 4 * (2 * 18 * 8 + 8 * 28 + 8 * 8 * 8), 2 * 4 * 4 * 20),
])
def test_mgru_bwd_plan(B, H, bi, units, grid, smem, staged):
    """A block owns its units' H-long columns of Uz and Uh, stages dg_z of
    step t+1 and dg_h of step t (H rounded up to 4 floats each) at a row
    stride of _row_stride(H), and keeps the dots' partials (8 warps' of
    each row and unit)."""
    plan = tfr.mgru_bwd_plan(B, H)
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (bi, units, grid, smem, 0,
                                            4 * 2 * H * units, staged)
    assert (plan.slab, plan.slabs) == (0, 1)


def test_mgru_bwd_plan_too_wide_goes_to_the_step_route():
    """At H=3700 the 8 units' columns of Uz and Uh take 236,800 bytes:
    "step"."""
    plan = tfr.mgru_bwd_plan(8, 3700)
    assert plan.smem > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"
    assert tfr.mgru_bwd_plan(32, 1024, (2, 16)).smem == 237824




@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 1024, 1, "persist"),        # the minimalGRU: 128 blocks
    (32, 1024, 1, "persist"),
    (48, 1024, 1, "step"),          # 192 blocks
    (8, 1100, 1, "step"),           # 138 blocks
    (8, 1100, 2, "persist"),
    (4, 18, 1, "persist"),
])
def test_mgru_bwd_route(B, H, blocks_per_sm, route):
    plan = tfr.mgru_bwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_mgru_bwd_route_needs_cooperative_launch_and_room():
    plan = tfr.mgru_bwd_plan(8, 1024)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"


@pytest.mark.parametrize("route, T, qbits, n", [
    ("persist", 300, 16, 7), ("persist", 300, 0, 4), ("step", 300, 16, 602),
    ("step", 13, 0, 28)])
def test_mgru_bwd_launches(route, T, qbits, n):
    """On the persistent route the two rebuild GEMMs around the z pass and
    the chain, and with the quantizer the per-step scales, q(h_prev) and
    q(s); on the step route the two rebuild kernels and two a step."""
    assert tfr.mgru_bwd_launches(route, T, qbits) == n


@pytest.mark.parametrize("H, rows", [(18, 32), (1024, 32), (1200, 16),
                                     (2000, 8), (2416, 0)])
def test_mgru_rebuild_rows(H, rows):
    """The rebuild's products stage the most rows of 32, 16 and 8 that fit
    beside their 16 rows of U; at 2416 (the dense width limit's
    neighbourhood) none does and the route is "step"."""
    assert tfr.mgru_rebuild_rows(H) == rows
    if rows:
        assert 4 * (16 * H + rows * tfr._row_stride(H) + rows * 16) <= \
            tfl._SMEM_MAX


def test_mgru_rebuild_fits_wherever_the_chain_does():
    """Every width whose chain plan fits at 8 rows has a rebuild tile."""
    for H in range(8, 3000, 8):
        if tfr.mgru_bwd_plan(8, H).smem <= tfl._SMEM_MAX:
            assert tfr.mgru_rebuild_rows(H), H


def test_ligru_fwd_and_mgru_bwd_block_shapes_are_the_kernels():
    """The plans pick only block shapes the kernels instantiate, and the
    shape tables are the sources' instantiations: LIGRU_FWD_SHAPES
    fused_ligru.cu's, MGRU_BWD_SHAPES fused_gru.cu's chain's."""
    for B in (1, 5, 8, 9, 16, 17, 32, 100):
        for H in (18, 550, 1024):
            plan = tfr.ligru_fwd_plan(B, H)
            assert (plan.bi, plan.units) in tfr.LIGRU_FWD_SHAPES
            plan = tfr.mgru_bwd_plan(B, H)
            assert (plan.bi, plan.units) in tfr.MGRU_BWD_SHAPES
    csrc = pathlib.Path(tfr.__file__).parent / "csrc"
    for name, macro, table in (("fused_ligru.cu", "PK_FWD_SHAPE",
                                tfr.LIGRU_FWD_SHAPES),
                               ("fused_gru.cu", "PK_BWD_SHAPE",
                                tfr.MGRU_BWD_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro,
                          (csrc / name).read_text(), re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table


# ---------------------------------------------------------------------------
# the dense GRU's stash BPTT (TPU row 20)
# ---------------------------------------------------------------------------

def _gru_bwd_smem(H, bi, un):
    """The GRU stash chain's shared memory: [Uz; Ur]'s and Uh's columns
    (3H rows of units, padded at 16), 8 bi staged rows of 2H at a stride
    of _row_stride(2H), the 8 warps' partials."""
    return 4 * (3 * H * tfr._w_stride(un) + 8 * bi * tfr._row_stride(2 * H)
                + 8 * 8 * bi * un)


@pytest.mark.parametrize("B, H, bi, units, grid", [
    (8, 550, 1, 8, 69),      # the TIMIT GRU's train shape
    (16, 550, 2, 8, 69),
    (8, 1024, 1, 8, 128),
    (16, 1024, 2, 8, 128),   # does not fit: the step route
    (100, 550, 4, 8, 276),
    (5, 18, 1, 8, 3),        # the small ragged shape: the last group of 2
])
def test_gru_bwd_stash_plan(B, H, bi, units, grid):
    """A block owns its units' columns of [Uz; Ur] (2H rows) and Uh (H),
    stages [dg_z | dg_r] of step t+1 (2H rounded up to 4) and dg_h of step
    t (H rounded up to 4) at a row stride of _row_stride(2H), and keeps
    the dots' partials: 8 units and 8, 16 or 32 rows."""
    plan = tfr.gru_bwd_stash_plan(B, H)
    HP, ZP = (tfr.gru_fwd_exchange_stride(k) for k in (H, 2 * H))
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (
                bi, units, grid, _gru_bwd_smem(H, bi, units), 0,
                4 * 3 * H * units, 4 * min(8 * bi, B) * (ZP + HP))
    assert (plan.slab, plan.slabs) == (0, 1)


@pytest.mark.parametrize("B, H, smem", [
    (8, 550, 90304), (16, 550, 127808), (8, 1024, 166016),
    (16, 1024, 233728)])
def test_gru_bwd_stash_plan_bytes_at_the_timit_and_1024_shapes(B, H, smem):
    """The bytes a block takes, written out: at 16 rows of 1024 the
    staged rows do not fit beside the weights (233,728 > 232,448)."""
    plan = tfr.gru_bwd_stash_plan(B, H)
    assert plan.smem == smem
    assert (plan.smem <= tfl._SMEM_MAX) == ((B, H) != (16, 1024))


@pytest.mark.parametrize("H, grid, smem", [(550, 138, 62880),
                                            (1024, 256, 115840)])
def test_gru_bwd_stash_plan_forced_4_units(H, grid, smem):
    """The other shape timed at 8 rows: 4 units, twice the blocks; two
    fit an SM's 228 KiB at H=550 (with the 1 KiB the runtime keeps a
    block), not at H=1024."""
    plan = tfr.gru_bwd_stash_plan(8, H, (1, 4))
    assert (plan.grid, plan.smem) == (grid, smem)
    assert (2 * (plan.smem + 1024) <= 228 * 1024) == (H == 550)


def test_dense_bwd_plan_at_g2_is_the_minimalgru_plan():
    """mgru_bwd_plan is the shared plan at G=2: its numbers as before."""
    for B, H in ((8, 1024), (32, 1024), (4, 18)):
        assert tfr.mgru_bwd_plan(B, H) == tfr._dense_bwd_plan(
            B, H, 2, tfr._shape(B, (4, 8)))


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 550, 1, "persist"),       # the TIMIT GRU: 69 blocks
    (16, 550, 1, "persist"),      # 69 blocks
    (8, 1024, 1, "persist"),      # 128 blocks
    (16, 1024, 1, "step"),        # does not fit
    (100, 550, 1, "step"),        # 276 blocks
    (100, 550, 3, "persist"),
])
def test_gru_bwd_stash_route(B, H, blocks_per_sm, route):
    plan = tfr.gru_bwd_stash_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_gru_bwd_stash_route_needs_cooperative_launch_and_room():
    plan = tfr.gru_bwd_stash_plan(8, 550)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 68) == "step"     # 69 blocks


def test_gru_bwd_stash_route_asks_the_g3_chain(monkeypatch):
    """The route asks the occupancy of the G=3 chain at the plan's shape
    and shared memory, and skips the query where the block does not
    fit."""
    asked = []

    def occupancy(lib, entry, args, index):
        asked.append((lib, entry, args))
        return 1, H100_SMS, True
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    dev = torch.device("cuda", 0)
    route, plan = tfr.gru_bwd_stash_route(8, 550, dev)
    assert route == "persist"
    assert asked == [("fused_gru", "gru_bwd_dense_occupancy",
                      (3, 1, 8, plan.smem))]
    assert tfr.gru_bwd_stash_route(16, 1024, dev)[0] == "step"
    assert len(asked) == 1


@pytest.mark.parametrize("route, T, n", [
    ("persist", 300, 1), ("persist", 7, 1), ("step", 300, 600),
    ("step", 13, 26)])
def test_gru_bwd_stash_launches(route, T, n):
    """One cooperative launch a call, or two kernels a reverse step."""
    assert tfr.gru_bwd_stash_launches(route, T) == n


# ---------------------------------------------------------------------------
# the dense RNN forward (TPU row 27)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid", [
    (8, 550, 1, 8, 69),      # the TIMIT RNN's train and serve shapes
    (16, 550, 2, 8, 69),
    (8, 1024, 1, 8, 128),    # the CGS-16x RNN's dense stream
    (16, 1024, 2, 8, 128),
    (100, 550, 2, 16, 245),
    (5, 18, 1, 8, 3),        # the small ragged shape: the last group of 2
])
def test_rnn_fwd_plan(B, H, bi, units, grid):
    """A block owns its units' H-long rows of U, stages its rows of
    q(h_{t-1}) (H rounded up to 4 floats) at a row stride of
    _row_stride(H), and keeps one sum a row and unit."""
    plan = tfr.rnn_fwd_plan(B, H)
    bt = 8 * bi
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (
                bi, units, grid,
                4 * (units * H + bt * tfr._row_stride(H) + bt * units), 0,
                4 * units * H, 4 * min(bt, B) * tfr.gru_fwd_exchange_stride(H))
    assert (plan.slab, plan.slabs) == (0, 1)
    assert plan.smem <= tfl._SMEM_MAX


@pytest.mark.parametrize("shape, grid, smem", [
    ((1, 4), 138, 4 * (4 * 550 + 8 * 556 + 8 * 4)),
    ((1, 16), 35, 4 * (16 * 550 + 8 * 556 + 8 * 16)),
])
def test_rnn_fwd_plan_forced_at_the_timit_rnn(shape, grid, smem):
    """The two other shapes timed at the TIMIT RNN's 8 rows."""
    plan = tfr.rnn_fwd_plan(8, 550, shape)
    assert (plan.bi, plan.units, plan.grid, plan.smem) == shape + (grid,
                                                                    smem)


def test_rnn_fwd_plan_too_wide_goes_to_the_step_route():
    """At H=7300 the 8 units' rows of U and 8 staged rows take more than
    a block has: "step"."""
    plan = tfr.rnn_fwd_plan(8, 7300)
    assert plan.smem > tfl._SMEM_MAX
    assert tfr.persist_route(plan, 1, H100_SMS) == "step"


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 550, 1, "persist"),       # 69 blocks
    (16, 550, 1, "persist"),
    (8, 1024, 1, "persist"),      # 128 blocks
    (16, 1024, 1, "persist"),
    (100, 550, 1, "step"),        # 245 blocks
    (100, 550, 2, "persist"),
    (96, 1024, 2, "step"),        # 384 blocks
])
def test_rnn_fwd_route(B, H, blocks_per_sm, route):
    plan = tfr.rnn_fwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_rnn_fwd_route_needs_cooperative_launch_and_room(monkeypatch):
    plan = tfr.rnn_fwd_plan(8, 550)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 68) == "step"      # 69 blocks
    asked = []

    def occupancy(lib, entry, args, index):
        asked.append((lib, entry, args))
        return 1, H100_SMS, True
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    assert tfr.rnn_fwd_route(8, 550, torch.device("cuda", 0)) == (
        "persist", plan)
    assert asked == [("fused_rnn", "fused_rnn_fwd_occupancy",
                      (1, 8, plan.smem))]


@pytest.mark.parametrize("route, T, n", [
    ("persist", 300, 1), ("persist", 398, 1), ("persist", 100, 1),
    ("step", 300, 300), ("step", 398, 398)])
def test_rnn_fwd_launches(route, T, n):
    """One cooperative launch a call, seeded or not (a seed's scale is
    taken inside the chain); one step kernel a step otherwise."""
    assert tfr.rnn_fwd_launches(route, T) == n


def test_gru_bwd_stash_and_rnn_fwd_block_shapes_are_the_kernels():
    """The plans pick only block shapes the kernels instantiate, and the
    shape tables are the sources' instantiations: GRU_BWD_SHAPES
    fused_gru.cu's PK_GRU_BWD_SHAPE lines, RNN_FWD_SHAPES fused_rnn.cu's
    PK_RNN_FWD_SHAPE lines."""
    for B in (1, 5, 8, 9, 16, 17, 32, 100):
        for H in (18, 550, 1024):
            plan = tfr.gru_bwd_stash_plan(B, H)
            assert (plan.bi, plan.units) in tfr.GRU_BWD_SHAPES
            plan = tfr.rnn_fwd_plan(B, H)
            assert (plan.bi, plan.units) in tfr.RNN_FWD_SHAPES
    csrc = pathlib.Path(tfr.__file__).parent / "csrc"
    for name, macro, table in (("fused_gru.cu", "PK_GRU_BWD_SHAPE",
                                tfr.GRU_BWD_SHAPES),
                               ("fused_rnn.cu", "PK_RNN_FWD_SHAPE",
                                tfr.RNN_FWD_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro,
                          (csrc / name).read_text(), re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table


# ---------------------------------------------------------------------------
# the dense RNN's recompute BPTT (TPU row 29)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid", [
    (8, 550, 1, 8, 69),      # the TIMIT RNN's train shape
    (16, 1024, 2, 8, 128),
    (8, 512, 1, 8, 64),      # RNN_cudnn's 2x512 layers
    (100, 550, 2, 16, 245),
    (5, 18, 1, 8, 3),        # the small ragged shape: the last group of 2
])
def test_rnn_bwd_plan(B, H, bi, units, grid):
    """A block owns its units' H-long columns of U, stages its rows of
    dg_{t+1} from the exchange buffer (H rounded up to 4 floats) at a row
    stride of _row_stride(H), and keeps one sum a row and unit: the
    forward's bytes."""
    plan = tfr.rnn_bwd_plan(B, H)
    bt = 8 * bi
    assert (plan.bi, plan.units, plan.grid, plan.smem, plan.static,
            plan.resident, plan.staged) == (
                bi, units, grid,
                4 * (units * H + bt * tfr._row_stride(H) + bt * units), 0,
                4 * units * H, 4 * min(bt, B) * tfr.gru_fwd_exchange_stride(H))
    assert plan == tfr.rnn_fwd_plan(B, H)
    assert plan.smem <= tfl._SMEM_MAX


@pytest.mark.parametrize("shape, grid, smem", [
    ((1, 4), 138, 4 * (4 * 550 + 8 * 556 + 8 * 4)),
    ((1, 16), 35, 4 * (16 * 550 + 8 * 556 + 8 * 16)),
    ((2, 8), 69, 4 * (8 * 550 + 16 * 556 + 16 * 8)),
    ((2, 16), 35, 4 * (16 * 550 + 16 * 556 + 16 * 16)),
])
def test_rnn_bwd_plan_forced_at_the_timit_rnn(shape, grid, smem):
    """The other block shapes timed at the TIMIT RNN's 8 rows of 550:
    4 x 8 (two blocks an SM), 16 x 8, 8 x 16 and 16 x 16 (units x rows)."""
    plan = tfr.rnn_bwd_plan(8, 550, shape)
    assert (plan.bi, plan.units, plan.grid, plan.smem) == shape + (grid,
                                                                    smem)


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (8, 550, 1, "persist"),       # 69 blocks
    (8, 512, 1, "persist"),       # 64 blocks
    (16, 1024, 1, "persist"),     # 128 blocks
    (100, 550, 1, "step"),        # 245 blocks
    (100, 550, 2, "persist"),
    (96, 1024, 1, "step"),        # 384 blocks
    (96, 1024, 2, "step"),
])
def test_rnn_bwd_route(B, H, blocks_per_sm, route):
    """"step" where the grid is not co-resident at the occupancy the card
    reports (fed here), chosen before any launch."""
    plan = tfr.rnn_bwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_rnn_bwd_route_asks_the_chain_and_needs_room(monkeypatch):
    """The route asks fused_rnn.cu's chain for its occupancy at the plan's
    shape and shared memory; without cooperative launches, a block that
    does not fit or too few SMs it is "step"; a block over the card's
    shared memory is "step" without asking."""
    plan = tfr.rnn_bwd_plan(8, 550)
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 68) == "step"      # 69 blocks
    asked = []

    def occupancy(lib, entry, args, index):
        asked.append((lib, entry, args))
        return 1, H100_SMS, True
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    assert tfr.rnn_bwd_route(8, 550, torch.device("cuda", 0)) == (
        "persist", plan)
    assert tfr.rnn_bwd_route(96, 1024, torch.device("cuda", 0))[0] == "step"
    assert tfr.rnn_bwd_route(8, 7300, torch.device("cuda", 0))[0] == "step"
    assert asked == [("fused_rnn", "fused_rnn_bwd_occupancy",
                      (1, 8, plan.smem)),
                     ("fused_rnn", "fused_rnn_bwd_occupancy",
                      (2, 16, tfr.rnn_bwd_plan(96, 1024).smem))]


@pytest.mark.parametrize("route, T, qbits, n", [
    ("persist", 300, 0, 2), ("persist", 300, 16, 3), ("persist", 1, 0, 2),
    ("step", 300, 0, 301), ("step", 300, 16, 301), ("step", 6, 0, 7)])
def test_rnn_bwd_launches(route, T, qbits, n):
    """The rebuild and the one cooperative chain a call, and the per-step
    scales with the quantizer; the rebuild and a step kernel a reverse
    step otherwise."""
    assert tfr.rnn_bwd_launches(route, T, qbits) == n


def test_rnn_bwd_block_shapes_are_the_kernels():
    """The plan picks only block shapes the chain instantiates, and
    RNN_BWD_SHAPES is fused_rnn.cu's PK_RNN_BWD_SHAPE lines."""
    for B in (1, 5, 8, 9, 16, 17, 32, 100):
        for H in (18, 512, 550, 1024):
            plan = tfr.rnn_bwd_plan(B, H)
            assert (plan.bi, plan.units) in tfr.RNN_BWD_SHAPES
    src = (pathlib.Path(tfr.__file__).parent / "csrc" / "fused_rnn.cu"
           ).read_text()
    inst = re.findall(r"^  PK_RNN_BWD_SHAPE\((\d+), (\d+)\)$", src, re.M)
    assert tuple((int(a), int(b)) for a, b in inst) == tfr.RNN_BWD_SHAPES


# ---------------------------------------------------------------------------
# the staging layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [8, 64, 256, 384, 768, 1650, 183, 54, 416,
                               512, 2048])
def test_row_stride_spreads_a_warp_over_32_banks(K):
    """Lane (b_lane, k_lane) of a warp reads xs[b_lane * SK + k + k_lane]:
    with SK = K rounded up to 8, plus 4, the 32 lanes hit 32 banks."""
    SK = tfr._row_stride(K)
    assert SK >= K + 4 and SK % 8 == 4
    for k in (0, 1, 5):
        banks = {(bl * SK + k + kl) % 32 for bl in range(8)
                 for kl in range(4)}
        assert len(banks) == 32


@pytest.mark.parametrize("K", [0, 5, 384, 1650])
def test_warp_ranges_cover_the_contraction(K):
    """The 8 warps' ranges [K w / 8, K (w+1) / 8) partition [0, K)."""
    ranges = [(K * w // 8, K * (w + 1) // 8) for w in range(8)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("units", [8, 16, 32])
def test_weight_rows_spread_the_k_lanes_over_banks(units):
    """The 4 k lanes of a warp read a float4 of weight rows k..k+3,
    w_stride(units) floats apart: 16 distinct banks for every units (the
    [z | r] columns of the forward are 32 wide at 16 units)."""
    ws = tfr._w_stride(units)
    assert ws % 4 == 0 and ws >= units
    for v in range(units // 4):
        banks = {(kl * ws + 4 * v + e) % 32 for kl in range(4)
                 for e in range(4)}
        assert len(banks) == 16


def test_quant_rcp_quotient_is_ieee_division():
    """lstm_common.cuh's quant_rcp divides |x| by the scale var as q =
    |x| * (1 / var), corrected once by fmaf(fmaf(-q, var, |x|), 1 / var,
    q): on 200,000 random float32 pairs (|x| <= var, var over 5 decades)
    the quotient equals IEEE division's, emulated here with each FMA's
    exact float64 value rounded once to float32."""
    f32, f64 = np.float32, np.float64
    rng = np.random.RandomState(0)
    n = 200_000
    var = (np.abs(rng.randn(n)) * 10.0 ** rng.uniform(-3, 2, n)).astype(f32)
    var = np.maximum(var, f32(1e-30))
    a = np.abs(rng.uniform(-1, 1, n).astype(f32) * var)
    a[::7] *= f32(1e-3)
    inv = (f32(1) / var).astype(f32)
    q = (a * inv).astype(f32)
    r = (a.astype(f64) - q.astype(f64) * var.astype(f64)).astype(f32)
    q = (r.astype(f64) * inv.astype(f64) + q.astype(f64)).astype(f32)
    np.testing.assert_array_equal(q, (a / var).astype(f32))


def _quant_emulated(x, var, bits=16):
    """quant() and quant_rcp() of lstm_common.cuh on float32 numpy arrays
    (IEEE division; the reciprocal and one FMA correction, each FMA's
    float64 value rounded once to float32, below the normal range whether
    |x| * 2^75 > var * 2^-75), -> (quant, quant_rcp, the corrected
    quotient's quantizer without that test)."""
    f32, f64 = np.float32, np.float64
    scale, iscale = f32(2.0 ** (bits - 1)), f32(2.0 ** (1 - bits))
    a, s = np.abs(x), np.sign(x).astype(f32)
    inv = (f32(1) / var).astype(f32)
    q = (a * inv).astype(f32)
    r = (a.astype(f64) - q.astype(f64) * var.astype(f64)).astype(f32)
    q1 = (r.astype(f64) * inv.astype(f64) + q.astype(f64)).astype(f32)
    div = (a / var).astype(f32)
    above = (a * f32(2.0 ** 75)) > (var * f32(2.0 ** -75))
    q2 = np.where(q1 < f32(2.0 ** -126),
                  np.where(above, f32(2.0 ** -126), f32(0)), q1).astype(f32)

    def out(quot):
        return (np.ceil(quot * scale).astype(f32) * iscale * var * s
                ).astype(f32)
    return out(div), out(q2), out(q1)


def test_quant_rcp_divides_below_the_normal_range():
    """At var = 1.544 the smallest subnormal |x| (where a carry that
    decays through z * h ends) has the division round to 2^-149 and one
    correction of the reciprocal's quotient to 0: quant() gives one step,
    var / 2^15, and the corrected quotient alone 0. quant_rcp asks there
    whether the division would round to 0 (|x| > var * 2^-150, exactly),
    and keeps quant()'s bits there and on the smallest subnormals and
    normals at other scales."""
    f32 = np.float32
    tiny = np.array([2 ** -149, 2 ** -148, 2 ** -140, 2 ** -126, 2 ** -100],
                    f32)
    x = np.concatenate([tiny, -tiny, [0.0, -0.0]]).astype(f32)
    for vbits in (0x3FC5A1E6, 0x3F800000, 0x40490FDB, 0x3C23D70A):
        var = np.full_like(x, np.array([vbits], np.uint32).view(f32)[0])
        want, got, one_correction = _quant_emulated(x, var)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        if vbits == 0x3FC5A1E6:
            assert want[0] == var[0] / f32(2 ** 15) and one_correction[0] == 0


_QUANT_CHECK_CU = r"""
#include <cstdint>
#include <cstring>
#include "lstm_common.cuh"
__device__ unsigned long long bad;
__global__ void check(float v, uint32_t hi) {
  const float inv = 1.f / v, scale = 32768.f, iscale = 1.f / 32768.f;
  unsigned long long b = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i <= 2ull * hi + 1; i += (uint64_t)gridDim.x * blockDim.x) {
    const float a = __uint_as_float((uint32_t)(i >> 1) |
                                    ((uint32_t)(i & 1) << 31));
    b += __float_as_uint(quant(a, v, scale)) !=
         __float_as_uint(quant_rcp(a, v, inv, scale, iscale));
  }
  atomicAdd(&bad, b);
}
extern "C" unsigned long long quant_mismatches(uint32_t vbits) {
  float v;
  memcpy(&v, &vbits, 4);
  unsigned long long z = 0, h = 0;
  cudaMemcpyToSymbol(bad, &z, 8);
  check<<<1056, 256>>>(v, vbits);
  cudaMemcpyFromSymbol(&h, bad, 8);
  return cudaGetLastError() == cudaSuccess ? h : ~0ull;
}
"""


@pytest.mark.cuda
def test_cuda_quant_rcp_is_quant_for_every_input(cuda_device, tmp_path):
    """On the card, quant_rcp's bits equal quant()'s for every float32 x
    with |x| <= var (both signs, subnormals and zeros; 2-4 billion values
    a scale) at scales from the subnormal to 1.7e38."""
    import ctypes
    import subprocess
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    src = tmp_path / "quant_check.cu"
    src.write_text(_QUANT_CHECK_CU)
    lib = tmp_path / "libquant_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).quant_mismatches
    fn.argtypes, fn.restype = [ctypes.c_uint32], ctypes.c_ulonglong
    for vbits in (0x3FC5A1E6, 0x3F800000, 0x3F7FFFFF, 0x40490FDB,
                  0x3E4CCCCD, 0x41200000, 0x3C23D70A, 0x3A83126F, 0x447A0000,
                  0x00400000, 0x00800000, 0x7F000000):
        assert fn(vbits) == 0, hex(vbits)


# ---------------------------------------------------------------------------
# on the card: the dense GRU forward's routes against the twin (skips
# without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


def _gru_fwd_inputs(T, B, H, G, seed, dev):
    rng = np.random.RandomState(seed)

    def d(a):
        return torch.tensor(a.astype(np.float32), device=dev)
    return (d(rng.randn(T, B, G * H) * 0.5), d(rng.randn(G * H, H) * 0.3),
            d(rng.rand(B, H) > 0.2), d(rng.randn(B, H) * 0.3))


def _gru_fwd_cases(wrapper, G, g, U, drop, h0, call):
    """``call(h0, act, qbits, stash)`` against the twin over qbits 0/16 x
    tanh/relu x zero or seeded carry x stash or not (atol 1e-5, 1e-4 with
    16 bits: a one-ulp difference at a ceil step is one step); two calls
    bit for bit. -> the wrapper's launches over all cases."""
    before = wrapper.launches
    for qbits in (0, 16):
        for act in ("tanh", "relu"):
            for seed in (None, h0):
                for stash in (False, True):
                    with torch.no_grad():
                        got = call(seed, act, qbits, stash)
                        again = call(seed, act, qbits, stash)
                        ref = tfr.fused_gru_fwd_plain(g, U, drop, seed, act,
                                                      qbits, stash)
                    got, again, ref = ((x,) if not stash else x
                                       for x in (got, again, ref))
                    for a, b, r in zip(got, again, ref):
                        assert torch.equal(a, b)
                        np.testing.assert_allclose(
                            a.cpu().numpy(), r.cpu().numpy(),
                            atol=1e-4 if qbits else 1e-5,
                            err_msg="G=%d %s qbits=%d seeded=%s stash=%s"
                            % (G, act, qbits, seed is not None, stash))
    return wrapper.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.GRU_FWD_SHAPES)
@pytest.mark.parametrize("G", [3, 2])
def test_cuda_gru_fwd_persist_every_block_shape(cuda_device, G, shape):
    """The persistent forward forced to each instantiated block shape at a
    ragged width (H=37: the last unit group masked, the exchange rows
    padded to 40 floats) and batch (8 bi + 3 rows: a ragged last block of
    rows), against the twin; one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    T, B, H = 7, 8 * bi + 3, 37
    g, U, drop, h0 = _gru_fwd_inputs(T, B, H, G, 31 + 2 * un + bi,
                                     cuda_device)
    wrapper = tfr.fused_gru_fwd if G == 3 else tfr.fused_mgru_fwd
    plan = tfr.gru_fwd_plan(B, H, G, shape)
    n = _gru_fwd_cases(wrapper, G, g, U, drop, h0, lambda h, a, q, st:
                       tfr._gru_fwd_persist(wrapper, plan, g, U, drop, h, a,
                                            q, st))
    assert n == 32


@pytest.mark.cuda
@pytest.mark.parametrize("G", [3, 2])
def test_cuda_gru_fwd_routes(cuda_device, G):
    """The wrapper on the route its plan names (persistent at 11 rows of
    37 units) and the step route forced, against the twin, each with its
    route's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T, B, H = 6, 11, 37
    g, U, drop, h0 = _gru_fwd_inputs(T, B, H, G, 41 + G, cuda_device)
    wrapper = tfr.fused_gru_fwd if G == 3 else tfr.fused_mgru_fwd
    assert tfr.gru_fwd_route(B, H, G, cuda_device)[0] == "persist"
    n = _gru_fwd_cases(wrapper, G, g, U, drop, h0, lambda h, a, q, st:
                       wrapper(g, U, drop, h, act=a, qbits=q, stash=st))
    assert n == 32
    n = _gru_fwd_cases(wrapper, G, g, U, drop, h0, lambda h, a, q, st:
                       tfr._gru_fwd_step(wrapper, g, U, drop, h, a, q, st))
    assert n == sum(2 * tfr.gru_fwd_launches("step", T, seeded, q)
                    for q in (0, 16) for _ in ("tanh", "relu")
                    for seeded in (False, True) for _ in (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [3, 2])
def test_cuda_gru_fwd_persist_gives_the_step_routes_bits(cuda_device, G):
    """Each dot of the persistent forward is one warp's, lanes over k and
    a shuffle reduction, as in the step kernels, and its quantizer gives
    quant()'s bits: at every instantiated block shape both routes give
    equal bits (a dense stream of a sparse layer therefore keeps the
    sparse forward's)."""
    T, B, H = 5, 19, 45
    g, U, drop, h0 = _gru_fwd_inputs(T, B, H, G, 53 + G, cuda_device)
    wrapper = tfr.fused_gru_fwd if G == 3 else tfr.fused_mgru_fwd
    with torch.no_grad():
        for qbits in (0, 16):
            for act in ("tanh", "relu"):
                for seed in (None, h0):
                    want = tfr._gru_fwd_step(wrapper, g, U, drop, seed, act,
                                             qbits, True)
                    for shape in tfr.GRU_FWD_SHAPES:
                        got = tfr._gru_fwd_persist(
                            wrapper, tfr.gru_fwd_plan(B, H, G, shape), g, U,
                            drop, seed, act, qbits, True)
                        for a, b in zip(got, want):
                            assert torch.equal(a, b), (shape, qbits, act)


def test_gru_fwd_variants_apply_to_the_source():
    """gru_fwd_variants.py writes its variants of fused_gru.cu and
    persist.cuh (the dense forward's dots and quantizer's pass) by text
    substitution: each still applies to the sources and changes them."""
    import gru_fwd_variants
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    src = {f: (_build.CSRC / f).read_text() for f in gru_fwd_variants.FILES}
    out = gru_fwd_variants.variants(src)
    assert out.pop("base") == src
    assert len(out) == 8 and all(v != src and set(v) == set(src)
                                 for v in out.values())
