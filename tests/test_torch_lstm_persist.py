"""The plans and routes of the dense LSTM's persistent kernels
(pytorch_kaldi_cgs_tpu_torch/ops/fused_lstm.py over csrc/persist.cuh): the
forward (TPU row 1, ``lstm_fwd_persist`` in csrc/fused_lstm_fwd.cu) and
the stash BPTT (row 3, ``lstm_bwd_stash_persist`` in csrc/fused_lstm_bwd.cu),
in pure Python: the block shape, grid, shared memory, staged bytes and
slabs each plan picks at the shapes the port runs, which route a plan
takes for given SM counts, shared memory and cooperative launches (also
through the route functions, with the occupancy query stubbed), the
launches a call counts, and the shape tables against the sources'
instantiations. The kernels themselves are held against their twins and
against the step route by the ``cuda`` cases of
tests/test_torch_fused_lstm.py."""

import math
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


def _fwd_smem(bi, un, H):
    """The forward's block: 4 x units rows of U (H floats each at 4 units,
    lane_row(H) at 8), the staged rows (_row_stride(H) apart at 4 units,
    lane_row(H) at 8) and one sum a row and gate-unit."""
    if un == 8:
        L = tfl.lane_row(H)
        return 4 * (4 * un * L + 8 * bi * L + 8 * bi * 4 * un)
    return 4 * (4 * un * H + 8 * bi * tfr._row_stride(H) + 8 * bi * 4 * un)


# ---------------------------------------------------------------------------
# the forward (TPU row 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid", [
    (16, 512, 1, 4, 256),      # the flagship train step: two blocks an SM
    (8, 512, 1, 4, 128),       # the flagship's recognize
    (8, 1024, 1, 4, 256),      # the CGS-16x cfg as shipped (8 rows)
    (16, 1024, 2, 8, 128),     # 2x1024 at 16 rows: 8 units x 16 rows
    (8, 550, 1, 4, 138),       # TIMIT_LSTM_fmllr.cfg (4x550)
    (5, 18, 1, 4, 5),          # the small ragged shape: the last group of 2
    (13, 18, 1, 4, 10),
    (32, 1024, 2, 8, 256),     # 256 blocks of 8 x 16: the step route
])
def test_lstm_fwd_plan(B, H, bi, units, grid):
    """A block owns its units' rows of the 4 gates, stages its rows of
    q(h_{t-1}) (exchange rows of H rounded up to 4 at 4 units, lane-major
    rows at 8), keeps one sum a row and gate-unit; 4 units x 8 rows
    wherever two such blocks an SM hold the grid, else 8 units and 8 or
    16 rows."""
    plan = tfl.lstm_fwd_plan(B, H)
    assert (plan.bi, plan.units, plan.grid, plan.static) == (bi, units,
                                                             grid, 0)
    assert plan.smem == _fwd_smem(bi, units, H)
    row = tfl.lstm_fwd_exchange_row(H, units)
    assert row == (tfl.lane_row(H) if units == 8
                   else tfr.gru_fwd_exchange_stride(H))
    assert plan.resident == 4 * 4 * units * (row if units == 8 else H)
    assert plan.staged == 4 * min(8 * bi, B) * row
    assert (plan.slab, plan.slabs) == (0, 1)
    assert plan.smem <= tfl._SMEM_MAX


@pytest.mark.parametrize("shape, grid, smem", [
    ((1, 8), 128, 103424), ((2, 4), 128, 66816), ((2, 8), 64, 124928),
    ((1, 4), 256, 49792)])
def test_lstm_fwd_plan_forced_at_the_flagship_train_shape(shape, grid, smem):
    """The block shapes timed at the flagship's 16 rows of 512: 8 units x
    8 rows and 4 x 16 (128 blocks), 8 x 16 (64), the plan's 4 x 8 (256,
    two an SM)."""
    plan = tfl.lstm_fwd_plan(16, 512, shape)
    assert (plan.bi, plan.units, plan.grid, plan.smem) == shape + (grid,
                                                                    smem)
    assert smem == _fwd_smem(*shape, 512)


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (16, 512, 2, "persist"),       # 256 blocks, two an SM
    (16, 512, 1, "step"),          # 256 blocks, one an SM
    (8, 1024, 2, "persist"),
    (16, 1024, 1, "persist"),      # 128 blocks of 223,232 bytes
    (32, 1024, 1, "step"),         # 256 blocks
    (8, 550, 2, "persist"),        # 138 blocks
    (8, 2048, 1, "step"),          # 349,184 bytes: more than a block has
])
def test_lstm_fwd_route(B, H, blocks_per_sm, route):
    plan = tfl.lstm_fwd_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_lstm_fwd_route_needs_cooperative_launch_and_room():
    plan = tfl.lstm_fwd_plan(16, 1024)
    assert tfr.persist_route(plan, 1, H100_SMS) == "persist"
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 127) == "step"     # 128 blocks


@pytest.mark.parametrize("route, T, n", [
    ("persist", 300, 1), ("persist", 398, 1), ("persist", 100, 1),
    ("step", 300, 300), ("step", 398, 398), ("step", 13, 13)])
def test_lstm_fwd_launches(route, T, n):
    """One cooperative launch a call, seeded or not (a seed's quantizer
    scale is taken inside it); one step kernel a step otherwise (the
    reduction of max|h0| before them is not counted, as before)."""
    assert tfl.lstm_fwd_launches(route, T) == n


# ---------------------------------------------------------------------------
# the stash BPTT (TPU row 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, H, bi, units, grid, slab, slabs, smem", [
    # the flagship train step: whole rows of 2048
    (16, 512, 1, 8, 128, 2048, 1,
     4 * (2048 * 8 + 8 * 2052 + 8 * 8 * 8)),
    # 2x1024 at 8 rows: 3 slabs of 1376, two buffers
    (8, 1024, 1, 8, 128, 1376, 3,
     4 * (4096 * 8 + 2 * 8 * 1380 + 8 * 8 * 8)),
    # 2x1024 at 16 rows: 6 slabs of 704
    (16, 1024, 2, 8, 128, 704, 6,
     4 * (4096 * 8 + 2 * 16 * 708 + 8 * 16 * 8)),
    # 4x550 at 8 rows: 69 unit groups, the last of 6 units; whole rows
    (8, 550, 1, 8, 69, 2200, 1, 4 * (2200 * 8 + 8 * 2204 + 8 * 8 * 8)),
    # LSTM_cudnn's 2x512 at 8 rows: 4 units, 128 blocks
    (8, 512, 1, 4, 128, 2048, 1, 4 * (2048 * 4 + 8 * 2052 + 8 * 8 * 4)),
    # the small ragged shape
    (5, 18, 1, 4, 5, 72, 1, 4 * (72 * 4 + 8 * 76 + 8 * 8 * 4)),
    (13, 18, 1, 8, 6, 72, 1, 4 * (72 * 8 + 8 * 76 + 8 * 8 * 8)),
])
def test_lstm_bwd_stash_plan(B, H, bi, units, grid, slab, slabs, smem):
    """A block owns its units' 4H-long columns of U and stages dg_{t+1}
    (4H floats a row) per step: whole rows where they fit beside the
    weights and the dots' partials, else in the fewest slabs of a
    multiple of 32 whose two buffers fit."""
    plan = tfl.lstm_bwd_stash_plan(B, H)
    assert (plan.bi, plan.units, plan.grid, plan.slab, plan.slabs,
            plan.smem, plan.static) == (bi, units, grid, slab, slabs, smem,
                                        0)
    assert plan.resident == 4 * 4 * H * units
    assert plan.staged == 4 * min(8 * bi, B) * 4 * H
    assert plan.smem <= tfl._SMEM_MAX


@pytest.mark.parametrize("B, H", [(8, 1024), (16, 1024), (16, 512),
                                  (8, 550), (13, 18), (8, 1500)])
def test_lstm_bwd_stash_plan_slabs_cover_the_row(B, H):
    """The slabs cover the 4H values of a row, each a multiple of 32 (the
    last may be short), the fewest that fit: one fewer would not."""
    plan = tfl.lstm_bwd_stash_plan(B, H)
    K = 4 * H
    assert plan.slabs == math.ceil(K / plan.slab)
    assert plan.slab * plan.slabs >= K
    if plan.slabs > 1:
        assert plan.slab % 32 == 0
        bt = 8 * plan.bi
        fixed = plan.smem - 4 * 2 * bt * tfr._row_stride(plan.slab)
        wider = (-(-K // (plan.slabs - 1)) + 31) // 32 * 32
        assert fixed + 4 * 2 * bt * tfr._row_stride(wider) > tfl._SMEM_MAX


@pytest.mark.parametrize("B, H, blocks_per_sm, route", [
    (16, 512, 1, "persist"),       # the flagship: 128 blocks
    (8, 1024, 1, "persist"),
    (16, 1024, 1, "persist"),
    (32, 1024, 1, "step"),         # 256 blocks of 8 x 16
    (8, 550, 1, "persist"),        # 69 blocks
    (8, 1500, 1, "step"),          # 8 units' columns: 192,000 bytes
    (8, 1806, 1, "step"),          # the step kernels' width limit
])
def test_lstm_bwd_stash_route(B, H, blocks_per_sm, route):
    plan = tfl.lstm_bwd_stash_plan(B, H)
    assert tfr.persist_route(plan, blocks_per_sm, H100_SMS) == route


def test_lstm_bwd_stash_route_needs_cooperative_launch_and_room():
    plan = tfl.lstm_bwd_stash_plan(16, 512)
    assert tfr.persist_route(plan, 1, H100_SMS) == "persist"
    assert tfr.persist_route(plan, 1, H100_SMS, coop=False) == "step"
    assert tfr.persist_route(plan, 0, H100_SMS) == "step"
    assert tfr.persist_route(plan, 1, H100_SMS,
                             smem_max=plan.smem - 1) == "step"
    assert tfr.persist_route(plan, 1, 127) == "step"     # 128 blocks


@pytest.mark.parametrize("route, T, seeded, n", [
    ("persist", 300, False, 1), ("persist", 300, True, 1),
    ("step", 300, False, 300), ("step", 300, True, 301),
    ("step", 13, True, 14)])
def test_lstm_bwd_stash_launches(route, T, seeded, n):
    """One cooperative launch a call (a seeded call's dh0 inside it); one
    kernel a reverse step otherwise, and the dh0 dot when seeded."""
    assert tfl.lstm_bwd_stash_launches(route, T, seeded) == n


# ---------------------------------------------------------------------------
# the routes as the wrappers ask them, the shape tables, the width limit
# ---------------------------------------------------------------------------

ROUTES = (("lstm_fwd_route", "fused_lstm_fwd", "lstm_fwd_occupancy"),
          ("lstm_bwd_stash_route", "fused_lstm_bwd",
           "lstm_bwd_stash_occupancy"))


@pytest.mark.parametrize("fn, lib, entry", ROUTES)
@pytest.mark.parametrize("coop, route", [(True, "persist"),
                                         (False, "step")])
def test_route_functions_ask_the_occupancy_query(monkeypatch, fn, lib,
                                                 entry, coop, route):
    """The route function asks its kernel's occupancy query (stubbed
    here: two blocks an SM on 132 SMs) with (bf16, bi, units, smem) and
    picks "persist" on a device that takes cooperative launches, "step"
    on one that does not."""
    asked = []

    def occupancy(lib_, entry_, args, index):
        asked.append((lib_, entry_, args, index))
        return 2, H100_SMS, coop
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    got, plan = getattr(tfl, fn)(16, 512, True, torch.device("cuda", 0))
    assert got == route
    assert asked == [(lib, entry, (1, plan.bi, plan.units, plan.smem), 0)]


@pytest.mark.parametrize("fn, lib, entry", ROUTES)
def test_route_functions_take_the_step_route_where_a_block_is_too_wide(
        monkeypatch, fn, lib, entry):
    """A plan whose block does not fit shared memory (H=2048 at 8 rows)
    goes to the step route without asking the card."""
    def occupancy(*args):
        raise AssertionError("asked the card for a block that cannot fit")
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    got, plan = getattr(tfl, fn)(8, 2048, False, torch.device("cuda", 0))
    assert got == "step" and plan.smem > tfl._SMEM_MAX


def test_block_shapes_are_the_kernels():
    """The plans pick only the block shapes the kernels instantiate, and
    the shape tables are the sources' instantiations: LSTM_FWD_SHAPES
    fused_lstm_fwd.cu's, LSTM_BWD_SHAPES fused_lstm_bwd.cu's."""
    for B in (1, 5, 8, 9, 13, 16, 17, 32, 100):
        for H in (18, 45, 512, 550, 1024):
            plan = tfl.lstm_fwd_plan(B, H)
            assert (plan.bi, plan.units) in tfl.LSTM_FWD_SHAPES
            plan = tfl.lstm_bwd_stash_plan(B, H)
            assert (plan.bi, plan.units) in tfl.LSTM_BWD_SHAPES
    csrc = pathlib.Path(tfl.__file__).parent / "csrc"
    for name, macro, table in (("fused_lstm_fwd.cu", "PK_FWD_SHAPE",
                                tfl.LSTM_FWD_SHAPES),
                               ("fused_lstm_bwd.cu", "PK_BWD_SHAPE",
                                tfl.LSTM_BWD_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro,
                          (csrc / name).read_text(), re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table


@pytest.mark.parametrize("H, L", [(18, 128), (45, 128), (512, 640),
                                  (550, 640), (1024, 1152), (2048, 2176)])
def test_lane_row(H, L):
    """A lane-major row: 32 segments of an odd number of float4s holding
    the ceil(H / 32) values a lane sums (the 8 lanes of a 16-byte load's
    phase then read 32 distinct banks)."""
    SJ = tfl.lane_row(H) // 32
    assert tfl.lane_row(H) == L and SJ % 4 == 0 and (SJ // 4) % 2 == 1
    assert SJ >= -(-H // 32)
    assert sorted(l * SJ % 32 for l in range(8)) == list(range(0, 32, 4))


def test_dense_width_limit_is_the_step_kernels():
    """The wrappers' width limits stay the step kernels' (the route at the
    limit); the persistent routes end long before: the widest 8-row stash
    BPTT whose 8-unit blocks are co-resident at one an SM is 1,056 (132
    unit groups)."""
    assert tfl.dense_max_width("lstm") == 7248
    assert tfl.dense_max_width("lstm", "stash") == 1806
    for B in (1, 8):
        assert tfr.persist_route(tfl.lstm_fwd_plan(B, 7248), 2,
                                 H100_SMS) == "step"
        assert tfr.persist_route(tfl.lstm_bwd_stash_plan(B, 1806), 2,
                                 H100_SMS) == "step"
    widest = max(h for h in range(8, 1806, 2) if tfr.persist_route(
        tfl.lstm_bwd_stash_plan(8, h), 1, H100_SMS) == "persist")
    assert widest == 1056


# ---------------------------------------------------------------------------
# the sparse forward and stash BPTT (TPU rows 4 and 5) at the CGS-16x layout
# ---------------------------------------------------------------------------

def _cgs16x_layout(seed):
    """A CGS-16x recurrent layout (HCGS 128,8 at 75,75 over 1024 x 1024):
    chip_smoke.py's timed seed 97 (C = 3) or seed 421 (C = 5)."""
    mask = hcgs_mask(1024, 1024, [128, 8], [75, 75],
                     rng=np.random.RandomState(seed))
    return tbs.pack_layout(mask, 128)


def _small_layout(bs, seed=5, width=64):
    """A ``width``-wide layout of 50% kept blocks of bs."""
    mask = hcgs_mask(width, width, [bs], [50],
                     rng=np.random.RandomState(seed))
    return tbs.pack_layout(mask, bs)


@pytest.mark.parametrize("seed, C, counts", [
    (97, 3, (2, 1, 0, 3, 3, 2, 2, 3)), (421, 5, None)])
def test_cgs16x_layouts_columns(seed, C, counts):
    """The timed layout's block columns hold 0-3 kept blocks (column 2
    none); seed 421's heaviest holds 5. Both keep R = 2 of Kb = 8."""
    layout = _cgs16x_layout(seed)
    assert (layout.R, layout.Kb, layout.bs, layout.C) == (2, 8, 128, C)
    if counts:
        assert tbs.column_counts(layout) == counts


@pytest.mark.parametrize("seed", [97, 421])
@pytest.mark.parametrize("B, bi, units, grid, smem", [
    (16, 2, 4, 256, 34048),         # train: 4 units x 16 rows, two an SM
    (8, 1, 4, 256, 25216),          # serve: 4 x 8, two blocks an SM
    (160, 2, 8, 1280, 51456),       # the large batch: not co-resident
])
def test_lstm_fwd_sparse_plan_at_the_cgs16x_layout(seed, B, bi, units, grid,
                                                   smem):
    """Row 4: a block owns units of one out-block with their 4 x units
    rows of w3g resident (R*bs = 256 floats each), the staged rows of
    q(h_{t-1}) 260 floats apart and one sum a row and gate-unit; the block
    shape is 4 units x 8 or 16 rows where two such blocks an SM hold the
    grid, else the dense chain's, and the column counts do not enter."""
    plan = tfl.lstm_fwd_sparse_plan(B, _cgs16x_layout(seed))
    bt, K3 = 8 * bi, 256
    assert (plan.bi, plan.units, plan.grid, plan.static) == (bi, units,
                                                             grid, 0)
    assert plan.smem == 4 * (4 * units * K3 + bt * (K3 + 4)
                             + bt * 4 * units) == smem
    assert plan.resident == 4 * 4 * units * K3
    assert plan.staged == 4 * min(bt, B) * K3
    assert (plan.slab, plan.slabs) == (0, 1)


@pytest.mark.parametrize("B, shape, grid, smem", [
    (16, (2, 8), 128, 51456), (16, (1, 8), 256, 42112),
    (16, (1, 4), 512, 25216), (8, (1, 8), 128, 42112),
    (8, (2, 8), 128, 51456)])
def test_lstm_fwd_sparse_plan_forced(B, shape, grid, smem):
    """The block shapes the tables hold, forced: 8 units x 16 rows (one
    an SM at 16 rows), 8 x 8 and 4 x 8."""
    plan = tfl.lstm_fwd_sparse_plan(B, _cgs16x_layout(97), shape)
    assert (plan.bi, plan.units, plan.grid, plan.smem) == shape + (grid,
                                                                    smem)


@pytest.mark.parametrize("seed, B, shape, bi, units, slab, slabs, smem", [
    # C = 3: whole rows of 3 x 512 values in one buffer; at 16 rows two
    # blocks of 8 rows an SM
    (97, 16, None, 1, 8, 1536, 1, 49152 + 49280 + 256),
    (97, 8, None, 1, 8, 1536, 1, 49152 + 49280 + 256),
    (97, 160, None, 2, 8, 1536, 1, 148224),
    (97, 16, (2, 8), 2, 8, 1536, 1, 49152 + 98560 + 512),
    # C = 4 (the cfg's layers): two blocks of 8 rows an SM in slabs of one
    # entry; 16 rows would hold whole rows
    (96, 16, None, 1, 8, 512, 4, 65536 + 2 * 8 * 516 * 4 + 256),
    (96, 16, (2, 8), 2, 8, 2048, 1, 65536 + 4 * 16 * 2052 + 512),
    # C = 5: two blocks of 8 rows an SM in slabs, exactly half an SM; at
    # 16 rows whole rows would take 246,528 bytes: one entry (512
    # values) a slab through two buffers
    (421, 16, None, 1, 8, 512, 5, 81920 + 2 * 8 * 516 * 4 + 256),
    (421, 16, (2, 8), 2, 8, 512, 5, 81920 + 66048 + 512),
    (421, 8, None, 1, 8, 2560, 1, 81920 + 4 * 8 * 2564 + 256),
    (421, 160, None, 2, 8, 512, 5, 148480),
])
def test_lstm_bwd_sparse_stash_plan_at_the_cgs16x_layout(
        seed, B, shape, bi, units, slab, slabs, smem):
    """Row 5: a block owns units of one block column with their columns of
    the 4 gates' U at each of the column's (at most C) entries resident
    as rows (4bs = 512 floats a unit and an entry, no padding: the step
    kernel's dot order), stages dg_{t+1} at the entries' out-blocks and
    keeps one sum a row and unit; the entry lists are static. 8 units x 8
    rows where two such blocks an SM hold the grid and fit its shared
    memory (whole rows, or one entry a slab, in half an SM), else 16 rows;
    whole rows where they fit, else one entry a slab in two buffers."""
    layout = _cgs16x_layout(seed)
    C = layout.C
    plan = tfl.lstm_bwd_sparse_stash_plan(B, layout.N, layout.bs, C, shape)
    bt, KC = 8 * bi, C * 512
    assert (plan.bi, plan.units, plan.grid) == (bi, units,
                                                128 * -(-B // bt))
    assert (plan.static, plan.resident) == (512, 4 * units * KC)
    assert (plan.slab, plan.slabs, plan.smem) == (slab, slabs, smem)
    assert plan.staged == 4 * min(bt, B) * KC
    assert plan.smem + plan.static <= tfl._SMEM_MAX
    two = 2 * (plan.smem + plan.static + tfl._SMEM_RESERVED)
    if B == 16 and shape is None:
        assert bi == 1 and two <= tfl._SMEM_SM
    if slabs > 1 and bi == 2:
        whole = 4 * (units * KC + bt * (KC + 4) + bt * units)
        assert whole == 246528 and whole + 512 > tfl._SMEM_MAX
        assert plan.smem == 4 * (units * KC + 2 * bt * 516 + bt * units)


@pytest.mark.parametrize("shape, smem", [
    # C = 3: resident 4 * units * 3 * 512, two buffers of bt rows of one
    # entry (516 floats apart), one sum a row and unit
    ((1, 4), 24576 + 2 * 4 * 8 * 516 + 128),
    ((1, 8), 49152 + 2 * 4 * 8 * 516 + 256),
    ((2, 8), 49152 + 66048 + 512),
])
def test_lstm_bwd_sparse_stash_plan_entry_slabs(shape, smem):
    """``entry_slabs`` forces a block shape that holds whole rows at the
    timed layout (C = 3) to stage one entry a slab through two buffers,
    the staging the plan takes where whole rows do not fit; it needs a
    shape."""
    layout = _cgs16x_layout(97)
    whole = tfl.lstm_bwd_sparse_stash_plan(16, 1024, 128, 3, shape)
    plan = tfl.lstm_bwd_sparse_stash_plan(16, 1024, 128, 3, shape,
                                          entry_slabs=True)
    assert layout.C == 3 and (whole.slab, whole.slabs) == (1536, 1)
    assert (plan.slab, plan.slabs, plan.smem) == (512, 3, smem)
    assert plan._replace(slab=whole.slab, slabs=1, smem=whole.smem) == whole
    with pytest.raises(ValueError):
        tfl.lstm_bwd_sparse_stash_plan(16, 1024, 128, 3, entry_slabs=True)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("B", [8, 16])
def test_lstm_bwd_sparse_stash_plan_fits_every_column_count(C, B):
    """Every column count a Kb = 8 layout can reach fits a block at 8 and
    16 rows: at 16 rows two blocks of 8 rows an SM up to C = 5 (whole rows
    up to C = 3), then 16 rows in slabs; at 8 rows whole rows up to C =
    7, one entry a slab past them."""
    plan = tfl.lstm_bwd_sparse_stash_plan(B, 1024, 128, C)
    assert plan.smem + plan.static <= tfl._SMEM_MAX
    whole = C <= (3 if B == 16 else 7)
    assert (plan.slab, plan.slabs) == ((C * 512, 1) if whole else (512, C))
    assert plan.bi == (1 if B == 8 or C <= 5 else 2)


@pytest.mark.parametrize("B, blocks_per_sm, fwd, bwd_c3, bwd_c5", [
    (16, 1, "step", "step", "step"),        # train: 256 blocks each
    (16, 2, "persist", "persist", "persist"),
    (8, 1, "step", "persist", "persist"),   # serve: 256, 128, 128 blocks
    (8, 2, "persist", "persist", "persist"),
    (160, 2, "step", "step", "step"),       # 1,280 blocks
    (160, 8, "step", "step", "step"),       # 1,056 co-resident
])
def test_lstm_sparse_routes(B, blocks_per_sm, fwd, bwd_c3, bwd_c5):
    """Both plans take "persist" where their grids are co-resident at the
    blocks an SM the card holds (every block fits shared memory at C = 3
    and C = 5), "step" where not or without cooperative launches: the
    forward's blocks of 4 units need two an SM at 8 and 16 rows, and so
    does the chain's 8 x 8 at 16 rows (C = 3 and 5), while at 8 rows its
    128 blocks take one an SM."""
    for seed, bwd in ((97, bwd_c3), (421, bwd_c5)):
        layout = _cgs16x_layout(seed)
        f = tfl.lstm_fwd_sparse_plan(B, layout)
        b = tfl.lstm_bwd_sparse_stash_plan(B, layout.N, layout.bs, layout.C)
        assert tfr.persist_route(f, blocks_per_sm, H100_SMS) == fwd
        assert tfr.persist_route(b, blocks_per_sm, H100_SMS) == bwd
        for plan in (f, b):
            assert plan.smem + plan.static <= tfl._SMEM_MAX
            assert tfr.persist_route(plan, blocks_per_sm, H100_SMS,
                                     coop=False) == "step"
            assert tfr.persist_route(plan, 0, H100_SMS) == "step"


SPARSE_ROUTES = (
    ("lstm_fwd_sparse_route", "lstm_fwd_sparse_occupancy",
     lambda B, lay: tfl.lstm_fwd_sparse_plan(B, lay)),
    ("lstm_bwd_sparse_stash_route", "lstm_bwd_sparse_stash_occupancy",
     lambda B, lay: tfl.lstm_bwd_sparse_stash_plan(B, lay.N, lay.bs,
                                                   lay.C)))


@pytest.mark.parametrize("fn, entry, plan_of", SPARSE_ROUTES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B, fit, coop, route", [
    (16, 1, True, "step"), (16, 2, True, "persist"),
    (16, 8, True, "persist"), (16, 2, False, "step"),
    (8, 2, True, "persist"), (160, 8, True, "step")])
def test_lstm_sparse_route_functions_ask_their_kernels(
        monkeypatch, fn, entry, plan_of, bf16, B, fit, coop, route):
    """Each route function asks its own kernel's occupancy entry in
    fused_lstm_sparse with its plan's ints (w3g's dtype, the block shape,
    the dynamic shared memory: stubbed here, ``fit`` blocks an SM on 132
    SMs) and takes "persist" only where the grid is co-resident and the
    card takes cooperative launches."""
    asked = []

    def occupancy(lib, entry_, args, index):
        asked.append((lib, entry_, args, index))
        return fit, H100_SMS, coop
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    layout = _cgs16x_layout(97)
    got, plan = getattr(tfl, fn)(B, layout, bf16, torch.device("cuda", 0))
    assert plan == plan_of(B, layout)
    assert got == route
    assert asked == [("fused_lstm_sparse", entry,
                      (int(bf16), plan.bi, plan.units, plan.smem), 0)]


@pytest.mark.parametrize("fn, entry, plan_of", SPARSE_ROUTES)
def test_lstm_sparse_routes_need_units_that_divide_bs(monkeypatch, fn,
                                                      entry, plan_of):
    """A block's units must lie in one block of bs: at bs = 12 the 8-unit
    blocks of 16 rows of 1536 take "step" without asking the card."""
    def occupancy(*args):
        raise AssertionError("asked the card for a shape it cannot take")
    monkeypatch.setattr(tfr, "_persist_occupancy", occupancy)
    layout = _small_layout(12, width=1536)
    got, plan = getattr(tfl, fn)(16, layout, False, torch.device("cuda", 0))
    assert plan.units == 8 and layout.bs % plan.units and got == "step"


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_lstm_sparse_routes_at_bs_not_a_multiple_of_32(monkeypatch, bs):
    """Unlike the sparse RNN chain's, whose entry is bs values long, the
    LSTM chain's entry is 4bs values: a multiple of the 32 lanes at every
    bs the kernels take (a multiple of 8), so both routes stay
    persistent there."""
    monkeypatch.setattr(tfr, "_persist_occupancy",
                        lambda *args: (1, H100_SMS, True))
    layout = _small_layout(bs)
    for fn, _, _ in SPARSE_ROUTES:
        assert getattr(tfl, fn)(8, layout, False,
                                torch.device("cuda", 0))[0] == "persist"


@pytest.mark.parametrize("route, T, n", [
    ("persist", 300, 1), ("persist", 398, 1), ("persist", 1, 1),
    ("step", 300, 300), ("step", 398, 398), ("step", 16, 16)])
def test_lstm_sparse_launches(route, T, n):
    """One cooperative launch a call, or one kernel a (reverse) step: a
    CGS-16x LSTM train step launches rows 4-5 2 x (1 + 1) times against
    2 x (300 + 300), a recognize row 4 twice against 796."""
    assert tfl.lstm_fwd_sparse_launches(route, T) == n
    assert tfl.lstm_bwd_sparse_stash_launches(route, T) == n


def test_lstm_sparse_block_shapes_are_the_kernels():
    """Both plans pick only block shapes the kernels instantiate (at bs
    128 and 8), and LSTM_FWD_SPARSE_SHAPES / LSTM_BWD_SPARSE_SHAPES are
    fused_lstm_sparse.cu's PK_LSTM_SPARSE_FWD_SHAPE / _BWD_SHAPE lines."""
    for B in (1, 5, 8, 9, 13, 16, 17, 32, 100, 160):
        for layout in (_cgs16x_layout(97), _small_layout(8)):
            plan = tfl.lstm_fwd_sparse_plan(B, layout)
            assert (plan.bi, plan.units) in tfl.LSTM_FWD_SPARSE_SHAPES
            plan = tfl.lstm_bwd_sparse_stash_plan(B, layout.N, layout.bs,
                                                  layout.C)
            assert (plan.bi, plan.units) in tfl.LSTM_BWD_SPARSE_SHAPES
    src = (pathlib.Path(tfl.__file__).parent / "csrc" /
           "fused_lstm_sparse.cu").read_text()
    for macro, table in (
            ("PK_LSTM_SPARSE_FWD_SHAPE", tfl.LSTM_FWD_SPARSE_SHAPES),
            ("PK_LSTM_SPARSE_BWD_SHAPE", tfl.LSTM_BWD_SPARSE_SHAPES)):
        inst = re.findall(r"^  %s\((\d+), (\d+)\)$" % macro, src, re.M)
        assert tuple((int(a), int(b)) for a, b in inst) == table, macro

