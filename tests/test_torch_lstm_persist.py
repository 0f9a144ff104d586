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

import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

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
