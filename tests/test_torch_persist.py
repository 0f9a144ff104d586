"""The plans and routes of the persistent chains (pytorch_kaldi_cgs_tpu_
torch/ops/fused_rnn.py over csrc/persist.cuh): the GRU BPTTs' reverse
chains, the liGRU recompute BPTT's and the sparse GRU forward's, in pure
Python: which route and grid each wrapper picks for given shapes, SM
counts and shared memory, the slabs a staged row is cut into, the
launches it then counts, and the staging layout's claim that the 32
lanes of a warp read 32 banks. The kernels themselves are held against
their twins by the ``cuda`` cases of tests/test_torch_gru.py,
tests/test_torch_gru_cudnn.py, tests/test_torch_ligru.py and
tests/test_torch_libri_ligru.py."""

import numpy as np
import pytest

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
    """Both plans pick only the block shapes the kernels instantiate:
    (1, 8), (2, 8), (4, 8) and (2, 16)."""
    shapes = {(1, 8), (2, 8), (4, 8), (2, 16)}
    layout = _libri_layout()
    for B in (1, 5, 8, 9, 16, 17, 32, 100):
        plan = tfr.ligru_bwd_plan(B, 1024)
        assert (plan.bi, plan.units) in shapes
        plan = tfr.gru_fwd_sparse_plan(B, layout)
        assert (plan.bi, plan.units) in shapes


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
