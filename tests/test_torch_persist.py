"""The plans and routes of the GRU BPTTs' persistent reverse chains
(pytorch_kaldi_cgs_tpu_torch/ops/fused_rnn.py over csrc/persist.cuh), in
pure Python: which route and grid each wrapper picks for given shapes, SM
counts and shared memory, the launches it then counts, and the staging
layout's claim that the 32 lanes of a warp read 32 banks. The kernels
themselves are held against their twins by the ``cuda`` cases of
tests/test_torch_gru.py and tests/test_torch_gru_cudnn.py."""

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
# the staging layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [8, 64, 256, 384, 768, 1650, 183, 54])
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
