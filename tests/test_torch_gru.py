"""The port's LibriSpeech GRU slice, its kernels, Functions and
training (pytorch_kaldi_cgs_tpu_torch: the v3 projection of
ops/block_sparse.py, the sparse GRU of ops/fused_rnn.py, the MLP's v3
path, ``ChunkRunner`` over the GRU net) against the JAX package on the
same numpy inputs, the Pallas kernels run in interpret mode. The GRU
model itself is tests/test_torch_gru_model.py's.

- The twins of the four kernels against the TPU kernels: the v3 forward
  and dx (G=1, 3 and 4, with and without the level-2 submask and the
  8-bit weight quantizer, a K-padded layout) and the sparse GRU forward
  and BPTT (qbits 0/16, tanh/relu, w3g in f32 and bf16), at small shapes
  (bs=8). Float32 atol 1e-5; with a 16-bit quantizer 1e-4 (an ulp at a
  ceil step is one level, max|h|/2^15); bf16 w3g 1e-4 (both round the
  same operands to bf16 and sum in float32).
- The two autograd Functions against ``jax.vjp`` of
  ``block_sparse_matmul_v3`` and ``gru_scan_fused_sparse`` (1e-5 relative
  to each output's scale; 1e-4 with the 16-bit quantizer), and, without
  JAX, against autograd through a dense-masked matmul and through the
  plain GRU loop.
- The MLP's v3 path (``mlp_block_sparse=True``) against JAX's.
- A JAX runner's packed variables through ``convert`` both ways, and 3
  ``ChunkRunner.train_step``s of a narrow two-head GRU net against the
  JAX runner (1e-5), packed leaves included.

JAX comes in through fixtures, so that the ``cuda`` cases also run where
JAX is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_gru.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5, 1e-4 over the libri shapes' 200-398 steps; the 16-bit
quantizer 1e-4; bf16 w3g 2e-2), each routed call on its route with its
launches, and a persistent call bit for bit over two calls.
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import GRU, MLP
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask
from pytorch_kaldi_cgs_tpu_torch.sparsity.quantize import ste_quantize_weight

ATOL = 1e-5
ATOL_Q = 1e-4           # a 16-bit quantizer; bf16 w3g
tt = torch.from_numpy


@pytest.fixture
def jbs():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.block_sparse")


@pytest.fixture
def jfr():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the v3 projection (_make_fwd_v3, _make_dx_v3)
# ---------------------------------------------------------------------------

V3_M = 24
V3_CASES = {
    # name: (N, K, blocks, drops, G, fuse_sub, qbits)
    "g3_sub_q8": (32, 64, [8, 2], [75, 50], 3, True, 8),
    "g3_plain": (32, 64, [8, 2], [75, 50], 3, False, 0),
    "g1_sub_q8": (32, 64, [8, 2], [50, 50], 1, True, 8),
    "g1_padk_sub_q8": (32, 44, [8, 2], [50, 50], 1, True, 8),
    "g4_q8": (16, 48, [8], [50], 4, False, 8),
}


def _v3_inputs(case, seed=0):
    """The case's layout, x (M, K_true), w3 and sub3 (numpy), the
    layout's mask."""
    N, K, blocks, drops, G, fuse_sub, qbits = V3_CASES[case]
    mask = hcgs_mask(N, K, blocks, drops, rng=np.random.RandomState(seed))
    layout = tbs.pack_layout(mask, 8, pad_k=True)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(V3_M, K).astype(np.float32)
    w3 = (rng.randn(layout.Nb, G * 8, layout.R * 8) * 0.6).astype(np.float32)
    sub3 = tbs.stack_w3_gates([tbs.pack_w3(mask, layout)] * G) \
        if fuse_sub else None
    return mask, layout, x, w3, sub3, G, qbits


def _j_layout(jbs, mask):
    return jbs.pack_layout(mask, 8, pad_k=True)


def _opt(t, a):
    return None if a is None else t(a)


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_v3_fwd_twin_matches_pallas(jbs, case):
    import jax.numpy as jnp
    mask, tl, x, w3, sub3, G, qbits = _v3_inputs(case)
    xp = np.pad(x, ((0, 0), (0, tl.K - x.shape[1])))
    fwd = jbs._build_v3_ops(_j_layout(jbs, mask), G, V3_M, True,
                            sub3 is not None, qbits)[0]
    ref = fwd(jnp.asarray(xp), jnp.asarray(w3), _opt(jnp.asarray, sub3))
    got = tbs.block_sparse_v3_fwd(tt(xp), tt(w3), tl, G, qbits,
                                  _opt(tt, sub3))
    assert tuple(got.shape) == (G, V3_M, tl.N)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_v3_dx_twin_matches_pallas(jbs, case):
    import jax.numpy as jnp
    mask, tl, _, w3, sub3, G, qbits = _v3_inputs(case)
    gy = np.random.RandomState(9).randn(V3_M, tl.Nb * G * 8) \
        .astype(np.float32)
    dxk = jbs._build_v3_ops(_j_layout(jbs, mask), G, 8, True,
                            sub3 is not None, qbits)[1]
    ref = dxk(jnp.asarray(gy), jnp.asarray(w3), jnp.float32,
              _opt(jnp.asarray, sub3))
    got = tbs.block_sparse_v3_dx(tt(gy), tt(w3), tl, G, qbits,
                                 _opt(tt, sub3))
    assert tuple(got.shape) == (V3_M, tl.K)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("with_sub", [False, True], ids=["plain", "sub"])
@pytest.mark.parametrize("qbits", [0, 8])
def test_v3_weight_packed_matches_jax_effective_weight(jbs, qbits, with_sub,
                                                       G):
    """The v3 dx's weight pass twin: the JAX kernels' effective weight
    (``_ceil_quant(w3, qbits) * sub3``), rearranged into the legacy packed
    layout, wp[j*R + k][n][c] = w_eff[j][n][k*bs + c], bit for bit (the
    same float32 operations)."""
    import jax.numpy as jnp
    mask = hcgs_mask(32, 64, [8, 2], [75, 50], rng=np.random.RandomState(3))
    tl = tbs.pack_layout(mask, 8)
    rng = np.random.RandomState(4 + G)
    w3 = (rng.randn(tl.Nb, G * 8, tl.R * 8) * 0.8).astype(np.float32)
    sub3 = tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G) if with_sub \
        else None
    w_eff = jbs._ceil_quant(jnp.asarray(w3), qbits) if qbits \
        else jnp.asarray(w3)
    if with_sub:
        w_eff = w_eff * jnp.asarray(sub3)
    want = _np(w_eff).reshape(tl.Nb, G * 8, tl.R, 8).transpose(0, 2, 1, 3) \
        .reshape(tl.nnz, G * 8, 8)
    got = tbs.v3_weight_packed_plain(tt(w3), tl, G, qbits, _opt(tt, sub3))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bs, G, qbits, with_sub", [
    (8, 3, 8, True), (8, 1, 0, False),     # 16-byte loads on the card
    (6, 3, 8, True), (6, 1, 0, False)])    # 4-byte loads
def test_legacy_dx_over_packed_weight_matches_pallas_v3_dx(jbs, bs, G, qbits,
                                                           with_sub):
    """The v3 dx as the card runs it, on the CPU: the legacy dx twin over
    the packed effective weight (v3_weight_packed_plain) against
    ``_make_dx_v3`` in interpret mode, at a bs whose rows dx_gemm reads 16
    bytes at a time and at one it reads 4 at a time."""
    import jax.numpy as jnp
    mask = hcgs_mask(4 * bs, 8 * bs, [bs, 2], [75, 50],
                     rng=np.random.RandomState(bs + G))
    tl = tbs.pack_layout(mask, bs)
    rng = np.random.RandomState(7 * bs + G)
    w3 = (rng.randn(tl.Nb, G * bs, tl.R * bs) * 0.6).astype(np.float32)
    sub3 = tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G) if with_sub \
        else None
    gy = rng.randn(V3_M, tl.Nb * G * bs).astype(np.float32)
    dxk = jbs._build_v3_ops(jbs.pack_layout(mask, bs), G, 8, True,
                            with_sub, qbits)[1]
    ref = dxk(jnp.asarray(gy), jnp.asarray(w3), jnp.float32,
              _opt(jnp.asarray, sub3))
    wp = tbs.v3_weight_packed_plain(tt(w3), tl, G, qbits, _opt(tt, sub3))
    got = tbs.bsl_dx_plain(tt(gy), wp, tl, G)
    assert tuple(got.shape) == (V3_M, tl.K)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


def _v3_grads(x, w3, sub3, layout, G, qbits, gy, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    xs, ws = d(x).requires_grad_(), d(w3).requires_grad_()
    ys = tbs.block_sparse_matmul_v3(xs, ws, layout, G, qbits,
                                    None if sub3 is None else d(sub3))
    ys.backward(d(gy))
    return [ys.detach().cpu().numpy(), xs.grad.cpu().numpy(),
            ws.grad.cpu().numpy()]


def _assert_rel(got, ref, tol, names):
    for name, a, b in zip(names, got, ref):
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("case", ["g3_sub_q8", "g3_plain", "g1_padk_sub_q8"])
def test_v3_function_matches_jax_vjp(jbs, case):
    """ys, dx and dw3 of the port's v3 Function against jax.vjp of the
    JAX package's block_sparse_matmul_v3 custom VJP (K-padded x padded
    outside the op, its gradient sliced, as both models do)."""
    import jax
    import jax.numpy as jnp
    mask, tl, x, w3, sub3, G, qbits = _v3_inputs(case, seed=3)
    jl = _j_layout(jbs, mask)
    gy = np.random.RandomState(4).randn(G, V3_M, tl.N).astype(np.float32)
    pad = tl.K - x.shape[1]

    def f(x_, w_):
        return jbs.block_sparse_matmul_v3(
            jnp.pad(x_, ((0, 0), (0, pad))), w_, None, jl, G, tile_m=V3_M,
            interpret=True, sub3=_opt(jnp.asarray, sub3), quant_bits=qbits)
    ys, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w3))
    ref = [_np(ys)] + [_np(a) for a in vjp(jnp.asarray(gy))]
    _assert_rel(_v3_grads(x, w3, sub3, tl, G, qbits, gy), ref, ATOL,
                ["ys", "dx", "dw3"])


@pytest.mark.parametrize("qbits", [0, 8])
def test_v3_function_equals_dense_masked_autograd(qbits):
    """Independent of JAX: the v3 Function over w3 gathered from dense
    weights gives the dense-masked projection (ste_quantize_weight(w *
    mask)) and its gradients, dropped blocks zero."""
    mask, tl, x, _, _, G, _ = _v3_inputs("g3_sub_q8", seed=6)
    rng = np.random.RandomState(7)
    ws = [rng.randn(*mask.shape).astype(np.float32) * 0.6 for _ in range(G)]
    gy = rng.randn(G, V3_M, tl.N).astype(np.float32)
    sub3 = tt(tbs.stack_w3_gates([tbs.pack_w3(mask, tl)] * G))
    got_w = [tt(w).requires_grad_() for w in ws]
    got_x = tt(x).requires_grad_()
    ys = tbs.block_sparse_matmul_v3(got_x, tbs.gather_w3(got_w, tl), tl, G,
                                    qbits, sub3)
    ys.backward(tt(gy))
    ref_w = [tt(w).requires_grad_() for w in ws]
    ref_x = tt(x).requires_grad_()
    m = tt(mask.astype(np.float32))
    eff = [ste_quantize_weight(w * m, qbits) if qbits else w * m
           for w in ref_w]
    ref = torch.stack([ref_x @ e.T for e in eff])
    ref.backward(tt(gy))
    np.testing.assert_allclose(ys.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(got_x.grad.numpy(), ref_x.grad.numpy(),
                               atol=ATOL)
    for a, b in zip(got_w, ref_w):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=ATOL)


def test_v3_wrappers_reject_bad_inputs():
    _, tl, x, w3, sub3, G, _ = _v3_inputs("g1_padk_sub_q8")
    with pytest.raises(ValueError, match="x must be"):
        tbs.block_sparse_v3_fwd(tt(x), tt(w3), tl, G)      # not padded
    xp = tt(np.pad(x, ((0, 0), (0, tl.K - x.shape[1]))))
    with pytest.raises(ValueError, match="w3 must be"):
        tbs.block_sparse_v3_fwd(xp, tt(w3[:, :-1]), tl, G)
    with pytest.raises(ValueError, match="float32"):
        tbs.block_sparse_v3_fwd(xp.double(), tt(w3), tl, G)
    with pytest.raises(ValueError, match="gy_flat must be"):
        tbs.block_sparse_v3_dx(xp, tt(w3), tl, G)
    with pytest.raises(ValueError, match="sub3 must be"):
        tbs.block_sparse_v3_dx(torch.zeros(V3_M, tl.Nb * G * 8), tt(w3), tl,
                               G, 8, tt(sub3[:1]))


# ---------------------------------------------------------------------------
# the sparse GRU (_build_gru_fwd_sparse, _build_gru_bwd_sparse)
# ---------------------------------------------------------------------------

T, B, H, BS = 10, 3, 32, 8      # Kb=4, R=2 at 50% level-1 drop


def _gru_inputs(seed, drop_bh=True, b=B):
    """Gates (T, b, 3H) [h | z | r], w3g (Nb, 3bs, R*bs), the layout,
    drop, upstream dhs."""
    mask = hcgs_mask(H, H, [BS], [50], rng=np.random.RandomState(seed))
    layout = tbs.pack_layout(mask, BS)
    rng = np.random.RandomState(seed + 1)
    g = (rng.randn(T, b, 3 * H) * 0.5).astype(np.float32)
    w3g = (rng.randn(layout.Nb, 3 * BS, layout.R * BS) * 0.35) \
        .astype(np.float32)
    drop = ((rng.rand(b, H) > 0.2).astype(np.float32) if drop_bh
            else np.full((1, 1), 0.8, np.float32))
    dhs = rng.randn(T, b, H).astype(np.float32)
    return mask, layout, g, w3g, drop, dhs


def _j_gru(jfr, jbs, mask, builder, act, qbits):
    jl = jbs.pack_layout(mask, BS)
    return getattr(jfr, builder)(T, B, H, act, qbits, jl.Nb, jl.R, BS,
                                 tuple(int(v) for v in jl.col_idx), True)


def _gru_atol(qbits, wbf16):
    return ATOL_Q if (qbits == 16 or wbf16) else ATOL


def _h_prev(hs):
    return np.concatenate([np.zeros((1,) + hs.shape[1:], np.float32),
                           hs[:-1]])


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_gru_fwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, _ = _gru_inputs(2)
    fwd = _j_gru(jfr, jbs, mask, "_build_gru_fwd_sparse", act, qbits)
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    ref = fwd(jnp.asarray(g), jw, jnp.asarray(drop))
    got = tfr.fused_gru_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act, qbits,
                                   wbf16)
    np.testing.assert_allclose(got.numpy(), _np(ref),
                               atol=_gru_atol(qbits, wbf16))


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_gru_bwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    """dg and the emitted s = r * h_prev of the BPTT twin against the
    TPU kernel, both over the same forward's h_prev."""
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _gru_inputs(4)
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    hs = _np(_j_gru(jfr, jbs, mask, "_build_gru_fwd_sparse", act, qbits)(
        jnp.asarray(g), jw, jnp.asarray(drop)))
    h_prev = _h_prev(hs)
    bwd = _j_gru(jfr, jbs, mask, "_build_gru_bwd_sparse", act, qbits)
    ref_dg, ref_s = bwd(jnp.asarray(g), jw, jnp.asarray(drop),
                        jnp.asarray(h_prev), jnp.asarray(dhs))
    dg, s = tfr.fused_gru_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                     tt(dhs), tl, act, qbits, wbf16)
    atol = _gru_atol(qbits, wbf16)
    np.testing.assert_allclose(s.numpy(), _np(ref_s), atol=atol)
    np.testing.assert_allclose(dg.numpy(), _np(ref_dg), atol=atol)


def _gru_grads(g, w3g, drop, dhs, layout, qbits, act="tanh", dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(w3g).requires_grad_()]
    hs = tfr.gru_scan_fused_sparse(leaves[0], leaves[1], layout, d(drop),
                                   act=act, quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("qbits", [0, 16])
def test_gru_function_matches_jax_vjp(jbs, jfr, qbits, drop_bh):
    """hs, dgates and dw3g of the Function (dU as two block-sparse dw
    products, q(s) and q(h_prev)) against jax.vjp of the JAX custom VJP.
    At B=4: the JAX package's ``sparse_dU`` tiles T*B by 8 rows and drops
    the remainder when T*B is not a multiple of 8 (at B=3 its dw3g misses
    the last 6 rows' terms), so the comparison takes T*B = 40."""
    import jax
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _gru_inputs(13, drop_bh, b=4)
    jl = jbs.pack_layout(mask, BS)
    hs, vjp = jax.vjp(lambda g_, w_: jfr.gru_scan_fused_sparse(
        g_, w_, jl, jnp.asarray(drop), act="tanh", quant_bits=qbits,
        interpret=True), jnp.asarray(g), jnp.asarray(w3g))
    ref = [_np(hs)] + [_np(a) for a in vjp(jnp.asarray(dhs))]
    _assert_rel(_gru_grads(g, w3g, drop, dhs, tl, qbits), ref,
                ATOL_Q if qbits else ATOL, ["hs", "dgates", "dw3g"])


@pytest.mark.parametrize("qbits", [0, 16])
def test_gru_function_equals_autograd_through_plain_loop(qbits):
    """Independent of JAX: the Function's backward (BPTT twin + the two
    dw products) equals torch.autograd through the plain forward loop
    with its straight-through quantizers."""
    _, tl, g, w3g, drop, dhs = _gru_inputs(17)
    got = _gru_grads(g, w3g, drop, dhs, tl, qbits)
    leaves = [tt(g).requires_grad_(), tt(w3g).requires_grad_()]
    hs = tfr.fused_gru_fwd_sparse_plain(leaves[0], leaves[1], tt(drop), tl,
                                        "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    _assert_rel(got, ref, ATOL, ["hs", "dgates", "dw3g"])


def test_gru_sparse_wrappers_reject_bad_inputs():
    _, tl, g, w3g, drop, dhs = (_gru_inputs(0))
    g, w3g, drop, dhs = tt(g), tt(w3g), tt(drop), tt(dhs)
    with pytest.raises(ValueError, match="w3g must be"):
        tfr.fused_gru_fwd_sparse(g, w3g[:, :-1], drop, tl)
    with pytest.raises(ValueError, match="layout"):
        tfr.fused_gru_fwd_sparse(g[..., :-3], w3g, drop, tl)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_gru_fwd_sparse(g, w3g, drop, tl, act="sigmoid")
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_gru_bwd_sparse(g, w3g, drop, dhs, dhs[:-1], tl)
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_gru_fwd_sparse(g.requires_grad_(), w3g, drop, tl)


# ---------------------------------------------------------------------------
# the MLP's v3 path
# ---------------------------------------------------------------------------

F_IN = 40


def _perturbed(tree, seed):
    """Non-trivial BN statistics and norm parameters."""
    rng = np.random.RandomState(seed)
    out = {"params": dict(tree["params"]), "state": dict(tree["state"]),
           "masks": tree["masks"]}
    for k, v in tree["state"].items():
        n = v["mean"].shape
        out["state"][k] = {
            "mean": (rng.randn(*n) * 0.3).astype(np.float32),
            "var": (rng.rand(*n) + 0.5).astype(np.float32)}
    for k, v in tree["params"].items():
        if isinstance(v, dict):
            out["params"][k] = {kk: (vv + rng.randn(*vv.shape) * 0.2)
                                .astype(np.float32) for kk, vv in v.items()}
    return out


def mlp_opts(mode="True", quant=True):
    return {"to_do": "train", "arch_name": "mlp", "dnn_lay": "256,128",
            "dnn_drop": "0.0,0.0", "dnn_use_batchnorm": "True,False",
            "dnn_use_laynorm": "False,True", "dnn_use_laynorm_inp": "False",
            "dnn_use_batchnorm_inp": "False", "dnn_act": "relu,softmax",
            "mlp_hcgs": "True", "hcgs_block": "128,4", "hcgs_sparse": "50,50",
            "mlp_quant": str(quant), "param_quant": "8",
            "mlp_quant_inp": str(quant), "inp_quant": "16",
            "mlp_block_sparse": mode}


def test_mlp_v3_matches_jax(jm):
    """mlp_block_sparse=True: both layers (a K-padded 40-wide input and a
    256-wide one) on the v3 kernels at G=1, output and gradients against
    JAX apply on its packed variables; packing changes nothing."""
    import jax
    import jax.numpy as jnp
    opts = mlp_opts()
    jmod = jm.MLP(opts, F_IN)
    tree = _perturbed(jmod.init(4), 5)
    jmod.prepare_block_sparse(tree)
    assert sorted(jmod._bs_layouts) == [0, 1]
    packed = jmod.pack_variables(tree)
    x = np.random.RandomState(8).randn(20, F_IN).astype(np.float32)
    wy = np.random.RandomState(9).randn(20, 128).astype(np.float32)

    def loss(params):
        y, _ = jmod.apply({**packed, "params": params}, jnp.asarray(x),
                          train=False)
        return jnp.sum(y * wy), y
    (_, y_ref), grads = jax.value_and_grad(loss, has_aux=True)(
        packed["params"])
    port = MLP(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    assert sorted(port._bs_layouts) == [0, 1]
    with torch.no_grad():
        y_unpacked = port.run(tt(x), train=False)
    port.pack_variables()
    y = port.run(tt(x), train=False)
    (y * tt(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL)
    np.testing.assert_allclose(y_unpacked.numpy(), y.detach().numpy(),
                               atol=1e-6)
    ref_g = convert.flatten(jax.device_get(grads))
    assert sorted(ref_g) == sorted(port.params)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(port.params[k].grad.numpy(), _np(v),
                                   atol=ATOL_Q * scale, err_msg=k)


# ---------------------------------------------------------------------------
# a JAX runner's packed variables, and 3 train steps against its runner
# ---------------------------------------------------------------------------

LIBRI_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "LibriSpeech_baselines",
                         "libri_GRU_hcgs_multihost.cfg")


def _assert_tree_equal(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


N_CD, N_MONO, ST_T, ST_B, SEED, STEPS = 40, 12, 12, 4, 3, 3


def libri_chunk_config(lay="256,256", n_cd=N_CD, n_mono=N_MONO,
                       batch=ST_B):
    """The libri cfg's [architecture1..2] with the GRU narrowed to
    ``lay`` (gru_block_sparse=True, dropout 0), a second, mono head
    (a copy of the cd head's section) and a two-head [model], over an
    in-memory chunk of fMLLR features and cd and mono label streams."""
    src = configparser.ConfigParser()
    src.read(LIBRI_CFG)
    cc = configparser.ConfigParser()
    cc.read_string("[exp]\nto_do = train\nseed = 0\n\n[batches]\n"
                   "batch_size_train = %d\n\n[data_chunk]\n"
                   "fea = fea_name=fmllr\n\tfea_lst=none\n\tfea_opts=none\n"
                   "\tcw_left=0\n\tcw_right=0\n"
                   "lab = lab_name=lab_cd\n\tlab_folder=none\n"
                   "\tlab_opts=ali-to-pdf\n\n\tlab_name=lab_mono\n"
                   "\tlab_folder=none\n\tlab_opts=ali-to-phones\n" % batch)
    cc["architecture1"] = dict(src["architecture1"])
    cc["architecture2"] = dict(src["architecture2"])
    cc["architecture3"] = dict(src["architecture2"], arch_name="MLP_mono",
                               dnn_lay=str(n_mono))
    cc["architecture2"]["dnn_lay"] = str(n_cd)
    a1 = cc["architecture1"]
    n = len(lay.split(","))
    a1.update({"gru_lay": lay, "gru_block_sparse": "True",
               "gru_drop": ",".join(["0.0"] * n)})
    for k in ("gru_use_laynorm", "gru_use_batchnorm", "gru_act",
              "param_quant"):
        a1[k] = ",".join(a1[k].split(",")[:n])
    for sec in ("architecture1", "architecture2", "architecture3"):
        # RMSprop's first step is lr * g / (sqrt(1 - alpha) |g| + eps): at
        # eps 1e-8 a gradient that cancels to float32 noise becomes a step
        # of lr * noise / eps, different in each package (as in
        # tests/test_torch_ligru.py); eps 1e-6 keeps that below 1e-6
        cc[sec]["opt_eps"] = "1e-6"
    cc["model"] = {
        "model_proto": "proto/model.proto",
        "model": "out_rnn=compute(GRU_layers,fmllr)\n"
                 "out_cd=compute(MLP_out,out_rnn)\n"
                 "out_mono=compute(MLP_mono,out_rnn)\n"
                 "loss_mono=cost_nll(out_mono,lab_mono)\n"
                 "loss_cd=cost_nll(out_cd,lab_cd)\n"
                 "loss_final=sum(loss_cd,loss_mono)\n"
                 "err_final=cost_err(out_cd,lab_cd)"}
    return cc


def _chunks(T_=ST_T, B_=ST_B):
    """The same in-memory chunk for both packages: x ~ N(0, 1) of width
    F_IN, cd and mono labels."""
    from pytorch_kaldi_cgs_tpu.data import dataset as jdata
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    rng = np.random.RandomState(0)
    x = rng.randn(T_, B_, F_IN).astype(np.float32)
    cd = rng.randint(0, N_CD, (T_, B_))
    mono = rng.randint(0, N_MONO, (T_, B_))
    data = np.concatenate([np.concatenate(
        [x[:, b], cd[:, b, None], mono[:, b, None]], 1)
        for b in range(B_)]).astype(np.float32)
    ends = np.cumsum([T_] * B_)
    names = ["u%d" % b for b in range(B_)]
    out = []
    for mod in (jdata, tdata):
        out.append(mod.ChunkData(
            names, data, ends,
            {"fmllr": mod.FeaStream("fmllr", "none", col_start=0,
                                    col_end=F_IN)},
            {"lab_cd": mod.LabStream("lab_cd", "none", col=F_IN),
             "lab_mono": mod.LabStream("lab_mono", "none", col=F_IN + 1)}))
    return out


def _jax_runner(cc, jchunk):
    """The JAX graph, its init(SEED) variables prepared and packed as its
    run_nn does, and its runner."""
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    for arch in jg.net_order:
        jg.nets[arch].prepare_block_sparse(jv[arch])
        jv[arch] = jg.nets[arch].pack_variables(jv[arch])
    return jg, jv, JC.ChunkRunner(jg, cc)


def test_convert_round_trip_of_packed_runner_variables(jm):
    """A JAX runner's packed variables (the narrow libri GRU and its two
    heads) load into the port's nets and come back equal, packed leaves
    and all; the port's graph forward on them equals the JAX one."""
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cc = libri_chunk_config()
    jchunk, pchunk = _chunks()
    jg, jv, _ = _jax_runner(cc, jchunk)
    assert any(k.endswith("__bs") for k in jv["GRU_layers"]["params"])
    tg = tgraph.NetGraph(cc, pchunk, seed=0, device="cpu")
    for arch, tree in jv.items():
        tg.nets[arch].load_variables(convert.from_jax_variables(tree))
    for arch in jv:
        _assert_tree_equal(tg.jax_variables()[arch], jv[arch])
    net = tg.nets["GRU_layers"]
    assert sorted(net._bs_layouts) == [0, 1]
    x = np.random.RandomState(1).randn(ST_T, 2, F_IN).astype(np.float32)
    y_ref, _ = jg.nets["GRU_layers"].apply(jv["GRU_layers"], jnp.asarray(x),
                                          train=False)
    with torch.no_grad():
        y = net.run(tt(x), train=False)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


def test_gru_train_steps_match_jax(jm, monkeypatch):
    """Per-step loss and err to 1e-5 (relative) over 3 steps of the
    narrow two-head GRU net (both x-projections on v3 from packed leaves,
    both recurrences sparse). After the first step every parameter,
    packed leaves included, is within 1e-4 of the JAX runner's: RMSprop's
    first step moves each by about lr / sqrt(1 - alpha) = 1.8e-3, so a
    wrong or missing gradient shows. Later steps are held by the loss
    alone, as tests/test_torch_sparse.py holds the CGS net: the 8-bit
    ceil weight quantizer turns the packages' ulp-level weight
    differences into whole levels, and RMSprop's normalised steps carry
    that into parameters a whole step apart (1.2e-3 seen after step 3)
    while the losses agree to 6e-7."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    calls = []
    real = tfr.fused_gru_fwd_sparse_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_gru_fwd_sparse_plain", spy)
    cc = libri_chunk_config()
    jchunk, pchunk = _chunks()
    jg, jv, jr = _jax_runner(cc, jchunk)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    net = tg.nets["GRU_layers"]
    assert type(net) is GRU and sorted(net._rec_layouts) == [0, 1]
    assert sorted(k for k in net.params if k.endswith("__bs")) == sorted(
        k for k in jv["GRU_layers"]["params"] if k.endswith("__bs"))
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, ST_B, True, np.random.RandomState(SEED), bucket=ST_T))
    jres, tres = [], []
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
        if k == 0:
            ref, got = jax.device_get(jv), tg.jax_variables()
            for arch in ref:
                for coll in ("params", "state"):
                    fa = convert.flatten(ref[arch][coll])
                    fb = convert.flatten(got[arch][coll])
                    assert sorted(fa) == sorted(fb)
                    for key in fa:
                        np.testing.assert_allclose(
                            fb[key], _np(fa[key]), atol=1e-4,
                            err_msg="%s/%s" % (arch, key))
    assert len(calls) == 2 * STEPS          # both layers, every step
    np.testing.assert_allclose(tres, jres, rtol=1e-5)
    assert tres[-1][0] < tres[0][0]


# ---------------------------------------------------------------------------
# on the card: kernels against their twins (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_cuda_v3_kernels_match_twins(cuda_device, case):
    """The v3 forward and dx kernels against their twins on the card, on
    the same tensors; one launch each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, x, w3, sub3, G, qbits = _v3_inputs(case)
    d = lambda a: None if a is None else tt(a).to(cuda_device)
    xp = d(np.pad(x, ((0, 0), (0, tl.K - x.shape[1]))))
    gy = d(np.random.RandomState(9).randn(V3_M, tl.Nb * G * 8)
           .astype(np.float32))
    before = (tbs.block_sparse_v3_fwd.launches,
              tbs.block_sparse_v3_dx.launches)
    ys = tbs.block_sparse_v3_fwd(xp, d(w3), tl, G, qbits, d(sub3))
    dx = tbs.block_sparse_v3_dx(gy, d(w3), tl, G, qbits, d(sub3))
    assert (tbs.block_sparse_v3_fwd.launches,
            tbs.block_sparse_v3_dx.launches) == (before[0] + 1, before[1] + 1)
    ref_y = tbs.block_sparse_v3_fwd_plain(xp, d(w3), tl, G, qbits, d(sub3))
    ref_dx = tbs.block_sparse_v3_dx_plain(gy, d(w3), tl, G, qbits, d(sub3))
    torch.cuda.synchronize()
    np.testing.assert_allclose(ys.cpu().numpy(), ref_y.cpu().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(dx.cpu().numpy(), ref_dx.cpu().numpy(),
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_cuda_gru_kernels_match_twins(cuda_device, act, qbits, wbf16):
    """The sparse GRU forward (the persistent route at this shape: one
    launch) and BPTT (the persistent route: the rebuild's passes and one
    chain, 3-6 launches, and two v3 forward calls) kernels against their
    twins on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, *arrays = _gru_inputs(19)
    g, w3g, drop, dhs = (tt(a).to(cuda_device) for a in arrays)
    assert tfr.gru_bwd_sparse_route(B, tl, wbf16, cuda_device)[0] == \
        "persist"
    assert tfr.gru_fwd_sparse_route(B, tl, wbf16, cuda_device)[0] == \
        "persist"
    before = (tfr.fused_gru_fwd_sparse.launches,
              tfr.fused_gru_bwd_sparse.launches,
              tbs.block_sparse_v3_fwd.launches)
    hs = tfr.fused_gru_fwd_sparse(g, w3g, drop, tl, act, qbits, wbf16)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    dg, s = tfr.fused_gru_bwd_sparse(g, w3g, drop, h_prev, dhs, tl, act,
                                     qbits, wbf16)
    rebuild = {(0, False): 3, (16, False): 6, (0, True): 5, (16, True): 6}
    assert (tfr.fused_gru_fwd_sparse.launches,
            tfr.fused_gru_bwd_sparse.launches,
            tbs.block_sparse_v3_fwd.launches) == (
                before[0] + 1, before[1] + rebuild[qbits, wbf16],
                before[2] + 2)
    ref_h = tfr.fused_gru_fwd_sparse_plain(g, w3g, drop, tl, act, qbits,
                                           wbf16)
    ref_dg, ref_s = tfr.fused_gru_bwd_sparse_plain(g, w3g, drop, h_prev, dhs,
                                                   tl, act, qbits, wbf16)
    torch.cuda.synchronize()
    atol = 2e-2 if wbf16 else (ATOL_Q if qbits else ATOL)
    for a, b in ((hs, ref_h), (s, ref_s), (dg, ref_dg)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=atol)


def _empty_column_layout():
    """H=32 at bs=8, R=2 kept blocks per block row, block column 3 kept
    by no row (and column 0 by three): the persistent chain's blocks of
    that column form no dots."""
    mask = np.zeros((H, H), np.float32)
    for j, cols in enumerate(((0, 1), (1, 2), (0, 2), (0, 1))):
        for c in cols:
            mask[j * BS:(j + 1) * BS, c * BS:(c + 1) * BS] = 1.0
    return mask, tbs.pack_layout(mask, BS)


def _persist_inputs(seed, b, layout):
    rng = np.random.RandomState(seed)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    h, bs = layout.N, layout.bs
    return (d(rng.randn(T, b, 3 * h) * 0.5),
            d(rng.randn(layout.Nb, 3 * bs, layout.R * bs) * 0.35),
            d(rng.rand(b, h) > 0.2), d(rng.randn(T, b, h)))


def _bs16_layout():
    """H=64 at bs=16 (Kb=4, R=2): blocks of 16 units x 16 rows."""
    mask = hcgs_mask(64, 64, [16], [50], rng=np.random.RandomState(43))
    return tbs.pack_layout(mask, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("case", ["b13", "b40", "empty_column", "bs16_b20"])
def test_cuda_gru_bwd_persist_matches_twin(cuda_device, case, qbits, wbf16):
    """The persistent chain (route "persist") against the twin: B=13 (one
    block of 8 units and 32 rows, 19 idle), B=40 (two batch tiles, the
    second ragged), a layout with an empty block column (blocks of 8 units
    and 8 rows), and bs=16 at B=20 (blocks of 16 units and 16 rows, the
    second batch tile ragged); two calls bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b = {"b13": 13, "b40": 40, "empty_column": 5, "bs16_b20": 20}[case]
    tl = {"empty_column": lambda: _empty_column_layout()[1],
          "bs16_b20": _bs16_layout}.get(case, lambda: _gru_inputs(29)[1])()
    if case == "empty_column":
        assert 0 in tbs.column_counts(tl)
    route, plan = tfr.gru_bwd_sparse_route(b, tl, wbf16, cuda_device)
    assert route == "persist" and (plan.bi, plan.units) == {
        "b13": (4, 8), "b40": (4, 8), "empty_column": (1, 8),
        "bs16_b20": (2, 16)}[case]
    g, w3g, drop, dhs = _persist_inputs(37, b, tl)
    with torch.no_grad():
        hs = tfr.fused_gru_fwd_sparse(g, w3g, drop, tl, "tanh", qbits, wbf16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        args = (g, w3g, drop, h_prev, dhs, tl, "tanh", qbits, wbf16)
        dg, s = tfr.fused_gru_bwd_sparse(*args)
        dg2, s2 = tfr.fused_gru_bwd_sparse(*args)
        ref_dg, ref_s = tfr.fused_gru_bwd_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dg, dg2) and torch.equal(s, s2)
    atol = 2e-2 if wbf16 else (ATOL_Q if qbits else ATOL)
    for a, r in ((s, ref_s), (dg, ref_dg)):
        np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(),
                                   atol=atol)


@pytest.mark.cuda
def test_cuda_gru_bwd_step_route_matches_twin(cuda_device):
    """A batch whose chain blocks cannot all be co-resident (4 unit groups
    x 1,056 batch tiles) takes the per-step kernels: 2 + 2T launches, no
    v3 call, against the twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, *_ = _gru_inputs(31)
    b, t = 32 * 1056, 2
    assert tfr.gru_bwd_sparse_route(b, tl, False, cuda_device)[0] == "step"
    g, w3g, drop, dhs = _persist_inputs(41, b, tl)
    g, dhs = g[:t], dhs[:t]
    with torch.no_grad():
        hs = tfr.fused_gru_fwd_sparse_plain(g, w3g, drop, tl, "tanh", 16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        args = (g, w3g, drop, h_prev, dhs, tl, "tanh", 16)
        before = (tfr.fused_gru_bwd_sparse.launches,
                  tbs.block_sparse_v3_fwd.launches)
        dg, s = tfr.fused_gru_bwd_sparse(*args)
        assert (tfr.fused_gru_bwd_sparse.launches,
                tbs.block_sparse_v3_fwd.launches) == (before[0] + 2 * t + 2,
                                                      before[1])
        ref_dg, ref_s = tfr.fused_gru_bwd_sparse_plain(*args)
    torch.cuda.synchronize()
    for a, r in ((s, ref_s), (dg, ref_dg)):
        np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(),
                                   atol=ATOL_Q)


def _fwd_inputs(seed, t, b, layout):
    rng = np.random.RandomState(seed)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    h, bs = layout.N, layout.bs
    return (d(rng.randn(t, b, 3 * h) * 0.5),
            d(rng.randn(layout.Nb, 3 * bs, layout.R * bs)
              / np.sqrt(layout.R * bs)), d(rng.rand(b, h) > 0.2))


def _libri_layout():
    """The libri GRU's recurrent layout (HCGS 128,4 at 75,50 over 1024 x
    1024: Kb=8, R=2)."""
    mask = hcgs_mask(1024, 1024, [128, 4], [75, 50],
                     rng=np.random.RandomState(150))
    return tbs.pack_layout(mask, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("case", ["b13", "bs16_b20", "libri_train",
                                  "libri_serve"])
def test_cuda_gru_fwd_persist_matches_twin(cuda_device, case, qbits, wbf16):
    """The forward's persistent route (one cooperative launch) against the
    twin: B=13 at bs=8 (8 units x 16 rows), bs=16 at B=20 (16 x 16, the
    second batch tile ragged), and the libri layout at the train (T=200,
    32 rows: 16 x 16) and serve (T=398, 16 rows: 8 x 16) shapes; two calls
    bit for bit; the float32 bar 1e-4 over the long shapes' steps (the
    quantizer's ceil step), bf16 w3g 2e-2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, tl = {"b13": (T, 13, _gru_inputs(29)[1]),
                "bs16_b20": (T, 20, _bs16_layout()),
                "libri_train": (200, 32, _libri_layout()),
                "libri_serve": (398, 16, _libri_layout())}[case]
    route, plan = tfr.gru_fwd_sparse_route(b, tl, wbf16, cuda_device)
    assert route == "persist" and (plan.bi, plan.units) == {
        "b13": (2, 8), "bs16_b20": (2, 16), "libri_train": (2, 16),
        "libri_serve": (2, 8)}[case]
    g, w3g, drop = _fwd_inputs(47, t, b, tl)
    args = (g, w3g, drop, tl, "tanh", qbits, wbf16)
    with torch.no_grad():
        before = tfr.fused_gru_fwd_sparse.launches
        hs = tfr.fused_gru_fwd_sparse(*args)
        assert tfr.fused_gru_fwd_sparse.launches == before + 1
        hs2 = tfr.fused_gru_fwd_sparse(*args)
        ref = tfr.fused_gru_fwd_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs2)
    atol = 2e-2 if wbf16 else (ATOL_Q if qbits or t > T else ATOL)
    np.testing.assert_allclose(hs.cpu().numpy(), ref.cpu().numpy(),
                               atol=atol)


@pytest.mark.cuda
def test_cuda_gru_fwd_step_route_matches_twin(cuda_device):
    """160 rows over the libri layout make 320 blocks of 16 units x 16
    rows: the per-step kernels (2T launches), against the twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tl, t, b = _libri_layout(), 3, 160
    assert tfr.gru_fwd_sparse_route(b, tl, False, cuda_device)[0] == "step"
    g, w3g, drop = _fwd_inputs(53, t, b, tl)
    args = (g, w3g, drop, tl, "tanh", 16)
    with torch.no_grad():
        before = tfr.fused_gru_fwd_sparse.launches
        hs = tfr.fused_gru_fwd_sparse(*args)
        assert tfr.fused_gru_fwd_sparse.launches == before + 2 * t
        ref = tfr.fused_gru_fwd_sparse_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(hs.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL_Q)


@pytest.mark.cuda
def test_cuda_functions_match_cpu(cuda_device):
    """Both autograd Functions on the card (kernels, dw included)
    against the same calls on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, g, w3g, drop, dhs = _gru_inputs(23)
    _assert_rel(_gru_grads(g, w3g, drop, dhs, tl, 16, dev=cuda_device),
                _gru_grads(g, w3g, drop, dhs, tl, 16), ATOL_Q,
                ["hs", "dgates", "dw3g"])
    _, vl, x, w3, sub3, G, qbits = _v3_inputs("g1_padk_sub_q8", seed=3)
    gy = np.random.RandomState(4).randn(G, V3_M, vl.N).astype(np.float32)
    _assert_rel(_v3_grads(x, w3, sub3, vl, G, qbits, gy, dev=cuda_device),
                _v3_grads(x, w3, sub3, vl, G, qbits, gy), ATOL,
                ["ys", "dx", "dw3"])
