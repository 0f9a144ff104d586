"""The port's minimalGRU (pytorch_kaldi_cgs_tpu_torch: the minimalGRU of
ops/fused_rnn.py, models/recurrent.py minimalGRU) against the JAX package
on the same numpy inputs, the Pallas kernels run in interpret mode.

- The dense twins (forward: plain, stash, seeded; the stash and the
  recompute BPTT) against ``_build_mgru_fwd``, ``_build_mgru_bwd_stash``
  and ``_build_mgru_bwd`` at a ragged shape (B=3, H=18), relu and tanh,
  qbits 0 and 16 (the stash backward over every activation).
- The sparse twins against ``_build_mgru_fwd_sparse`` and
  ``_build_mgru_bwd_sparse`` (dg and the emitted s) at H=256, bs=128
  (Kb=2, R=1), w3g in f32 and bf16.
- ``mgru_scan_fused`` and ``mgru_scan_fused_sparse`` (the autograd
  Functions; dU as two products over the unrolled batch, dw3g on the
  block-sparse dw kernel's twin) against ``jax.vjp`` of the JAX custom
  VJPs, and against autograd through the plain loops.
- ``minimalGRU.init(seed)`` array for array; a narrow HCGS + 8-bit +
  16-bit + BN minimalGRU in eval (f32 and bf16 compute) and in train mode
  with gradients against JAX ``apply`` and ``jax.grad``, dense and with
  128-block sparse recurrent masks (both recurrences on the sparse
  kernels, also where the JAX size rule says ""); the plain step loop
  against the JAX ``lax.scan``; the stream against the whole utterance.
- 3 ``ChunkRunner.train_step``s of the TIMIT Li-GRU cfg renamed to
  minimalGRU, narrowed (dense: 2x16 at 8-blocks; sparse: 2x256 at the
  CGS-16x paper's HCGS fields), against the JAX runner.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's); with
a 16-bit quantizer 1e-4 (a one-ulp difference at a ceil step becomes one
step, max|v|/2^15, which the next steps' dots carry on; the minimalGRU
has two such quantizers in series, on h and on z * h); bf16 w3g 1e-4
(both packages round the same operands to bf16 and sum in float32).
The Functions' outputs and the models' gradients are held relative to
each one's scale at the same bars: dU sums |dg| * q(s) over the T*B
rows, so one quantized s a step apart moves it by ~2^-15 of its scale. T*B is a multiple of 8 wherever dU or dw3g is compared: the
JAX package's ``sparse_dU`` drops the rows past one. For relu the
candidate's gate inputs sit away from 0 by more than the recurrent term,
so relu' cannot flip between the two packages' sums.

The recompute BPTT's persistent route (TPU row 26) rebuilds z, s, q(s)
and a_pre of all steps at once as products over the unrolled batch
before its reverse chain; that decomposition in plain PyTorch, then the
chain over it, is held to ``_build_mgru_bwd`` at the recompute twin's
bars.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_mgru.py``).
There the kernels are held against their twins on the same tensors
(float32 1e-5 of scale; the 16-bit quantizers 1e-4; bf16 w3g 2e-2), and
the recompute BPTT's persistent route at every instantiated block shape
against its step route and its twin at the same bars (its chain's dots
sum in another order than the step kernels'), and both routes at their
shapes with their launches.
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import get_model_class, minimalGRU
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

T, B, H = 12, 4, 18            # dense twins; T*B = 48
SP_T, SP_H, BS = 6, 256, 128   # sparse: Kb=2, R=1; T*B = 24
F_IN = 12
ATOL = 1e-5
ATOL_Q = 1e-4                  # a 16-bit quantizer; bf16 w3g
tt = torch.from_numpy


@pytest.fixture
def jfr():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")


@pytest.fixture
def jbs():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.block_sparse")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _np(x):
    return np.array(x, np.float32)      # a writable copy: torch takes it


def _f(a):
    return np.asarray(a, np.float32)


def _gates(rng, t, b, h, act):
    g = rng.randn(t, b, 2 * h) * 0.5
    if act == "relu":
        sign = np.where(rng.rand(1, b, h) > 0.5, 1.0, -1.0)
        g[..., :h] = sign * (2.0 + np.abs(g[..., :h]))
    return g


def _inputs(seed, act="tanh", drop_bh=True):
    """Dense: gates (T, B, 2H) [h | z], U (2H, H) [Uh; Uz], drop, h0,
    dhs."""
    rng = np.random.RandomState(seed)
    g = _gates(rng, T, B, H, act)
    U = rng.randn(2 * H, H) * 0.3
    drop = ((rng.rand(B, H) > 0.2) * 1.0 if drop_bh
            else np.full((1, 1), 0.8))
    return (_f(g), _f(U), _f(drop), _f(rng.randn(B, H) * 0.3),
            _f(rng.randn(T, B, H)))


def _sp_inputs(seed, act="tanh", drop_bh=True):
    """Sparse: a 128-block recurrent mask at 50% (Kb=2, R=1), its layout,
    gates (T, B, 2H), w3g (Nb, 2bs, R*bs), drop, dhs."""
    mask = hcgs_mask(SP_H, SP_H, [BS], [50], rng=np.random.RandomState(seed))
    layout = tbs.pack_layout(mask, BS)
    rng = np.random.RandomState(seed + 1)
    g = _gates(rng, SP_T, B, SP_H, act)
    w3g = rng.randn(layout.Nb, 2 * BS, layout.R * BS) * 0.3 / np.sqrt(BS)
    drop = ((rng.rand(B, SP_H) > 0.2) * 1.0 if drop_bh
            else np.full((1, 1), 0.8))
    return (mask, layout, _f(g), _f(w3g), _f(drop),
            _f(rng.randn(SP_T, B, SP_H)))


def _atol(qbits, wbf16=False):
    return ATOL_Q if (qbits == 16 or wbf16) else ATOL


def _h_prev(hs):
    hs = _np(hs)
    return np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])


def _assert_rel(got, ref, tol, names):
    for name, a, b in zip(names, got, ref):
        scale = max(float(np.abs(_np(b)).max()), 1e-30)
        np.testing.assert_allclose(_np(a), _np(b), atol=tol * scale,
                                   err_msg=name)


def _set_stash(monkeypatch, stash):
    monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    if stash:
        monkeypatch.setenv("PKC_BWD_STASH_CELLS", "mgru")
    else:
        monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)


# ---------------------------------------------------------------------------
# dense twins vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "stash", "seeded"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_fwd_twin_matches_pallas(jfr, act, qbits, variant):
    import jax.numpy as jnp
    g, U, drop, h0, _ = _inputs(3, act, drop_bh=variant != "seeded")
    seeded, stash = variant == "seeded", variant == "stash"
    fwd = jfr._build_mgru_fwd(T, B, H, act, qbits, True, with_init=seeded,
                              stash=stash)
    j = jnp.asarray
    ref = fwd(j(g), j(U), j(np.broadcast_to(drop, (B, H))),
              *((j(h0),) if seeded else ()))
    got = tfr.fused_mgru_fwd(tt(g), tt(U), tt(drop),
                             tt(h0) if seeded else None, act=act,
                             qbits=qbits, stash=stash)
    got, ref = (got, ref) if stash else ((got,), (ref,))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=_atol(qbits))
    if seeded:   # the streaming entry: (hs, h_T), seeded from h0
        hs, _ = jfr.mgru_scan_fused_stream(j(g), j(U), j(drop), j(h0),
                                           act=act, quant_bits=qbits,
                                           interpret=True)
        ths, thT = tfr.mgru_scan_fused_stream(tt(g), tt(U), tt(drop), tt(h0),
                                              act=act, quant_bits=qbits)
        np.testing.assert_allclose(ths.numpy(), _np(hs), atol=_atol(qbits))
        np.testing.assert_array_equal(thT.numpy(), ths[-1].numpy())


def _residuals(jfr, g, U, drop, act, qbits):
    """The JAX stash forward's acts and h_prev."""
    import jax.numpy as jnp
    hs, acts = jfr._build_mgru_fwd(T, B, H, act, qbits, True, stash=True)(
        jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop))
    return _np(acts), _h_prev(hs)


@pytest.mark.parametrize("act", ["relu", "tanh", "htanh", "linear"])
def test_bwd_stash_twin_matches_pallas(jfr, act):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(5, act)
    acts, h_prev = _residuals(jfr, g, U, drop, act, 0)
    j = jnp.asarray
    ref = jfr._build_mgru_bwd_stash(T, B, H, act, True)(
        j(acts), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_mgru_bwd_stash(tt(acts), tt(U), tt(drop), tt(h_prev),
                                   tt(dhs), act)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bwd_recompute_twin_matches_pallas(jfr, act, qbits):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(7, act)
    _, h_prev = _residuals(jfr, g, U, drop, act, qbits)
    j = jnp.asarray
    ref = jfr._build_mgru_bwd(T, B, H, act, qbits, True)(
        j(g), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_mgru_bwd(tt(g), tt(U), tt(drop), tt(h_prev), tt(dhs),
                             act, qbits)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=_atol(qbits))


def _rebuild_all_steps(g, U, h_prev, qbits):
    """TPU row 26's rebuild as the persistent route runs it, in plain
    PyTorch: every step's forward quantities at once over the M = T*B
    rows, q per step: z = sigmoid(g_z + q(h_prev) @ Uz^T), s = z *
    h_prev, q(s), a_pre = g_h + q(s) @ Uh^T. -> ([a_pre | z] (T, B, 2H),
    s, q(s))."""
    from pytorch_kaldi_cgs_tpu_torch.sparsity.quantize import \
        quantize_input_per_step
    t, b, h = h_prev.shape
    m = t * b

    def q(v):
        return quantize_input_per_step(v, qbits) if qbits > 0 else v
    gm = g.reshape(m, 2 * h)
    z = torch.sigmoid(gm[:, h:] + q(h_prev).reshape(m, h) @ U[h:].T)
    s = (z * h_prev.reshape(m, h)).reshape(t, b, h)
    sq = q(s)
    a_pre = gm[:, :h] + sq.reshape(m, h) @ U[:h].T
    return torch.cat([a_pre, z], 1).reshape(t, b, 2 * h), s, sq


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bwd_rebuild_of_all_steps_matches_pallas(jfr, act, qbits):
    """Row 26's persistent route rebuilds z, s, q(s) and a_pre for all
    steps at once (two products over the unrolled batch) before its
    reverse chain: that decomposition, then the chain over it, against
    ``_build_mgru_bwd`` (per step, in interpret mode) at the recompute
    twin's bars (float32 1e-5, 16 bits 1e-4: the products sum in another
    order, so q(s) may sit a ceil step apart); its s against s = z *
    h_prev of the JAX step's z, and q(s) against the JAX quantizer of
    that s, at the same bars."""
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(7, act)
    _, h_prev = _residuals(jfr, g, U, drop, act, qbits)
    j = jnp.asarray
    ref = jfr._build_mgru_bwd(T, B, H, act, qbits, True)(
        j(g), j(U), j(drop), j(h_prev), j(dhs))
    fw, s, sq = _rebuild_all_steps(tt(g), tt(U), tt(h_prev), qbits)
    actf = tfl.ACTS[act]
    _, _, dot_h, dot_zr = tfr._gru_dense_fns(tt(U))

    def step(k):
        a_pre = fw[k, :, :H]
        return actf(a_pre), fw[k, :, H:], tfl.dact_pre(act, a_pre)
    got = tfr._gru_bwd_loop(step, tt(h_prev), tt(dhs), tt(drop), dot_h,
                            dot_zr, tt(g))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=_atol(qbits))
    jz = 1.0 / (1.0 + np.exp(-(g[..., H:] + np.einsum(
        "tbk,gk->tbg", _np(jfr._q_vmap(j(h_prev), qbits)) if qbits
        else h_prev, U[H:]))))
    js = jz * h_prev
    np.testing.assert_allclose(s.numpy(), js, atol=_atol(qbits))
    jsq = _np(jfr._q_vmap(j(js.astype(np.float32)), qbits)) if qbits else js
    np.testing.assert_allclose(sq.numpy(), jsq, atol=_atol(qbits))


# ---------------------------------------------------------------------------
# sparse twins vs the Pallas kernels
# ---------------------------------------------------------------------------

def _j_sparse(jfr, jbs, mask, name, act, qbits):
    jl = jbs.pack_layout(mask, BS)
    return getattr(jfr, name)(SP_T, B, SP_H, act, qbits, jl.Nb, jl.R, BS,
                              tuple(int(v) for v in jl.col_idx), True)


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_sparse_twins_match_pallas(jfr, jbs, act, qbits, wbf16):
    """The forward's hs, then dg and s of the BPTT twin over the same
    forward's h_prev, against the TPU kernels."""
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _sp_inputs(2, act)
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    j = jnp.asarray
    hs_ref = _j_sparse(jfr, jbs, mask, "_build_mgru_fwd_sparse", act,
                       qbits)(j(g), jw, j(drop))
    hs = tfr.fused_mgru_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act, qbits,
                                   wbf16)
    np.testing.assert_allclose(hs.numpy(), _np(hs_ref),
                               atol=_atol(qbits, wbf16))
    h_prev = _h_prev(hs_ref)
    dg_ref, s_ref = _j_sparse(jfr, jbs, mask, "_build_mgru_bwd_sparse", act,
                              qbits)(j(g), jw, j(drop), j(h_prev), j(dhs))
    dg, s = tfr.fused_mgru_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                      tt(dhs), tl, act, qbits, wbf16)
    for a, b in ((dg, dg_ref), (s, s_ref)):
        np.testing.assert_allclose(a.numpy(), _np(b),
                                   atol=_atol(qbits, wbf16))


def test_wrappers_reject_bad_inputs():
    g, U, drop, h0, dhs = (tt(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="U must be"):
        tfr.fused_mgru_fwd(g, U[:, :-1], drop)
    with pytest.raises(ValueError, match="gates must be"):
        tfr.fused_mgru_fwd(g[..., :-1], U, drop)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_mgru_fwd(g, U, drop, act="sigmoid")
    with pytest.raises(ValueError, match="h0 must be"):
        tfr.fused_mgru_fwd(g, U, drop, h0=h0[:, :-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_mgru_bwd(g, U, drop, dhs, dhs[:-1])
    with pytest.raises(RuntimeError, match="mgru_scan_fused"):
        tfr.fused_mgru_fwd(g.requires_grad_(), U, drop)
    _, tl, sg, w3g, sdrop, sdhs = _sp_inputs(0)
    sg, w3g, sdrop, sdhs = tt(sg), tt(w3g), tt(sdrop), tt(sdhs)
    with pytest.raises(ValueError, match="w3g must be"):
        tfr.fused_mgru_fwd_sparse(sg, w3g[:, :-1], sdrop, tl)
    with pytest.raises(ValueError, match="layout"):
        tfr.fused_mgru_fwd_sparse(sg[..., :-2], w3g, sdrop, tl)
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_mgru_bwd_sparse(sg, w3g, sdrop, sdhs, sdhs[:-1], tl)
    with pytest.raises(RuntimeError, match="mgru_scan_fused_sparse"):
        tfr.fused_mgru_fwd_sparse(sg.requires_grad_(), w3g, sdrop, tl)


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

def _torch_grads(g, U, drop, dhs, qbits, act, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(U).requires_grad_()]
    hs = tfr.mgru_scan_fused(leaves[0], leaves[1], d(drop), act=act,
                             quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("stash,qbits,drop_bh", [
    (True, 0, True), (True, 16, False), (False, 0, False), (False, 16, True)],
    ids=["stash-0-dropBH", "stash-16-drop11", "recompute-0-drop11",
         "recompute-16-dropBH"])
def test_function_grads_match_jax_vjp(jfr, monkeypatch, stash, qbits,
                                      drop_bh):
    """hs, dgates and dU of the Function against jax.vjp of the JAX
    custom VJP, both packages on the same stash/recompute choice (the
    default is recompute in both)."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    _set_stash(monkeypatch, stash)
    assert tfr.bwd_stash_enabled("mgru") == jfl._bwd_stash_enabled("mgru") \
        == stash
    g, U, drop, _, dhs = _inputs(13, "relu", drop_bh)
    j = jnp.asarray
    hs, vjp = jax.vjp(lambda g_, U_: jfr.mgru_scan_fused(
        g_, U_, j(drop), act="relu", quant_bits=qbits, interpret=True),
        j(g), j(U))
    ref = [_np(hs)] + [_np(a) for a in vjp(j(dhs))]
    _assert_rel(_torch_grads(g, U, drop, dhs, qbits, "relu"), ref,
                _atol(qbits), ["hs", "dgates", "dU"])


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_equal_autograd_through_plain_loop(monkeypatch, stash,
                                                          qbits):
    """Independent of JAX: the Function's backward (BPTT twin + the two
    dU products) equals torch.autograd through the plain forward loop
    with its straight-through quantizers."""
    _set_stash(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(17)
    got = _torch_grads(g, U, drop, dhs, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(U).requires_grad_()]
    hs = tfr.fused_mgru_fwd_plain(leaves[0], leaves[1], tt(drop), None,
                                  "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def _sp_torch_grads(g, w3g, drop, dhs, layout, qbits, act="relu",
                    dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(w3g).requires_grad_()]
    hs = tfr.mgru_scan_fused_sparse(leaves[0], leaves[1], layout, d(drop),
                                    act=act, quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("qbits,drop_bh", [(0, False), (16, True)],
                         ids=["0-drop11", "16-dropBH"])
def test_sparse_function_matches_jax_vjp(jbs, jfr, qbits, drop_bh):
    """hs, dgates and dw3g of the sparse Function (dw3g as two
    block-sparse dw products, G=1 over q(s) and G=1 over q(h_prev))
    against jax.vjp of the JAX custom VJP."""
    import jax
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _sp_inputs(13, "relu", drop_bh)
    jl = jbs.pack_layout(mask, BS)
    hs, vjp = jax.vjp(lambda g_, w_: jfr.mgru_scan_fused_sparse(
        g_, w_, jl, jnp.asarray(drop), act="relu", quant_bits=qbits,
        interpret=True), jnp.asarray(g), jnp.asarray(w3g))
    ref = [_np(hs)] + [_np(a) for a in vjp(jnp.asarray(dhs))]
    _assert_rel(_sp_torch_grads(g, w3g, drop, dhs, tl, qbits), ref,
                ATOL_Q if qbits else ATOL, ["hs", "dgates", "dw3g"])


@pytest.mark.parametrize("qbits", [0, 16])
def test_sparse_function_equals_autograd_through_plain_loop(qbits):
    """Independent of JAX: the sparse Function's backward (BPTT twin +
    the dw products) equals torch.autograd through the plain forward
    loop."""
    _, tl, g, w3g, drop, dhs = _sp_inputs(17)
    got = _sp_torch_grads(g, w3g, drop, dhs, tl, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(w3g).requires_grad_()]
    hs = tfr.fused_mgru_fwd_sparse_plain(leaves[0], leaves[1], tt(drop), tl,
                                         "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    _assert_rel(got, ref, ATOL, ["hs", "dgates", "dw3g"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def mgru_opts(cdt="", laynorm=False, act="relu", sparse=False, drop="0.2",
              quant_inp=True, fused=True):
    """2 layers, BN, HCGS on x and h, 8-bit weights, 16-bit input
    quantizers: 2x16 at 8-blocks (the dense fused recurrence), or
    ``sparse`` 2x256 with 128-block recurrent masks at 50,50 (Kb=2, R=1:
    both recurrences on the sparse kernels). ``minimalgru_fused_scan``
    puts the JAX package on its Pallas kernels on the CPU."""
    lay = 256 if sparse else 16
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "mgru",
        "minimalgru_lay": "%d,%d" % (lay, lay),
        "minimalgru_drop": "%s,%s" % (drop, drop),
        "minimalgru_use_batchnorm": "True,True",
        "minimalgru_use_laynorm": "%s,%s" % (laynorm, laynorm),
        "minimalgru_use_laynorm_inp": "False",
        "minimalgru_use_batchnorm_inp": "False",
        "minimalgru_act": "relu,%s" % act, "minimalgru_orthinit": "True",
        "minimalgru_bidir": "False", "minimalgru_hcgs": "True",
        "hcgsx_block": "8,2", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "128,2" if sparse else "8,2",
        "hcgsh_sparse": "50,50" if sparse else "25,62.5",
        "minimalgru_quant": "True", "param_quant": "8",
        "minimalgru_quant_inp": str(quant_inp), "inp_quant": "16",
        "minimalgru_fused_scan": str(fused),
        "minimalgru_block_sparse": "auto", "scan_unroll": "1"}


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
        if isinstance(v, dict) and k.startswith("ln"):
            out["params"][k] = {kk: (vv + rng.randn(*vv.shape) * 0.2)
                                .astype(np.float32) for kk, vv in v.items()}
    return out


def _pair(jm, opts, seed):
    """The JAX minimalGRU with its layouts prepared, its init(seed) with
    BN statistics perturbed, and the port over the same variables."""
    jmod = jm.minimalGRU(opts, F_IN)
    tree = _perturbed(jmod.init(seed), seed + 1)
    jmod.prepare_block_sparse(tree)
    port = minimalGRU(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    assert sorted(port._rec_layouts) == sorted(jmod._rec_layouts)
    assert port._bs_layouts == {}
    return jmod, tree, port


@pytest.fixture
def calls(monkeypatch):
    """Counts the port's calls into the minimalGRU's dense Function, its
    seeded forward and its sparse forward twin."""
    out = {"sparse": 0, "dense": 0, "stream": 0}
    for name, key in (("mgru_scan_fused_sparse", "sparse"),
                      ("mgru_scan_fused", "dense"),
                      ("mgru_scan_fused_stream", "stream")):
        real = getattr(tfr, name)

        def spy(*a, _real=real, _key=key, **k):
            out[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return out


def test_registry_and_init_equal_jax(jm):
    """The configs' name resolves; init(seed) is the JAX package's array
    for array, and the liGRU's (the same gates and names), and the
    variables cross both ways unchanged."""
    from pytorch_kaldi_cgs_tpu_torch.models import liGRU
    for lib in ("pytorch_kaldi_cgs_tpu.models",
                "pytorch_kaldi_cgs_tpu_torch.models"):
        assert get_model_class(lib, "minimalGRU") is minimalGRU
    for opts in (mgru_opts(), mgru_opts(laynorm=True)):
        for seed in (0, 7):
            port = minimalGRU(opts, F_IN, seed=seed, device="cpu")
            jtree = jm.minimalGRU(opts, F_IN).init(seed)
            got = convert.flatten(convert.to_jax_variables(port.variables()))
            want = convert.flatten(jtree)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), err_msg=k)
            back = convert.flatten(convert.to_jax_variables(
                convert.from_jax_variables(jtree)))
            for k in want:
                np.testing.assert_array_equal(np.asarray(back[k]),
                                              np.asarray(want[k]), err_msg=k)
    lg_opts = {k.replace("minimalgru_", "ligru_"): v
               for k, v in mgru_opts().items()}
    lg = convert.flatten(liGRU(lg_opts, F_IN, seed=3,
                               device="cpu").variables())
    mg = convert.flatten(minimalGRU(mgru_opts(), F_IN, seed=3,
                                    device="cpu").variables())
    assert sorted(lg) == sorted(mg)
    for k in lg:
        np.testing.assert_array_equal(lg[k].numpy(), mg[k].numpy(), err_msg=k)


@pytest.mark.parametrize("case", ["f32", "bf16", "sparse_f32",
                                  "sparse_bf16_w3g"])
def test_eval_matches_jax(jm, monkeypatch, calls, case):
    """Both layers on the dense fused (or the sparse) kernels, their
    twins here, against JAX apply on its Pallas kernels. Under bf16
    compute only the x-projections round to bf16 (the recurrence is
    float32 in both packages); ``bf16_w3g``: a 1 MB budget makes the JAX
    size rule read w3g in bf16 at 36 rows, in both packages."""
    sparse = case.startswith("sparse")
    rows = 3
    if case == "sparse_bf16_w3g":
        rows = 36
        monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
        assert tfl.sparse_scan_fits(rows, SP_H, _sp_inputs(0)[1], 2) == "bf16"
    opts = mgru_opts("bf16" if case.endswith("bf16") else "", sparse=sparse)
    jmod, tree, port = _pair(jm, opts, 0)
    assert sorted(port._rec_layouts) == ([0, 1] if sparse else [])
    x = np.random.RandomState(2).randn(5, rows, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = port.eval()(tt(x))
    assert calls == ({"sparse": 2, "dense": 0, "stream": 0} if sparse
                     else {"sparse": 0, "dense": 2, "stream": 0})
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


@pytest.mark.parametrize("opts", [
    mgru_opts(fused=False), mgru_opts(cdt="bf16", act="sigmoid"),
    mgru_opts(laynorm=True, act="tanh")],
    ids=["fused_vs_jax_scan", "sigmoid_act_bf16", "laynorm"])
def test_plain_loop_matches_jax(jm, opts):
    """Layers the fused recurrence does not take (in-scan layer norm,
    another activation) run the plain step loop (under bf16 both
    recurrent dots take bf16-rounded inputs, q(z * h) before Uh, as the
    JAX ``_rmm``). ``fused_vs_jax_scan``: the port's fused float32
    recurrence against the JAX ``lax.scan`` (``minimalgru_fused_scan=
    False``, an option the port does not read)."""
    x = np.random.RandomState(5).randn(6, 2, F_IN).astype(np.float32)
    jmod, tree, port = _pair(jm, opts, 3)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = port.eval()(tt(x))
    atol = 2e-2 if opts["compute_dtype"] else ATOL_Q
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=atol)


@pytest.mark.parametrize("case", ["dense_q16", "sparse_noq"])
def test_train_mode_and_grads_match_jax(jm, calls, case):
    """Train mode (batch statistics, dropout 0): the output, the updated
    BN statistics and the gradient of every parameter (U through the
    kernels' dU, or through the w3g gather; x-weights; BN) against
    jax.grad. T*B = 24 rows. The output is held relative to its scale, as
    the gradients: a 16-bit ceil quantizer's step is 2^-15 of max|v|."""
    import jax
    import jax.numpy as jnp
    sparse = case.startswith("sparse")
    opts = mgru_opts(drop="0.0", sparse=sparse,
                     quant_inp=case.endswith("q16"))
    jmod, tree, port = _pair(jm, opts, 3)
    x = np.random.RandomState(5).randn(6, 4, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(6, 4, port.out_dim).astype(
        np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(tree["params"])
    port.train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    assert calls["sparse" if sparse else "dense"] == 2
    _assert_rel([y.detach()], [y_ref], ATOL_Q, ["y"])
    got = convert.flatten(convert.to_jax_variables(port.variables())["state"])
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(got[k], _np(v), atol=1e-5, err_msg=k)
    ref_g = convert.flatten(jax.device_get(grads))
    got_g = {k: p.grad.numpy() for k, p in port.params.items()}
    assert sorted(ref_g) == sorted(got_g)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got_g[k], _np(v), atol=ATOL_Q * scale,
                                   err_msg=k)


def test_sparse_kernels_where_jax_size_rule_says_no(jm, monkeypatch, calls):
    """With a 1 MB budget the JAX size rule says "" at 48 rows: the JAX
    package runs its float32 lax.scan over the masked U
    (``minimalgru_fused_scan=False`` keeps it off its fused kernels), the
    port stays on the sparse kernels with float32 w3g, and the outputs
    agree."""
    monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
    jmod, tree, port = _pair(jm, mgru_opts(sparse=True, fused=False), 1)
    assert tfl.sparse_scan_fits(48, SP_H, port._rec_layouts[0], 2) == ""
    x = np.random.RandomState(9).randn(3, 48, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    seen = []
    real = tfr.fused_mgru_fwd_sparse

    def spy(*a, **k):
        seen.append(a[-1] if len(a) > 6 else k.get("bf16"))
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_mgru_fwd_sparse", spy)
    with torch.no_grad():
        y = port.eval()(tt(x))
    assert seen == [False, False] and calls["dense"] == 0
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_stream_equals_whole_utterance(jm, calls, sparse):
    """Three chunks with the h carry seeding the dense fused forward (a
    sparse layer drops its layout under a stream, as in the JAX package)
    reproduce the whole-utterance eval output, and match the JAX
    package's stream (without the input quantizers, whose scale is per
    call)."""
    jmod, tree, port = _pair(jm, mgru_opts(quant_inp=False, sparse=sparse),
                             2)
    x = np.random.RandomState(8).randn(10, 3, F_IN).astype(np.float32)
    xt = tt(x)
    with torch.no_grad():
        full = port.eval()(xt)
        carries, got = None, []
        for a, b in ((0, 4), (4, 5), (5, 10)):
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert len(carries) == 2 and carries[0].shape == (3, port.lay[0])
    assert calls == {"sparse": 2 if sparse else 0, "dense": 0 if sparse else 2,
                     "stream": 6}
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)
    jc, jgot = None, []
    for a, b in ((0, 4), (4, 5), (5, 10)):
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL)


# ---------------------------------------------------------------------------
# 3 train steps of the Li-GRU cfg as a minimalGRU against the JAX runner
# ---------------------------------------------------------------------------

LIGRU_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "TIMIT_baselines", "TIMIT_liGRU_fmllr_hcgs.cfg")
N_CD, ST_T, ST_B, SEED, STEPS = 40, 8, 4, 3, 3
#: The CGS-16x paper's HCGS setting
#: (cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:122-125).
HCGS_16X = {"hcgsx_block": "128,8", "hcgsx_sparse": "75,75",
            "hcgsh_block": "128,8", "hcgsh_sparse": "75,75"}


def mgru_section(src):
    """The Li-GRU cfg's [architecture1] as a minimalGRU: arch_class,
    arch_proto and every ligru_* field renamed."""
    sec = {k.replace("ligru_", "minimalgru_"): v for k, v in src.items()}
    sec.update(arch_class="minimalGRU", arch_proto="proto/minimalGRU.proto")
    return sec


def chunk_config(cdt, quant_inp, sparse):
    """The Li-GRU cfg's [architecture1..2] with a minimalGRU, dropout 0,
    narrowed: 2x16 with 8-block HCGS (the dense fused recurrence), or
    ``sparse`` 2x256 with the 16x HCGS fields (the 128-block recurrent
    masks at 75,75 keep one block a row), over an in-memory chunk of
    fMLLR-width features and cd labels."""
    src = configparser.ConfigParser()
    src.read(LIGRU_CFG)
    cc = configparser.ConfigParser()
    cc.read_string("[exp]\nto_do = train\nseed = 0\n\n[batches]\n"
                   "batch_size_train = %d\n\n[data_chunk]\n"
                   "fea = fea_name=fmllr\n\tfea_lst=none\n\tfea_opts=none\n"
                   "\tcw_left=0\n\tcw_right=0\n"
                   "lab = lab_name=lab_cd\n\tlab_folder=none\n"
                   "\tlab_opts=ali-to-pdf\n" % ST_B)
    arch1 = mgru_section(src["architecture1"])
    if sparse:
        arch1.update(HCGS_16X, minimalgru_lay="256,256")
    else:
        arch1.update(minimalgru_lay="16,16", hcgsx_block="8,2",
                     hcgsh_block="8,2")
    arch1.update(minimalgru_drop="0.0,0.0",
                 minimalgru_quant_inp=str(quant_inp),
                 minimalgru_fused_scan="True")
    cc["architecture1"] = arch1
    cc["architecture2"] = dict(src["architecture2"], dnn_lay=str(N_CD))
    for sec in ("architecture1", "architecture2"):
        # eps 1e-6 as tests/test_torch_ligru.py: a gradient that cancels
        # to float32 noise would otherwise step by lr * noise / eps
        cc[sec]["opt_eps"] = "1e-6"
        cc[sec]["compute_dtype"] = cdt
    cc["model"] = {
        "model_proto": "proto/model.proto",
        "model": "out_rnn=compute(RNN_layers,fmllr)\n"
                 "out_cd=compute(MLP_cd,out_rnn)\n"
                 "loss_final=cost_nll(out_cd,lab_cd)\n"
                 "err_final=cost_err(out_cd,lab_cd)"}
    return cc


def _chunks():
    """The same in-memory chunk for both packages."""
    from pytorch_kaldi_cgs_tpu.data import dataset as jdata
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    rng = np.random.RandomState(0)
    x = rng.randn(ST_T, ST_B, 40).astype(np.float32)
    cd = rng.randint(0, N_CD, (ST_T, ST_B))
    data = np.concatenate([np.concatenate([x[:, b], cd[:, b, None]], 1)
                           for b in range(ST_B)]).astype(np.float32)
    ends = np.cumsum([ST_T] * ST_B)
    names = ["u%d" % b for b in range(ST_B)]
    return [mod.ChunkData(
        names, data, ends,
        {"fmllr": mod.FeaStream("fmllr", "none", col_start=0, col_end=40)},
        {"lab_cd": mod.LabStream("lab_cd", "none", col=40)})
        for mod in (jdata, tdata)]


@pytest.mark.parametrize("case", ["dense-f32-recompute-q16",
                                  "dense-bf16-stash-noq",
                                  "sparse-f32-recompute-noq"])
def test_train_steps_match_jax(jm, monkeypatch, calls, case):
    """3 steps of the cfg's minimalGRU (on its dense fused kernels, or
    both recurrences on the sparse ones) against the JAX runner on its
    Pallas kernels. Without the 16-bit input quantizers every parameter
    and BN statistic is within 1e-4 of the JAX runner's after each step
    (RMSprop's first step moves each by about lr / sqrt(1 - alpha) =
    7e-3, so a wrong or missing gradient shows) and the per-step loss and
    err within 1e-5 (relative). As the cfg ships it (relu behind the
    16-bit ceil quantizers) a one-ulp difference can move a quantized
    value a whole step, which RMSprop can turn into a whole step of a
    parameter whose gradient is near 0, as for the Li-GRU
    (tests/test_torch_ligru_sparse.py): the first step's loss is held to
    1e-5, the next two to 1e-3."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    kind, cdt, bwd, quant = case.split("-")
    _set_stash(monkeypatch, bwd == "stash")
    sparse = kind == "sparse"
    cc = chunk_config("" if cdt == "f32" else cdt, quant == "q16", sparse)
    jchunk, pchunk = _chunks()
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    for arch in jg.net_order:
        jg.nets[arch].prepare_block_sparse(jv[arch])
    want = [0, 1] if sparse else []
    assert sorted(jg.nets["RNN_layers"]._rec_layouts) == want
    jr = JC.ChunkRunner(jg, cc)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    net = tg.nets["RNN_layers"]
    assert type(net) is minimalGRU and sorted(net._rec_layouts) == want
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, ST_B, True, np.random.RandomState(SEED), bucket=ST_T))
    jres, tres = [], []
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
        if quant == "noq":
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
    assert calls["sparse" if sparse else "dense"] == 2 * STEPS
    later = 1e-5 if quant == "noq" else 1e-3
    np.testing.assert_allclose(tres[:1], jres[:1], rtol=1e-5)
    np.testing.assert_allclose(tres[1:], jres[1:], rtol=later)
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
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_cuda_dense_kernels_match_plain_twins(cuda_device, act, qbits):
    """The forward (plain, stash, seeded; the route's launches each) and
    both BPTT kernels (the stash one 2T launches, the recompute one its
    persistent route's, mgru_bwd_launches) against their twins on the
    card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, dhs = (tt(a).to(cuda_device) for a in _inputs(19, act))
    with torch.no_grad():
        before = tfr.fused_mgru_fwd.launches
        hs, acts = tfr.fused_mgru_fwd(g, U, drop, act=act, qbits=qbits,
                                      stash=True)
        hs1 = tfr.fused_mgru_fwd(g, U, drop, act=act, qbits=qbits)
        hs_s = tfr.fused_mgru_fwd(g, U, drop, h0, act=act, qbits=qbits)
        route = tfr.gru_fwd_route(B, H, 2, cuda_device)[0]
        assert tfr.fused_mgru_fwd.launches == before + sum(
            tfr.gru_fwd_launches(route, T, seeded, qbits)
            for seeded in (False, False, True))
        ref, ref_a = tfr.fused_mgru_fwd_plain(g, U, drop, None, act, qbits,
                                              True)
        ref_s = tfr.fused_mgru_fwd_plain(g, U, drop, h0, act, qbits)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = (tfr.fused_mgru_bwd_stash.launches,
                  tfr.fused_mgru_bwd.launches)
        dg_s = tfr.fused_mgru_bwd_stash(acts, U, drop, h_prev, dhs, act)
        dg_r = tfr.fused_mgru_bwd(g, U, drop, h_prev, dhs, act, qbits)
        route = tfr.mgru_bwd_route(B, H, cuda_device)[0]
        assert route == "persist"
        assert (tfr.fused_mgru_bwd_stash.launches,
                tfr.fused_mgru_bwd.launches) == (
                    before[0] + 2 * T,
                    before[1] + tfr.mgru_bwd_launches(route, T, qbits))
        ref_ds = tfr.fused_mgru_bwd_stash_plain(acts, U, drop, h_prev, dhs,
                                                act)
        ref_dr = tfr.fused_mgru_bwd_plain(g, U, drop, h_prev, dhs, act,
                                          qbits)
    torch.cuda.synchronize()
    _assert_rel([x.cpu() for x in (hs, hs1, acts, hs_s, dg_s, dg_r)],
                [x.cpu() for x in (ref, ref, ref_a, ref_s, ref_ds, ref_dr)],
                _atol(qbits), ["hs", "hs_nostash", "acts", "hs_seeded",
                               "dg_stash", "dg_recompute"])


@pytest.mark.cuda
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_cuda_sparse_kernels_match_plain_twins(cuda_device, act, qbits,
                                               wbf16):
    """The sparse forward and BPTT against their twins on the card: hs, dg
    and s; each call's launches those of the route its wrapper picks
    (gru_fwd_sparse_launches, mgru_bwd_sparse_launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, g, w3g, drop, dhs = _sp_inputs(19, act)
    g, w3g, drop, dhs = (tt(a).to(cuda_device) for a in (g, w3g, drop, dhs))
    f_route = tfr.gru_fwd_sparse_route(B, tl, wbf16, cuda_device, 2)[0]
    b_route = tfr.mgru_bwd_sparse_route(B, tl, wbf16, cuda_device)[0]
    with torch.no_grad():
        before = (tfr.fused_mgru_fwd_sparse.launches,
                  tfr.fused_mgru_bwd_sparse.launches)
        hs = tfr.fused_mgru_fwd_sparse(g, w3g, drop, tl, act, qbits, wbf16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dg, s = tfr.fused_mgru_bwd_sparse(g, w3g, drop, h_prev, dhs, tl, act,
                                          qbits, wbf16)
        assert (tfr.fused_mgru_fwd_sparse.launches,
                tfr.fused_mgru_bwd_sparse.launches) == (
                    before[0] + tfr.gru_fwd_sparse_launches(f_route, SP_T),
                    before[1] + tfr.mgru_bwd_sparse_launches(b_route, SP_T,
                                                             qbits))
        ref = tfr.fused_mgru_fwd_sparse_plain(g, w3g, drop, tl, act, qbits,
                                              wbf16)
        ref_dg, ref_s = tfr.fused_mgru_bwd_sparse_plain(
            g, w3g, drop, h_prev, dhs, tl, act, qbits, wbf16)
    torch.cuda.synchronize()
    tol = 2e-2 if wbf16 else _atol(qbits)
    _assert_rel([x.cpu() for x in (hs, dg, s)],
                [x.cpu() for x in (ref, ref_dg, ref_s)], tol,
                ["hs", "dg", "s"])


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_functions_match_cpu(cuda_device, monkeypatch, stash):
    """Both autograd Functions on the card (kernels; dw3g on the dw
    kernel) against the same calls on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _set_stash(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(23, "relu")
    _assert_rel(_torch_grads(g, U, drop, dhs, 16, "relu", dev=cuda_device),
                _torch_grads(g, U, drop, dhs, 16, "relu"), ATOL_Q,
                ["hs", "dgates", "dU"])
    _, tl, g, w3g, drop, dhs = _sp_inputs(23, "relu")
    _assert_rel(_sp_torch_grads(g, w3g, drop, dhs, tl, 16, dev=cuda_device),
                _sp_torch_grads(g, w3g, drop, dhs, tl, 16), ATOL_Q,
                ["hs", "dgates", "dw3g"])


def _bwd_args(t, b, h, seed, act, dev):
    """The recompute BPTT's operands at (t, b, h) on ``dev`` (_inputs'
    draws: relu's candidate inputs kept off its kink), the carries from
    the forward on the card."""
    rng = np.random.RandomState(seed)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    g, U = d(_gates(rng, t, b, h, act)), d(rng.randn(2 * h, h) * 0.3)
    drop, dhs = d(rng.rand(b, h) > 0.2), d(rng.randn(t, b, h))
    with torch.no_grad():
        hs = tfr.fused_mgru_fwd(g, U, drop, act=act)
    return g, U, drop, torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), dhs


def _step_route(g, U, drop, h_prev, dhs, act, qbits):
    return tfr._gru_bwd_step(tfr.fused_mgru_bwd, "fused_mgru_bwd", 2, g, U,
                             drop, h_prev, dhs, act, qbits, False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.MGRU_BWD_SHAPES)
def test_cuda_bwd_persist_every_block_shape(cuda_device, shape):
    """Row 26's persistent route (the rebuild's GEMMs and one cooperative
    chain) forced to each instantiated block shape at a ragged width
    (H=37: the last unit group masked, rows padded to 40 floats) and
    batch (8 bi + 3 rows), relu and tanh, qbits 0 and 16: its launches
    (mgru_bwd_launches), two calls bit for bit, and within 1e-5 of the
    step route's and the twin's scale without the quantizers, 1e-4 with
    them (the bars of the twin's checks: the rebuild gives the step
    route's bits, but the chain's dots sum in another order, its warps
    splitting the contraction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    t, b, h = 9, 8 * bi + 3, 37
    plan = tfr.mgru_bwd_plan(b, h, shape)
    for act in ("relu", "tanh"):
        args = _bwd_args(t, b, h, 91 + bi + un, act, cuda_device)
        for qbits in (0, 16):
            with torch.no_grad():
                before = tfr.fused_mgru_bwd.launches
                dg = tfr._mgru_bwd_persist(plan, *args, act, qbits)
                assert tfr.fused_mgru_bwd.launches == before + \
                    tfr.mgru_bwd_launches("persist", t, qbits)
                again = tfr._mgru_bwd_persist(plan, *args, act, qbits)
                step = _step_route(*args, act, qbits)
                ref = tfr.fused_mgru_bwd_plain(*args, act, qbits)
            torch.cuda.synchronize()
            assert torch.equal(dg, again)
            _assert_rel([dg.cpu(), dg.cpu()], [step.cpu(), ref.cpu()],
                        _atol(qbits), ["vs step (%s, q%d)" % (act, qbits),
                                       "vs twin (%s, q%d)" % (act, qbits)])


@pytest.mark.cuda
def test_cuda_bwd_routes(cuda_device):
    """The wrapper on the route its plan names: persistent at 4 rows of 18
    (7 launches with the quantizer), the step route at 48 rows of 1024
    (192 blocks of 16 x 16, one an SM: 2T + 2), each against the twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for (t, b, h), route in (((T, B, H), "persist"), ((4, 48, 1024), "step")):
        args = _bwd_args(t, b, h, 97, "tanh", cuda_device)
        assert tfr.mgru_bwd_route(b, h, cuda_device)[0] == route
        with torch.no_grad():
            before = tfr.fused_mgru_bwd.launches
            dg = tfr.fused_mgru_bwd(*args, "tanh", 16)
            assert tfr.fused_mgru_bwd.launches == before + \
                tfr.mgru_bwd_launches(route, t, 16)
            ref = tfr.fused_mgru_bwd_plain(*args, "tanh", 16)
        torch.cuda.synchronize()
        _assert_rel([dg.cpu()], [ref.cpu()], ATOL_Q, [route])


def _cgs_layout(seed, h=1024):
    """The CGS-16x minimalGRU's recurrent layout at width h: HCGS 128,8 at
    75,75 (Kb=8, R=2 at 1024)."""
    mask = hcgs_mask(h, h, [128, 8], [75, 75],
                     rng=np.random.RandomState(seed))
    return tbs.pack_layout(mask, 128)


def _sp_case(t, b, layout, seed, act, dev):
    """Sparse operands over ``layout`` at (t, b) on ``dev``: gates, w3g,
    drop (b, H), dhs; relu's candidate inputs kept off its kink."""
    h, bs = layout.N, layout.bs
    rng = np.random.RandomState(seed)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    g = d(_gates(rng, t, b, h, act))
    w3g = d(rng.randn(layout.Nb, 2 * bs, layout.R * bs) * 0.3
            / np.sqrt(layout.R * bs))
    return g, w3g, d((rng.rand(b, h) > 0.2) * 1.0), d(rng.randn(t, b, h))


def _fwd_step(g, w3g, drop, layout, act, qbits, wbf16):
    return tfr._gru_fwd_sparse_step(tfr.fused_mgru_fwd_sparse, g, w3g, drop,
                                    layout, act, qbits, wbf16)


def _bwd_step(*args):
    return tfr._gru_bwd_sparse_step(tfr.fused_mgru_bwd_sparse, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.GRU_FWD_SPARSE_SHAPES)
def test_cuda_sparse_fwd_persist_every_block_shape(cuda_device, shape):
    """Row 34's persistent route forced to each instantiated block shape at
    H=256 (Kb=2, R=1) and a ragged batch (8 bi + 3 rows), relu and tanh,
    qbits 0 and 16, w3g f32 and bf16: one launch, the step route's bits
    (its dots sum in row_dots' order), and the twin's bars."""
    bi, un = shape
    b = 8 * bi + 3
    _, tl, *_ = _sp_inputs(31)
    plan = tfr.gru_fwd_sparse_plan(b, tl, shape, G=2)
    for act in ("relu", "tanh"):
        g, w3g, drop, _ = _sp_case(SP_T, b, tl, 40 + bi + un, act,
                                   cuda_device)
        for qbits in (0, 16):
            for wbf16 in (False, True):
                with torch.no_grad():
                    before = tfr.fused_mgru_fwd_sparse.launches
                    hs = tfr._gru_fwd_sparse_persist(plan, g, w3g, drop, tl,
                                                     act, qbits, wbf16)
                    assert tfr.fused_mgru_fwd_sparse.launches == before + 1
                    step = _fwd_step(g, w3g, drop, tl, act, qbits, wbf16)
                    ref = tfr.fused_mgru_fwd_sparse_plain(g, w3g, drop, tl,
                                                          act, qbits, wbf16)
                torch.cuda.synchronize()
                case = (shape, act, qbits, wbf16)
                assert torch.equal(hs, step), case
                _assert_rel([hs.cpu()], [ref.cpu()],
                            2e-2 if wbf16 else _atol(qbits), [str(case)])


@pytest.mark.cuda
def test_cuda_sparse_fwd_routes(cuda_device):
    """The wrapper on the route its plan names: "persist" at the CGS-16x
    minimalGRU's 8 rows of 1024 (one launch, the forced step route's bits
    with and without the quantizer), "step" at 256 rows (1,024 blocks of
    16 x 16: 2T launches), each against the twin."""
    lay = _cgs_layout(421)
    for (t, b), route in (((12, 8), "persist"), ((3, 256), "step")):
        assert tfr.gru_fwd_sparse_route(b, lay, False, cuda_device,
                                        2)[0] == route
        g, w3g, drop, _ = _sp_case(t, b, lay, 44, "relu", cuda_device)
        for qbits in (0, 16):
            with torch.no_grad():
                before = tfr.fused_mgru_fwd_sparse.launches
                hs = tfr.fused_mgru_fwd_sparse(g, w3g, drop, lay, "relu",
                                               qbits)
                assert tfr.fused_mgru_fwd_sparse.launches == before + \
                    tfr.gru_fwd_sparse_launches(route, t)
                step = _fwd_step(g, w3g, drop, lay, "relu", qbits, False)
                ref = tfr.fused_mgru_fwd_sparse_plain(g, w3g, drop, lay,
                                                      "relu", qbits)
            torch.cuda.synchronize()
            assert torch.equal(hs, step), (route, qbits)
            _assert_rel([hs.cpu()], [ref.cpu()], _atol(qbits), [route])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.GRU_BWD_SPARSE_SHAPES)
def test_cuda_sparse_bwd_persist_every_block_shape(cuda_device, shape):
    """Row 35's persistent route (the step kernels' rebuild, then one
    cooperative chain) forced to each instantiated block shape at H=256
    and a ragged batch, relu and tanh, qbits 0 and 16: its launches, two
    calls bit for bit, s bit for bit the step route's (the same rebuild:
    the forward's sums), dg within the twin's bars of the step route's
    and the twin's (its dots sum in another order)."""
    bi, un = shape
    b = 8 * bi + 3
    _, tl, *_ = _sp_inputs(33)
    plan = tfr.mgru_bwd_sparse_plan(b, tl.N, tl.bs, tl.C, shape)
    for act in ("relu", "tanh"):
        g, w3g, drop, dhs = _sp_case(SP_T, b, tl, 50 + bi + un, act,
                                     cuda_device)
        with torch.no_grad():
            hs = tfr.fused_mgru_fwd_sparse(g, w3g, drop, tl, act)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        for qbits in (0, 16):
            args = (g, w3g, drop, h_prev, dhs, tl, act, qbits, False)
            with torch.no_grad():
                before = tfr.fused_mgru_bwd_sparse.launches
                dg, s = tfr._mgru_bwd_sparse_persist(plan, *args)
                assert tfr.fused_mgru_bwd_sparse.launches == before + \
                    tfr.mgru_bwd_sparse_launches("persist", SP_T, qbits)
                again = tfr._mgru_bwd_sparse_persist(plan, *args)
                dg_st, s_st = _bwd_step(*args)
                ref, ref_s = tfr.fused_mgru_bwd_sparse_plain(*args)
            torch.cuda.synchronize()
            case = "%s, %s, q%d" % (shape, act, qbits)
            assert torch.equal(dg, again[0]) and torch.equal(s, s_st), case
            _assert_rel([dg.cpu(), dg.cpu(), s.cpu()],
                        [dg_st.cpu(), ref.cpu(), ref_s.cpu()], _atol(qbits),
                        ["vs step " + case, "vs twin " + case, "s " + case])


@pytest.mark.cuda
def test_cuda_sparse_bwd_routes(cuda_device):
    """The BPTT on the route its plan names: "persist" at the CGS-16x
    minimalGRU's 8 rows of 1024 (4 launches with the quantizer), "step"
    at 256 rows (2T + 2), each against the twin, w3g f32 and bf16."""
    lay = _cgs_layout(421)
    for (t, b), route in (((12, 8), "persist"), ((3, 256), "step")):
        g, w3g, drop, dhs = _sp_case(t, b, lay, 46, "relu", cuda_device)
        with torch.no_grad():
            hs = tfr.fused_mgru_fwd_sparse(g, w3g, drop, lay, "relu", 16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        for wbf16 in (False, True):
            assert tfr.mgru_bwd_sparse_route(b, lay, wbf16,
                                             cuda_device)[0] == route
            args = (g, w3g, drop, h_prev, dhs, lay, "relu", 16, wbf16)
            with torch.no_grad():
                before = tfr.fused_mgru_bwd_sparse.launches
                dg, s = tfr.fused_mgru_bwd_sparse(*args)
                assert tfr.fused_mgru_bwd_sparse.launches == before + \
                    tfr.mgru_bwd_sparse_launches(route, t, 16)
                ref, ref_s = tfr.fused_mgru_bwd_sparse_plain(*args)
            torch.cuda.synchronize()
            _assert_rel([dg.cpu(), s.cpu()], [ref.cpu(), ref_s.cpu()],
                        2e-2 if wbf16 else ATOL_Q,
                        ["dg " + route, "s " + route])
