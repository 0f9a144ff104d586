"""The port's block-sparse RNN (pytorch_kaldi_cgs_tpu_torch: the sparse
RNN of ops/fused_rnn.py, models/recurrent.py RNN on a sparse layout)
against the JAX package on the same numpy inputs, the Pallas kernels run
in interpret mode.

- The two kernels' twins against ``_build_rnn_fwd_sparse`` and
  ``_build_rnn_bwd_sparse`` at H=256, bs=128 (Kb=2, R=1), relu and tanh,
  qbits 0 and 16, w3g in f32 and bf16.
- ``rnn_scan_fused_sparse`` (the autograd Function: dw3g on the
  block-sparse dw kernel's twin, G=1) against ``jax.vjp`` of the JAX
  ``rnn_scan_fused_sparse``, and against autograd through the plain
  loop; the size rule that picks the w3g dtype is the JAX package's.
- A narrow 2x256 RNN (the TIMIT RNN cfg's relu, BN and dropout, the
  CGS-16x cfg's 8-bit weights and 16-bit input quantizers) with
  128-block recurrent masks at 50,50 (both recurrences sparse) against
  JAX ``apply`` with ``rnn_fused_scan=True`` (its sparse kernels on the
  CPU): ``init(seed)``, eval (f32, bf16 compute, bf16 w3g), train mode
  with gradients against ``jax.grad``; a stream drops the layout and
  runs the dense seeded forward over the masked U, as the JAX package
  does. (Where the JAX size rule says "", the port stays on the sparse
  kernels: tests/test_torch_rnn.py.)
- 3 ``ChunkRunner.train_step``s of a narrow two-layer sparse RNN chunk
  (the TIMIT RNN cfg with the CGS-16x HCGS and quantizer fields, the
  16-bit input quantizers off, narrowed) against the JAX runner.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's); with
the 16-bit quantizer or bf16 w3g 1e-4 (a one-ulp difference at a ceil
step becomes one step, max|h|/2^15, which the next steps carry on; both
packages round the same operands to bf16 and sum in float32); with both
1e-3 (ATOL_QBF16: such a step can also cross a bf16 rounding step); the
model's outputs 1e-4 (BN over the rows; in train mode of the output's
scale, relu's h reaching ~2), gradients 1e-4 of each one's scale. T*B
is a multiple of 8 wherever dw3g is compared: the JAX package's
``sparse_dU`` drops the rows past one. The JAX model runs under
``jax.jit``: one XLA compile instead of one per operation.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_rnn_sparse.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5; the 16-bit quantizer 1e-4; bf16 w3g 2e-2).
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import RNN
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

T, B, H, BS = 12, 4, 256, 128     # Kb=2, R=1; T*B = 48
F_IN = 12
ATOL = 1e-5
ATOL_Q = 1e-4           # a 16-bit quantizer; bf16 w3g; the model
# w3g in bf16 behind the 16-bit quantizer: a one-ulp difference between
# the packages (XLA's tanh against torch's at the first step) can move a
# quantized input across a ceil step and then across a bf16 rounding
# boundary, one bf16 step (2^-8 of |q(h)| <= 1) times |w| <= 0.11 of the
# inputs below: 4.4e-4 a step for each such input (3.2e-4 seen at tanh)
ATOL_QBF16 = 1e-3
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


def _inputs(seed, act="relu", drop_bh=True):
    """A 128-block recurrent mask at 50% (Kb=2, R=1), its layout, gates
    (T, B, H), w3g (Nb, bs, R*bs), drop, upstream dhs. For relu the gate
    inputs sit at +-(2 + |N(0, 0.5)|), away from 0 by more than the
    recurrent term, so relu' cannot flip between the two packages'
    sums."""
    mask = hcgs_mask(H, H, [BS], [50], rng=np.random.RandomState(seed))
    layout = tbs.pack_layout(mask, BS)
    rng = np.random.RandomState(seed + 1)
    g = rng.randn(T, B, H) * 0.5
    if act == "relu":
        sign = np.where(rng.rand(1, B, H) > 0.5, 1.0, -1.0)
        g = sign * (2.0 + np.abs(g))
    w3g = rng.randn(layout.Nb, BS, layout.R * BS) * 0.3 / np.sqrt(BS)
    drop = ((rng.rand(B, H) > 0.2) * 1.0 if drop_bh
            else np.full((1, 1), 0.8))
    dhs = rng.randn(T, B, H)
    return (mask, layout) + tuple(_np(a) for a in (g, w3g, drop, dhs))


def _j_kernel(jfr, jbs, mask, name, act, qbits):
    """The JAX kernel ``name`` at this file's shape (interpret mode);
    its builder caches it, so the tests share one mask (seed 2) and
    build each kernel once."""
    jl = jbs.pack_layout(mask, BS)
    return getattr(jfr, name)(T, B, H, act, qbits, jl.Nb, jl.R, BS,
                              tuple(int(v) for v in jl.col_idx), True)


def _atol(qbits, wbf16):
    if qbits == 16 and wbf16:
        return ATOL_QBF16
    return ATOL_Q if (qbits == 16 or wbf16) else ATOL


def _assert_rel(got, ref, tol, names):
    for name, a, b in zip(names, got, ref):
        scale = max(float(np.abs(_np(b)).max()), 1e-30)
        np.testing.assert_allclose(_np(a), _np(b), atol=tol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# twins vs the Pallas kernels
# ---------------------------------------------------------------------------

def _j_fwd(jfr, jbs, mask, g, w3g, drop, act, qbits, wbf16):
    """The JAX forward kernel's hs, and w3g as it reads it."""
    import jax.numpy as jnp
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    fwd = _j_kernel(jfr, jbs, mask, "_build_rnn_fwd_sparse", act, qbits)
    return _np(fwd(jnp.asarray(g), jw, jnp.asarray(drop))), jw


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_fwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    mask, tl, g, w3g, drop, _ = _inputs(2, act)
    ref, _ = _j_fwd(jfr, jbs, mask, g, w3g, drop, act, qbits, wbf16)
    got = tfr.fused_rnn_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act, qbits,
                                   wbf16)
    np.testing.assert_allclose(got.numpy(), ref, atol=_atol(qbits, wbf16))


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    """dg of the BPTT twin against the TPU kernel, both over the same
    forward's h_prev."""
    import jax.numpy as jnp
    j = jnp.asarray
    mask, tl, g, w3g, drop, dhs = _inputs(2, act)
    hs, jw = _j_fwd(jfr, jbs, mask, g, w3g, drop, act, qbits, wbf16)
    h_prev = np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])
    ref = _j_kernel(jfr, jbs, mask, "_build_rnn_bwd_sparse", act, qbits)(
        j(g), jw, j(drop), j(h_prev), j(dhs))
    got = tfr.fused_rnn_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                   tt(dhs), tl, act, qbits, wbf16)
    np.testing.assert_allclose(got.numpy(), _np(ref),
                               atol=_atol(qbits, wbf16))


def test_relu_derivative_at_zero_is_zero():
    """act' comes from the pre-activation, relu'(0) = 0, as JAX
    ``_dact_from_pre``: a step whose pre-activation is exactly 0 passes
    no gradient."""
    _, tl, g, w3g, drop, dhs = _inputs(3)
    g[0] = 0.0                              # h_prev = 0 at t = 0: a_pre = 0
    h_prev = np.zeros_like(g)
    dg = tfr.fused_rnn_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                  tt(dhs), tl, "relu")
    assert float(dg[0].abs().max()) == 0.0
    assert float(dg[1:].abs().max()) > 0.0


def test_wrappers_reject_bad_inputs():
    _, tl, g, w3g, drop, dhs = _inputs(0)
    g, w3g, drop, dhs = tt(g), tt(w3g), tt(drop), tt(dhs)
    with pytest.raises(ValueError, match="w3g must be"):
        tfr.fused_rnn_fwd_sparse(g, w3g[:, :-1], drop, tl)
    with pytest.raises(ValueError, match="layout"):
        tfr.fused_rnn_fwd_sparse(g[..., :-2], w3g, drop, tl)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_rnn_fwd_sparse(g, w3g, drop, tl, act="sigmoid")
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_rnn_bwd_sparse(g, w3g, drop, dhs, dhs[:-1], tl)
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_rnn_fwd_sparse(g.requires_grad_(), w3g, drop, tl)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _torch_grads(g, w3g, drop, dhs, layout, qbits, act="relu", dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(w3g).requires_grad_()]
    hs = tfr.rnn_scan_fused_sparse(leaves[0], leaves[1], layout, d(drop),
                                   act=act, quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("qbits,drop_bh", [(0, True), (16, False)],
                         ids=["0-dropBH", "16-drop11"])
def test_function_matches_jax_vjp(jbs, jfr, qbits, drop_bh):
    """hs, dgates and dw3g of the Function (dU as one block-sparse dw
    product over q(h_prev) at G=1) against jax.vjp of the JAX custom
    VJP, with a (B, H) mask and the eval scalar (each case builds its
    JAX kernels anew, so the two masks ride on the two qbits)."""
    import jax
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _inputs(2, drop_bh=drop_bh)
    jl = jbs.pack_layout(mask, BS)
    hs, vjp = jax.vjp(lambda g_, w_: jfr.rnn_scan_fused_sparse(
        g_, w_, jl, jnp.asarray(drop), act="relu", quant_bits=qbits,
        interpret=True), jnp.asarray(g), jnp.asarray(w3g))
    ref = [_np(hs)] + [_np(a) for a in vjp(jnp.asarray(dhs))]
    _assert_rel(_torch_grads(g, w3g, drop, dhs, tl, qbits), ref,
                ATOL_Q if qbits else ATOL, ["hs", "dgates", "dw3g"])


@pytest.mark.parametrize("qbits", [0, 16])
def test_function_equals_autograd_through_plain_loop(qbits):
    """Independent of JAX: the Function's backward (BPTT twin + the dw
    product) equals torch.autograd through the plain forward loop with
    its straight-through quantizer."""
    _, tl, g, w3g, drop, dhs = _inputs(17, "tanh")
    got = _torch_grads(g, w3g, drop, dhs, tl, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(w3g).requires_grad_()]
    hs = tfr.fused_rnn_fwd_sparse_plain(leaves[0], leaves[1], tt(drop), tl,
                                        "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    _assert_rel(got, ref, ATOL, ["hs", "dgates", "dw3g"])


def test_scan_fits_rule_is_the_jax_rule(monkeypatch):
    """The size rule that picks f32 or bf16 w3g at the RNN's G=1 is the
    JAX package's: at the CGS-16x layout (Kb=8, R=2) "f32" up to 162
    rows, "bf16" from 163 to 168, "" from 169."""
    jfl = pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_lstm")
    mask = hcgs_mask(1024, 1024, [128, 8], [75, 75],
                     rng=np.random.RandomState(0))
    layout = tbs.pack_layout(mask, 128)
    assert (layout.Kb, layout.R) == (8, 2)
    rows = (8, 16, 160, 162, 163, 168, 169, 200)
    for mb in (None, "4", "1"):
        if mb is None:
            monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
        else:
            monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", mb)
        for b in rows:
            assert tfl.sparse_scan_fits(b, 1024, layout, 1) == \
                jfl.sparse_scan_fits_vmem(b, 1024, layout, 1)
    monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    assert [tfl.sparse_scan_fits(b, 1024, layout, 1) for b in rows] == \
        ["f32"] * 4 + ["bf16"] * 2 + [""] * 2


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

TIMIT_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "TIMIT_baselines", "TIMIT_RNN_fmllr.cfg")
#: The CGS-16x cfg's quantizer fields
#: (cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:126-129).
QUANT = {"rnn_quant": "True", "param_quant": "8", "inp_quant": "16"}


def rnn_opts(cdt="", act="relu", drop="0.2", quant_inp=True):
    """The TIMIT RNN cfg's section narrowed to 2x256 (relu, BN on the
    projection) with the CGS-16x quantizer fields, HCGS 8,2 at 25,62.5
    on x (dense-masked) and 128,2 at 50,50 on h (Kb=2, R=1: both
    recurrences sparse); ``rnn_fused_scan`` puts the JAX package on its
    sparse kernels on the CPU."""
    src = configparser.ConfigParser()
    src.read(TIMIT_CFG)
    opts = dict(src["architecture1"], **QUANT)
    opts.update({
        "compute_dtype": cdt, "to_do": "forward", "rnn_lay": "256,256",
        "rnn_drop": "%s,%s" % (drop, drop), "rnn_act": "relu,%s" % act,
        "rnn_use_batchnorm": "True,True", "rnn_use_laynorm": "False,False",
        "rnn_hcgs": "True", "hcgsx_block": "8,2", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "128,2", "hcgsh_sparse": "50,50",
        "rnn_quant_inp": str(quant_inp), "rnn_fused_scan": "True",
        "scan_unroll": "1"})
    return opts


def _perturbed(tree, seed):
    """Non-trivial BN statistics."""
    rng = np.random.RandomState(seed)
    out = {"params": dict(tree["params"]), "state": dict(tree["state"]),
           "masks": tree["masks"]}
    for k, v in tree["state"].items():
        n = v["mean"].shape
        out["state"][k] = {
            "mean": (rng.randn(*n) * 0.3).astype(np.float32),
            "var": (rng.rand(*n) + 0.5).astype(np.float32)}
    return out


def _pair(jm, opts, seed):
    """The JAX RNN with its layouts prepared, its init(seed) with BN
    statistics perturbed, and the port over the same variables."""
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(seed), seed + 1)
    jmod.prepare_block_sparse(tree)
    port = RNN(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    assert sorted(port._rec_layouts) == [0, 1] == sorted(jmod._rec_layouts)
    assert port._bs_layouts == {}
    return jmod, tree, port


@pytest.fixture
def calls(monkeypatch):
    """Counts the port's calls into the sparse RNN twin and the dense
    RNN's (whole utterance, stream)."""
    seen = {"sparse": 0, "dense": 0, "stream": 0}
    for name, key in (("fused_rnn_fwd_sparse_plain", "sparse"),
                      ("rnn_scan_fused", "dense"),
                      ("rnn_scan_fused_stream", "stream")):
        real = getattr(tfr, name)

        def spy(*a, _real=real, _key=key, **k):
            seen[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return seen


def test_init_equals_jax_init(jm):
    """init(seed) gives the JAX package's arrays, HCGS masks included,
    and they cross both ways through ``convert`` unchanged; both packages
    derive the same recurrent layouts from them."""
    opts = rnn_opts()
    for seed in (0, 5):
        port = RNN(opts, F_IN, seed=seed, device="cpu")
        jmod = jm.RNN(opts, F_IN)
        jtree = jmod.init(seed)
        got = convert.flatten(convert.to_jax_variables(port.variables()))
        ref = convert.flatten(jtree)
        back = convert.flatten(convert.to_jax_variables(
            convert.from_jax_variables(jtree)))
        assert sorted(got) == sorted(ref) == sorted(back)
        for k in ref:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), k)
            np.testing.assert_array_equal(back[k], np.asarray(ref[k]), k)
        jmod.prepare_block_sparse(jtree)
        for i, jl in jmod._rec_layouts.items():
            tl = port._rec_layouts[i]
            assert (tl.Kb, tl.R) == (jl.Kb, jl.R) == (2, 1)
            np.testing.assert_array_equal(tl.col_idx, np.asarray(jl.col_idx))


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16_w3g"])
def test_eval_matches_jax_sparse(jm, monkeypatch, calls, case):
    """Both layers on the sparse kernels (their twins here), against JAX
    apply on its sparse Pallas kernels. Under bf16 compute only the
    x-projections round to bf16 (the recurrence is float32 in both
    packages); ``bf16_w3g``: a 1 MB budget makes the JAX size rule read
    w3g in bf16 at 42 rows, in both packages (without the 16-bit input
    quantizers, whose ceil steps a one-ulp difference can move across a
    bf16 rounding step: that bar is the twins' ATOL_QBF16)."""
    rows = B
    if case == "bf16_w3g":
        rows = 42
        monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
        assert tfl.sparse_scan_fits(rows, H, _inputs(0)[1], 1) == "bf16"
    opts = rnn_opts("bf16" if case == "bf16" else "",
                    quant_inp=case != "bf16_w3g")
    jmod, tree, port = _pair(jm, opts, 0)
    import jax
    x = np.random.RandomState(2).randn(T, rows, F_IN).astype(np.float32)
    # jitted: one XLA compile of the JAX model instead of one per op
    y_ref = jax.jit(lambda x_: jmod.apply(tree, x_, train=False)[0])(x)
    with torch.no_grad():
        y = port.eval()(tt(x))
    assert calls == {"sparse": 2, "dense": 0, "stream": 0}
    assert float(y.abs().max()) > 0.1
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


@pytest.mark.parametrize("case", ["q16", "tanh_noq"])
def test_train_mode_and_grads_match_jax(jm, calls, case):
    """Train mode (batch statistics, dropout 0): the output, the updated
    BN statistics and the gradient of every parameter (dense U through
    the w3g gather, x-weights, BN) against jax.grad. As shipped (relu,
    the 16-bit quantizers), and with tanh and no quantizers. T*B = 48
    rows."""
    import jax
    import jax.numpy as jnp
    tanh = case == "tanh_noq"
    opts = rnn_opts(act="tanh" if tanh else "relu", drop="0.0",
                    quant_inp=not tanh)
    jmod, tree, port = _pair(jm, opts, 0)
    x = np.random.RandomState(5).randn(T, B, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(T, B, H).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(tree["params"])
    port.train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    assert calls["sparse"] == 2 and calls["dense"] == 0
    # relative to the output's scale: relu's h is not bounded by 1 (here
    # up to ~2), and a 16-bit ceil step is 2^-15 of max|h|
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


def _stream(model, x, chunks, carries=None):
    """``model.apply_streaming`` over the chunks of x -> the outputs."""
    out = []
    for a, b in chunks:
        y, carries = model(x[a:b], carries)
        out.append(_np(y))
    return np.concatenate(out)


def test_stream_runs_dense_over_masked_U(jm, calls):
    """A stream drops the sparse layout in both packages: ragged chunks
    on the dense seeded forward over the masked U reproduce the sparse
    whole-utterance output, and equal chunks the JAX package's stream
    (without the input quantizers, whose scale is per call; equal chunks
    let JAX build its kernels once)."""
    jmod, tree, port = _pair(jm, rnn_opts(quant_inp=False), 0)
    x = np.random.RandomState(8).randn(T, B, F_IN).astype(np.float32)
    xt = tt(x)
    with torch.no_grad():
        full = port.eval()(xt)
        assert calls["sparse"] == 2
        ragged = _stream(port.apply_streaming, xt, ((0, 5), (5, 6), (6, T)))
        got = _stream(port.apply_streaming, xt, ((0, T // 2), (T // 2, T)))
    assert calls == {"sparse": 2, "dense": 0, "stream": 10}
    np.testing.assert_allclose(ragged, full.numpy(), atol=ATOL)
    import jax
    ref = _stream(jax.jit(lambda x_, c: jmod.apply_streaming(tree, x_, c)),
                  x, ((0, T // 2), (T // 2, T)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


# ---------------------------------------------------------------------------
# 3 train steps of a narrow sparse RNN chunk against the JAX runner
# ---------------------------------------------------------------------------

N_CD, ST_T, ST_B, SEED, STEPS = 40, 12, 4, 3, 3
#: The CGS-16x paper's HCGS setting
#: (cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:122-125).
HCGS_16X = {"hcgsx_block": "128,8", "hcgsx_sparse": "75,75",
            "hcgsh_block": "128,8", "hcgsh_sparse": "75,75"}


def chunk_config(quant_inp):
    """The TIMIT RNN cfg's [architecture1..2] and [model] with the
    CGS-16x HCGS and quantizer fields and ``rnn_hcgs = True``, narrowed
    to 2x256 (the 128-block recurrent masks Kb=2 at 75,75 keep one block
    a row: sparse), dropout 0, the head to N_CD classes, over an
    in-memory chunk of fMLLR-width features and cd labels."""
    src = configparser.ConfigParser()
    src.read(TIMIT_CFG)
    cc = configparser.ConfigParser()
    cc.read_string("[exp]\nto_do = train\nseed = 0\n\n[batches]\n"
                   "batch_size_train = %d\n\n[data_chunk]\n"
                   "fea = fea_name=fmllr\n\tfea_lst=none\n\tfea_opts=none\n"
                   "\tcw_left=0\n\tcw_right=0\n"
                   "lab = lab_name=lab_cd\n\tlab_folder=none\n"
                   "\tlab_opts=ali-to-pdf\n" % ST_B)
    for sec in ("architecture1", "architecture2", "model"):
        cc[sec] = dict(src[sec])
    n = len(cc["architecture1"]["rnn_lay"].split(","))
    cc["architecture1"].update(HCGS_16X, **QUANT)
    cc["architecture1"].update({
        "rnn_lay": "256,256", "rnn_drop": "0.0,0.0", "rnn_hcgs": "True",
        "rnn_quant_inp": str(quant_inp), "rnn_fused_scan": "True"})
    for k in ("rnn_use_laynorm", "rnn_use_batchnorm", "rnn_act"):
        cc["architecture1"][k] = ",".join(
            cc["architecture1"][k].split(",")[:2])
    assert n == 4                  # the cfg's 4 layers, cut to 2
    cc["architecture2"]["dnn_lay"] = str(N_CD)
    for sec in ("architecture1", "architecture2"):
        # eps 1e-6 as tests/test_torch_rnn.py: a gradient that cancels to
        # float32 noise would otherwise step by lr * noise / eps
        cc[sec]["opt_eps"] = "1e-6"
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


def test_train_steps_match_jax(jm, calls):
    """3 steps, both recurrences on the sparse kernels (the JAX package's
    on its sparse Pallas kernels): every parameter and BN statistic
    within 1e-4 of the JAX runner's after each step, the per-step loss
    and err within 1e-5 (relative). Without the 16-bit input quantizers:
    as the cfg ships them (relu behind 16-bit ceil quantizers) a one-ulp
    difference can move a quantized value a whole step, which RMSprop
    turns into a whole step of a parameter whose gradient is near 0
    (tests/test_torch_ligru_sparse.py); that model's gradients are
    test_train_mode_and_grads_match_jax[q16]'s."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cc = chunk_config(quant_inp=False)
    jchunk, pchunk = _chunks()
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    for arch in jg.net_order:
        jg.nets[arch].prepare_block_sparse(jv[arch])
    assert sorted(jg.nets["RNN_layers"]._rec_layouts) == [0, 1]
    jr = JC.ChunkRunner(jg, cc)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    net = tg.nets["RNN_layers"]
    assert type(net) is RNN and sorted(net._rec_layouts) == [0, 1]
    assert [(l.Kb, l.R) for l in net._rec_layouts.values()] == [(2, 1)] * 2
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, ST_B, True, np.random.RandomState(SEED), bucket=ST_T))
    jres, tres = [], []
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
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
    assert calls["sparse"] == 2 * STEPS and calls["dense"] == 0
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
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_cuda_kernels_match_plain_twins(cuda_device, act, qbits, wbf16):
    """The forward and the BPTT kernels against their twins on the card,
    on the same tensors, each counting its route's launches
    (rnn_fwd_sparse_launches, rnn_bwd_sparse_launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, g, w3g, drop, dhs = _inputs(19, act)
    g, w3g, drop, dhs = (tt(a).to(cuda_device) for a in (g, w3g, drop, dhs))
    f_route = tfr.rnn_fwd_sparse_route(B, tl, wbf16, cuda_device)[0]
    b_route = tfr.rnn_bwd_sparse_route(B, tl, wbf16, cuda_device)[0]
    with torch.no_grad():
        before = (tfr.fused_rnn_fwd_sparse.launches,
                  tfr.fused_rnn_bwd_sparse.launches)
        hs = tfr.fused_rnn_fwd_sparse(g, w3g, drop, tl, act, qbits, wbf16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dg = tfr.fused_rnn_bwd_sparse(g, w3g, drop, h_prev, dhs, tl, act,
                                      qbits, wbf16)
        assert (tfr.fused_rnn_fwd_sparse.launches,
                tfr.fused_rnn_bwd_sparse.launches) == (
            before[0] + tfr.rnn_fwd_sparse_launches(f_route, T),
            before[1] + tfr.rnn_bwd_sparse_launches(b_route, T, qbits))
        ref = tfr.fused_rnn_fwd_sparse_plain(g, w3g, drop, tl, act, qbits,
                                             wbf16)
        ref_dg = tfr.fused_rnn_bwd_sparse_plain(g, w3g, drop, h_prev, dhs,
                                                tl, act, qbits, wbf16)
    torch.cuda.synchronize()
    tol = 2e-2 if wbf16 else (ATOL_Q if qbits else ATOL)
    _assert_rel([hs.cpu(), dg.cpu()], [ref.cpu(), ref_dg.cpu()], tol,
                ["hs", "dg"])


@pytest.mark.cuda
def test_cuda_function_grads_match_cpu(cuda_device):
    """The autograd Function on the card (kernels, dw3g on the dw
    kernel) against the same call on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, g, w3g, drop, dhs = _inputs(23)
    _assert_rel(_torch_grads(g, w3g, drop, dhs, tl, 16, dev=cuda_device),
                _torch_grads(g, w3g, drop, dhs, tl, 16), ATOL_Q,
                ["hs", "dgates", "dw3g"])


def _cgs_layout(seed, h=1024):
    """The CGS-16x RNN's recurrent layout at width h: HCGS 128,8 at 75,75
    (Kb=8, R=2 at 1024)."""
    mask = hcgs_mask(h, h, [128, 8], [75, 75],
                     rng=np.random.RandomState(seed))
    return tbs.pack_layout(mask, 128)


def _case(t, b, layout, seed, act, dev):
    """Operands over ``layout`` at (t, b) on ``dev``: gates (relu's away
    from its kink, as _inputs'), w3g, drop (b, H), dhs."""
    h, bs = layout.N, layout.bs
    rng = np.random.RandomState(seed)
    g = rng.randn(t, b, h) * 0.5
    if act == "relu":
        g = np.where(rng.rand(1, b, h) > 0.5, 1.0, -1.0) * (2.0 + np.abs(g))
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    w3g = rng.randn(layout.Nb, bs, layout.R * bs) * 0.3 / np.sqrt(
        layout.R * bs)
    return (d(g), d(w3g), d((rng.rand(b, h) > 0.2) * 1.0),
            d(rng.randn(t, b, h)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.RNN_FWD_SPARSE_SHAPES)
def test_cuda_fwd_persist_every_block_shape(cuda_device, shape):
    """Row 36's persistent route forced to each instantiated block shape
    at H=256 (Kb=2, R=1) and a ragged batch (8 bi + 3 rows), relu and
    tanh, qbits 0 and 16, w3g f32 and bf16: one launch, the step route's
    bits (its dots sum in row_dots' order), and the twin's bars."""
    bi, un = shape
    b = 8 * bi + 3
    _, tl, *_ = _inputs(31)
    plan = tfr.rnn_fwd_sparse_plan(b, tl, shape)
    for act in ("relu", "tanh"):
        g, w3g, drop, _ = _case(T, b, tl, 40 + bi + un, act, cuda_device)
        for qbits in (0, 16):
            for wbf16 in (False, True):
                with torch.no_grad():
                    before = tfr.fused_rnn_fwd_sparse.launches
                    hs = tfr._rnn_fwd_sparse_persist(plan, g, w3g, drop, tl,
                                                     act, qbits, wbf16)
                    assert tfr.fused_rnn_fwd_sparse.launches == before + 1
                    step = tfr._rnn_fwd_sparse_step(g, w3g, drop, tl, act,
                                                    qbits, wbf16)
                    ref = tfr.fused_rnn_fwd_sparse_plain(g, w3g, drop, tl,
                                                         act, qbits, wbf16)
                torch.cuda.synchronize()
                case = (shape, act, qbits, wbf16)
                assert torch.equal(hs, step), case
                _assert_rel([hs.cpu()], [ref.cpu()],
                            2e-2 if wbf16 else _atol(qbits, False),
                            [str(case)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.RNN_BWD_SPARSE_SHAPES)
def test_cuda_bwd_persist_every_block_shape(cuda_device, shape):
    """Row 37's persistent route (the rebuild in the forward's order, then
    one cooperative chain) forced to each instantiated block shape at
    H=256 and a ragged batch, relu and tanh, qbits 0 and 16, w3g f32 and
    bf16: its launches, two calls bit for bit, dg and the rebuilt a_pre
    bit for bit the step route's, and the twin's bars."""
    bi, un = shape
    b = 8 * bi + 3
    _, tl, *_ = _inputs(33)
    plan = tfr.rnn_bwd_sparse_plan(b, tl.N, tl.bs, tl.C, shape)
    for act in ("relu", "tanh"):
        g, w3g, drop, dhs = _case(T, b, tl, 50 + bi + un, act, cuda_device)
        with torch.no_grad():
            hs = tfr.fused_rnn_fwd_sparse(g, w3g, drop, tl, act)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        for qbits in (0, 16):
            for wbf16 in (False, True):
                args = (g, w3g, drop, h_prev, dhs, tl, act, qbits, wbf16)
                with torch.no_grad():
                    before = tfr.fused_rnn_bwd_sparse.launches
                    dg, pre = tfr._rnn_bwd_sparse_persist(plan, *args,
                                                          with_pre=True)
                    assert tfr.fused_rnn_bwd_sparse.launches == before + \
                        tfr.rnn_bwd_sparse_launches("persist", T, qbits)
                    again = tfr._rnn_bwd_sparse_persist(plan, *args)
                    dg_st, pre_st = tfr._rnn_bwd_sparse_step(*args,
                                                             with_pre=True)
                    ref = tfr.fused_rnn_bwd_sparse_plain(*args)
                torch.cuda.synchronize()
                case = "%s, %s, q%d, bf16 %s" % (shape, act, qbits, wbf16)
                assert torch.equal(dg, again), case
                assert torch.equal(pre, pre_st), case
                assert torch.equal(dg, dg_st), case
                _assert_rel([dg.cpu()], [ref.cpu()],
                            2e-2 if wbf16 else _atol(qbits, False), [case])


@pytest.mark.cuda
def test_cuda_routes_at_the_cgs16x_shapes(cuda_device):
    """Both wrappers on the routes their plans name: "persist" at the
    CGS-16x RNN's 8 rows of 1024 (one launch; the rebuild and the chain,
    4 with the quantizer), "step" at 256 rows (1,024 blocks of 16 x 16: T
    and T + 1 launches); each the forced step route's bits and within
    the twin's bars, w3g f32 and bf16."""
    lay = _cgs_layout(421)
    for (t, b), route in (((12, 8), "persist"), ((3, 256), "step")):
        g, w3g, drop, dhs = _case(t, b, lay, 46, "relu", cuda_device)
        for wbf16 in (False, True):
            assert tfr.rnn_fwd_sparse_route(b, lay, wbf16,
                                            cuda_device)[0] == route
            assert tfr.rnn_bwd_sparse_route(b, lay, wbf16,
                                            cuda_device)[0] == route
            with torch.no_grad():
                before = (tfr.fused_rnn_fwd_sparse.launches,
                          tfr.fused_rnn_bwd_sparse.launches)
                hs = tfr.fused_rnn_fwd_sparse(g, w3g, drop, lay, "relu", 16,
                                              wbf16)
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                args = (g, w3g, drop, h_prev, dhs, lay, "relu", 16, wbf16)
                dg = tfr.fused_rnn_bwd_sparse(*args)
                assert (tfr.fused_rnn_fwd_sparse.launches,
                        tfr.fused_rnn_bwd_sparse.launches) == (
                    before[0] + tfr.rnn_fwd_sparse_launches(route, t),
                    before[1] + tfr.rnn_bwd_sparse_launches(route, t, 16))
                hs_st = tfr._rnn_fwd_sparse_step(g, w3g, drop, lay, "relu",
                                                 16, wbf16)
                dg_st = tfr._rnn_bwd_sparse_step(*args)
                ref = tfr.fused_rnn_fwd_sparse_plain(g, w3g, drop, lay,
                                                     "relu", 16, wbf16)
                ref_dg = tfr.fused_rnn_bwd_sparse_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(hs, hs_st) and torch.equal(dg, dg_st), route
            tol = 2e-2 if wbf16 else ATOL_Q
            _assert_rel([hs.cpu(), dg.cpu()], [ref.cpu(), ref_dg.cpu()], tol,
                        ["hs " + route, "dg " + route])
