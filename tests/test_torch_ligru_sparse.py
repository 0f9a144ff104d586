"""The port's block-sparse liGRU (pytorch_kaldi_cgs_tpu_torch: the sparse
liGRU of ops/fused_rnn.py, models/recurrent.py liGRU on a sparse layout)
against the JAX package on the same numpy inputs, the Pallas kernels run
in interpret mode.

- The two kernels' twins against ``_build_ligru_fwd_sparse`` and
  ``_build_ligru_bwd_sparse`` at H=256, bs=128 (Kb=2, R=1), relu and
  tanh, qbits 0 and 16, w3g in f32 and bf16.
- ``ligru_scan_fused_sparse`` (the autograd Function: dw3g on the
  block-sparse dw kernel's twin, G=2) against ``jax.vjp`` of the JAX
  ``ligru_scan_fused_sparse``, and against autograd through the plain
  loop; the size rule that picks the w3g dtype is the JAX package's.
- A narrow 2x256 HCGS + 8-bit + 16-bit liGRU with 128-block recurrent
  masks at 50,50 (both recurrences sparse) against JAX ``apply`` with
  ``ligru_fused_scan=True`` (its sparse kernels on the CPU) in eval (f32,
  bf16 compute, bf16 w3g) and in train mode with gradients against
  ``jax.grad``; at a batch where the JAX size rule says "" (the JAX
  package's float32 ``lax.scan`` over the masked U) the port stays on the
  sparse kernels with float32 w3g and agrees; a stream drops the layout
  and runs the dense seeded forward over the masked U, as the JAX
  package does.
- 3 ``ChunkRunner.train_step``s of a narrow two-layer sparse Li-GRU
  chunk (the TIMIT Li-GRU cfg with the CGS-16x paper's HCGS fields,
  narrowed) against the JAX runner.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's); with
the 16-bit quantizer 1e-4 (a one-ulp difference at a ceil step becomes
one step, max|h|/2^15, which the next steps carry on); bf16 w3g 1e-4
(both packages round the same operands to bf16 and sum in float32);
gradients relative to each one's scale at the same bars. T*B is a
multiple of 8 wherever dw3g is compared: the JAX package's ``sparse_dU``
drops the rows past one.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_ligru_sparse.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5; the 16-bit quantizer 1e-4; bf16 w3g 2e-2).
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import liGRU
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

T, B, H, BS = 12, 4, 256, 128     # Kb=2, R=1; T*B = 48
F_IN = 12
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


def _inputs(seed, act="relu", drop_bh=True, b=B):
    """A 128-block recurrent mask at 50% (Kb=2, R=1), its layout, gates
    (T, b, 2H) [h | z], w3g (Nb, 2bs, R*bs), drop, upstream dhs. For relu
    the candidate's gate inputs sit at +-(2 + |N(0, 0.5)|), away from 0
    by more than the recurrent term, so relu' cannot flip between the two
    packages' sums."""
    mask = hcgs_mask(H, H, [BS], [50], rng=np.random.RandomState(seed))
    layout = tbs.pack_layout(mask, BS)
    rng = np.random.RandomState(seed + 1)
    g = rng.randn(T, b, 2 * H) * 0.5
    if act == "relu":
        sign = np.where(rng.rand(1, b, H) > 0.5, 1.0, -1.0)
        g[..., :H] = sign * (2.0 + np.abs(g[..., :H]))
    w3g = rng.randn(layout.Nb, 2 * BS, layout.R * BS) * 0.3 / np.sqrt(BS)
    drop = ((rng.rand(b, H) > 0.2) * 1.0 if drop_bh
            else np.full((1, 1), 0.8))
    dhs = rng.randn(T, b, H)
    f = lambda a: np.asarray(a, np.float32)
    return mask, layout, f(g), f(w3g), f(drop), f(dhs)


def _j_kernel(jfr, jbs, mask, name, act, qbits):
    jl = jbs.pack_layout(mask, BS)
    return getattr(jfr, name)(T, B, H, act, qbits, jl.Nb, jl.R, BS,
                                 tuple(int(v) for v in jl.col_idx), True)


def _atol(qbits, wbf16):
    return ATOL_Q if (qbits == 16 or wbf16) else ATOL


def _h_prev(hs):
    return np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])


def _assert_rel(got, ref, tol, names):
    for name, a, b in zip(names, got, ref):
        scale = max(float(np.abs(_np(b)).max()), 1e-30)
        np.testing.assert_allclose(_np(a), _np(b), atol=tol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# twins vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_fwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, _ = _inputs(2, act)
    fwd = _j_kernel(jfr, jbs, mask, "_build_ligru_fwd_sparse", act, qbits)
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    ref = fwd(jnp.asarray(g), jw, jnp.asarray(drop))
    got = tfr.fused_ligru_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act,
                                     qbits, wbf16)
    np.testing.assert_allclose(got.numpy(), _np(ref),
                               atol=_atol(qbits, wbf16))


@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bwd_twin_matches_pallas(jfr, jbs, act, qbits, wbf16):
    """dg of the BPTT twin against the TPU kernel, both over the same
    forward's h_prev."""
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _inputs(4, act)
    jw = jnp.asarray(w3g).astype(jnp.bfloat16 if wbf16 else jnp.float32)
    j = jnp.asarray
    hs = _np(_j_kernel(jfr, jbs, mask, "_build_ligru_fwd_sparse", act,
                        qbits)(j(g), jw, j(drop)))
    h_prev = _h_prev(hs)
    ref = _j_kernel(jfr, jbs, mask, "_build_ligru_bwd_sparse", act, qbits)(
        j(g), jw, j(drop), j(h_prev), j(dhs))
    got = tfr.fused_ligru_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                     tt(dhs), tl, act, qbits, wbf16)
    np.testing.assert_allclose(got.numpy(), _np(ref),
                               atol=_atol(qbits, wbf16))


def test_wrappers_reject_bad_inputs():
    _, tl, g, w3g, drop, dhs = _inputs(0)
    g, w3g, drop, dhs = tt(g), tt(w3g), tt(drop), tt(dhs)
    with pytest.raises(ValueError, match="w3g must be"):
        tfr.fused_ligru_fwd_sparse(g, w3g[:, :-1], drop, tl)
    with pytest.raises(ValueError, match="layout"):
        tfr.fused_ligru_fwd_sparse(g[..., :-2], w3g, drop, tl)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_ligru_fwd_sparse(g, w3g, drop, tl, act="sigmoid")
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_ligru_bwd_sparse(g, w3g, drop, dhs, dhs[:-1], tl)
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_ligru_fwd_sparse(g.requires_grad_(), w3g, drop, tl)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _torch_grads(g, w3g, drop, dhs, layout, qbits, act="relu", dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(w3g).requires_grad_()]
    hs = tfr.ligru_scan_fused_sparse(leaves[0], leaves[1], layout, d(drop),
                                     act=act, quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("qbits", [0, 16])
def test_function_matches_jax_vjp(jbs, jfr, qbits, drop_bh):
    """hs, dgates and dw3g of the Function (dU as one block-sparse dw
    product over q(h_prev) at G=2) against jax.vjp of the JAX custom
    VJP."""
    import jax
    import jax.numpy as jnp
    mask, tl, g, w3g, drop, dhs = _inputs(13, drop_bh=drop_bh)
    jl = jbs.pack_layout(mask, BS)
    hs, vjp = jax.vjp(lambda g_, w_: jfr.ligru_scan_fused_sparse(
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
    hs = tfr.fused_ligru_fwd_sparse_plain(leaves[0], leaves[1], tt(drop), tl,
                                          "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    _assert_rel(got, ref, ATOL, ["hs", "dgates", "dw3g"])


def test_scan_fits_rule_is_the_jax_rule(jfr, monkeypatch):
    """The size rule that picks f32 or bf16 w3g at the liGRU's G=2 is the
    JAX package's: at the CGS-16x layout (Kb=8, R=2) "f32" up to 151
    rows, "bf16" from 152 to 162, "" from 163."""
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    mask = hcgs_mask(1024, 1024, [128, 8], [75, 75],
                     rng=np.random.RandomState(0))
    layout = tbs.pack_layout(mask, 128)
    assert (layout.Kb, layout.R) == (8, 2)
    rows = (8, 16, 151, 152, 162, 163, 256)
    for mb in (None, "4", "2"):
        if mb is None:
            monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
        else:
            monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", mb)
        for b in rows:
            assert tfl.sparse_scan_fits(b, 1024, layout, 2) == \
                jfl.sparse_scan_fits_vmem(b, 1024, layout, 2)
    monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    assert [tfl.sparse_scan_fits(b, 1024, layout, 2) for b in rows] == \
        ["f32"] * 3 + ["bf16"] * 2 + [""] * 2


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def ligru_opts(cdt="", act="relu", drop="0.2", quant_inp=True, fused=True):
    """2x256 liGRU, BN, HCGS 8,2 at 25,62.5 on x (dense-masked) and
    128,2 at 50,50 on h (Kb=2, R=1: both recurrences sparse), 8-bit
    weights, 16-bit input quantizers; ``ligru_fused_scan`` puts the JAX
    package on its sparse kernels on the CPU."""
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "ligru",
        "ligru_lay": "256,256", "ligru_drop": "%s,%s" % (drop, drop),
        "ligru_use_batchnorm": "True,True", "ligru_use_laynorm": "False,False",
        "ligru_use_laynorm_inp": "False", "ligru_use_batchnorm_inp": "False",
        "ligru_act": "relu,%s" % act, "ligru_orthinit": "True",
        "ligru_bidir": "False", "ligru_hcgs": "True",
        "hcgsx_block": "8,2", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "128,2", "hcgsh_sparse": "50,50",
        "ligru_quant": "True", "param_quant": "8",
        "ligru_quant_inp": str(quant_inp), "inp_quant": "16",
        "ligru_fused_scan": str(fused), "scan_unroll": "1"}


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
    """The JAX liGRU with its layouts prepared, its init(seed) with BN
    statistics perturbed, and the port over the same variables."""
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(seed), seed + 1)
    jmod.prepare_block_sparse(tree)
    port = liGRU(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    assert sorted(port._rec_layouts) == [0, 1] == sorted(jmod._rec_layouts)
    assert port._bs_layouts == {}
    return jmod, tree, port


@pytest.fixture
def sparse_calls(monkeypatch):
    """Counts the port's calls into the sparse liGRU twin and the dense
    liGRU's (whole utterance, stream)."""
    calls = {"sparse": 0, "dense": 0, "stream": 0}
    for name, key in (("fused_ligru_fwd_sparse_plain", "sparse"),
                      ("ligru_scan_fused", "dense"),
                      ("ligru_scan_fused_stream", "stream")):
        real = getattr(tfr, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return calls


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16_w3g"])
def test_eval_matches_jax_sparse(jm, monkeypatch, sparse_calls, case):
    """Both layers on the sparse kernels (their twins here), against JAX
    apply on its sparse Pallas kernels. Under bf16 compute only the
    x-projections round to bf16 (the recurrence is float32 in both
    packages); ``bf16_w3g``: a 1 MB budget makes the JAX size rule read
    w3g in bf16 at 36 rows, in both packages."""
    rows = 3
    if case == "bf16_w3g":
        rows = 36
        monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
        _, tl, _, _, _, _ = _inputs(0)
        assert tfl.sparse_scan_fits(rows, H, tl, 2) == "bf16"
    opts = ligru_opts("bf16" if case == "bf16" else "")
    jmod, tree, port = _pair(jm, opts, 0)
    x = np.random.RandomState(2).randn(11, rows, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = port.eval()(tt(x))
    assert sparse_calls == {"sparse": 2, "dense": 0, "stream": 0}
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


@pytest.mark.parametrize("quant_inp", [True, False], ids=["q16", "noq"])
def test_train_mode_and_grads_match_jax(jm, sparse_calls, quant_inp):
    """Train mode (batch statistics, dropout 0): the output, the updated
    BN statistics and the gradient of every parameter (dense U through
    the w3g gather, x-weights, BN) against jax.grad. T*B = 40 rows."""
    import jax
    import jax.numpy as jnp
    opts = ligru_opts(drop="0.0", quant_inp=quant_inp)
    jmod, tree, port = _pair(jm, opts, 3)
    x = np.random.RandomState(5).randn(10, 4, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(10, 4, 256).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(tree["params"])
    port.train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    assert sparse_calls["sparse"] == 2 and sparse_calls["dense"] == 0
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL_Q)
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


def test_sparse_kernels_where_jax_size_rule_says_no(jm, monkeypatch,
                                                    sparse_calls):
    """With a 1 MB budget the JAX size rule says "" at 48 rows: the JAX
    package runs its float32 lax.scan over the masked U
    (``ligru_fused_scan=False`` keeps it off its fused kernels), the port
    stays on the sparse kernels with float32 w3g, and the outputs
    agree."""
    monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
    opts = ligru_opts(fused=False)
    jmod, tree, port = _pair(jm, opts, 1)
    assert tfl.sparse_scan_fits(48, H, port._rec_layouts[0], 2) == ""
    x = np.random.RandomState(9).randn(4, 48, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    seen = []
    real = tfr.fused_ligru_fwd_sparse

    def spy(*a, **k):
        seen.append(a[-1] if len(a) > 6 else k.get("bf16"))
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_ligru_fwd_sparse", spy)
    with torch.no_grad():
        y = port.eval()(tt(x))
    assert seen == [False, False] and sparse_calls["dense"] == 0
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


def test_stream_runs_dense_over_masked_U(jm, sparse_calls):
    """A stream drops the sparse layout in both packages: chunks on the
    dense seeded forward over the masked U reproduce the sparse
    whole-utterance output, and the JAX package's stream (without the
    input quantizers, whose scale is per call)."""
    opts = ligru_opts(quant_inp=False)
    jmod, tree, port = _pair(jm, opts, 2)
    x = np.random.RandomState(8).randn(24, 3, F_IN).astype(np.float32)
    xt = tt(x)
    with torch.no_grad():
        full = port.eval()(xt)
        assert sparse_calls["sparse"] == 2
        carries, got = None, []
        for a, b in ((0, 7), (7, 8), (8, 24)):
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert sparse_calls == {"sparse": 2, "dense": 0, "stream": 6}
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)
    jc, jgot = None, []
    for a, b in ((0, 7), (7, 8), (8, 24)):
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL)


# ---------------------------------------------------------------------------
# 3 train steps of a narrow sparse Li-GRU chunk against the JAX runner
# ---------------------------------------------------------------------------

LIGRU_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "TIMIT_baselines", "TIMIT_liGRU_fmllr_hcgs.cfg")
N_CD, ST_T, ST_B, SEED, STEPS = 40, 12, 4, 3, 3
#: The CGS-16x paper's HCGS setting
#: (cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:122-125).
HCGS_16X = {"hcgsx_block": "128,8", "hcgsx_sparse": "75,75",
            "hcgsh_block": "128,8", "hcgsh_sparse": "75,75"}


def chunk_config(cdt="", quant_inp=True):
    """The Li-GRU cfg's [architecture1..2] with the 16x HCGS fields,
    narrowed to 2x256 (the 128-block recurrent masks Kb=2 at 75,75 keep
    one block a row: sparse), dropout 0, over an in-memory chunk of
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
    cc["architecture1"] = dict(src["architecture1"], **HCGS_16X)
    cc["architecture2"] = dict(src["architecture2"], dnn_lay=str(N_CD))
    cc["architecture1"].update({"ligru_lay": "256,256",
                                "ligru_drop": "0.0,0.0",
                                "ligru_quant_inp": str(quant_inp),
                                "ligru_fused_scan": "True"})
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


@pytest.mark.parametrize("case", ["f32-noq", "bf16-noq", "f32-q16"])
def test_train_steps_match_jax(jm, sparse_calls, case):
    """3 steps, both recurrences on the sparse kernels (the JAX package's
    on its sparse Pallas kernels). Without the 16-bit input quantizers
    every parameter and BN statistic is within 1e-4 of the JAX runner's
    after each step (RMSprop's first step moves each by about
    lr / sqrt(1 - alpha) = 7e-3, so a wrong or missing gradient shows)
    and the per-step loss and err within 1e-5 (relative). As the cfg
    ships it (relu behind the 16-bit ceil quantizers) a one-ulp
    difference moves a quantized value a whole step, and RMSprop turns
    a gradient near 0 whose sign that flips into a whole step of 1.4e-2
    (seen in layer 1's x-weights after step 1, while the gradients agree
    to 1e-4 of their scale: test_train_mode_and_grads_match_jax): the
    first step's loss is held to 1e-5, the next two, which start from
    those parameters, to 1e-3."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cdt, quant = case.split("-")
    cc = chunk_config("" if cdt == "f32" else cdt, quant == "q16")
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
    assert type(net) is liGRU and sorted(net._rec_layouts) == [0, 1]
    assert net._bs_layouts == {}
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
    assert sparse_calls["sparse"] == 2 * STEPS and sparse_calls["dense"] == 0
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
@pytest.mark.parametrize("wbf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_cuda_kernels_match_plain_twins(cuda_device, act, qbits, wbf16):
    """The forward (T launches) and the BPTT kernel (T + 1) against their
    twins on the card, on the same tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tl, g, w3g, drop, dhs = _inputs(19, act)
    g, w3g, drop, dhs = (tt(a).to(cuda_device) for a in (g, w3g, drop, dhs))
    with torch.no_grad():
        before = (tfr.fused_ligru_fwd_sparse.launches,
                  tfr.fused_ligru_bwd_sparse.launches)
        hs = tfr.fused_ligru_fwd_sparse(g, w3g, drop, tl, act, qbits, wbf16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dg = tfr.fused_ligru_bwd_sparse(g, w3g, drop, h_prev, dhs, tl, act,
                                        qbits, wbf16)
        assert (tfr.fused_ligru_fwd_sparse.launches,
                tfr.fused_ligru_bwd_sparse.launches) == (before[0] + T,
                                                         before[1] + T + 1)
        ref = tfr.fused_ligru_fwd_sparse_plain(g, w3g, drop, tl, act, qbits,
                                               wbf16)
        ref_dg = tfr.fused_ligru_bwd_sparse_plain(g, w3g, drop, h_prev, dhs,
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
