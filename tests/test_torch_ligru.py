"""The port's Li-GRU (pytorch_kaldi_cgs_tpu_torch: ops/fused_rnn.py,
models/recurrent.py liGRU) against the JAX package on the same numpy
inputs.

- The three kernels' plain twins (forward: plain, stash, seeded; the
  stash and recompute BPTT) against the JAX package's Pallas kernels run
  in interpret mode, for qbits 0/8/16 and relu/tanh (the backward over
  every activation), at a ragged shape (B=3, H=18).
- The autograd Function against ``jax.vjp`` of ``ligru_scan_fused``
  under the stash and the recompute backward, and (without JAX) against
  autograd through the plain loop.
- ``liGRU.init(seed)`` array for array; a 2-layer HCGS + 8-bit + 16-bit
  recurrent-input + BN liGRU forward against JAX ``apply`` with
  ``ligru_fused_scan=True`` in float32 and in bf16; the plain step loop
  against the JAX ``lax.scan``; the fused path chosen by act and layer
  norm alone; train-mode batch norm; streaming.
- 3 ``ChunkRunner.train_step``s of a narrow liGRU chunk against the JAX
  runner, as tests/test_torch_train.py does for the LSTM.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's, over 12
steps); with a 16-bit quantizer (the model's x, or h in the kernels)
1e-4: a one-ulp difference at a ceil step becomes one step,
max|h|/2^15 ~ 2e-5 here, which the next steps' dots carry on (8 bits
put the steps ~256x further apart than an ulp of difference can reach,
so 8-bit cases keep 1e-5); dU with the recurrent quantizer 5e-5 (q(h)
one level apart times |dg|).
bf16: the liGRU's fused recurrence stays float32 in both packages, so
the bf16 model is held to the float32 input-quantizer bar (1e-4), not
to the JAX package's bf16 bar (2e-2), and a recurrence rounded to bf16
(the JAX ``lax.scan``) is shown to miss it. The gradients of relu's
derivative: both packages take it from the pre-activation (recompute)
or from the output (stash) alike, so the same bars hold; the inputs
keep pre-activations away from 0 by more than an ulp.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_ligru.py``).
There the kernels are held against their twins; the forward's
persistent route (TPU row 16) at every instantiated block shape at a
ragged width and batch, with and without the seed, the stash and the
quantizer, bit for bit its step route (both sum each dot in one order
and quantize with quant()'s bits); both routes at their shapes with
their launches; the recompute BPTT's persistent route at three shapes
and its step route.
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import get_model_class, liGRU
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

T, B, H = 12, 3, 18
F_IN = 12
ATOL = 1e-5
ATOL_Q = 1e-4          # a 16-bit quantizer
ATOL_DU_Q = 5e-5       # dU through the recurrent quantizer


@pytest.fixture
def jfr():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _inputs(seed, drop_bh=True):
    rng = np.random.RandomState(seed)
    g = (rng.randn(T, B, 2 * H) * 0.5).astype(np.float32)
    U = (rng.randn(2 * H, H) * 0.3).astype(np.float32)
    if drop_bh:
        drop = (rng.rand(B, H) > 0.2).astype(np.float32)
    else:
        drop = np.full((1, 1), 0.8, np.float32)
    h0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    dhs = rng.randn(T, B, H).astype(np.float32)
    return g, U, drop, h0, dhs


def _np(x):
    return np.asarray(x)


def _atol(qbits):
    return ATOL_Q if qbits == 16 else ATOL


tt = torch.from_numpy


# ---------------------------------------------------------------------------
# twins vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "stash", "seeded"])
@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_fwd_twin_matches_pallas(jfr, act, qbits, variant):
    import jax.numpy as jnp
    g, U, drop, h0, _ = _inputs(3, drop_bh=variant != "seeded")
    seeded, stash = variant == "seeded", variant == "stash"
    fwd = jfr._build_ligru_fwd(T, B, H, act, qbits, True, with_init=seeded,
                               stash=stash)
    j = jnp.asarray
    ref = fwd(j(g), j(U), j(np.broadcast_to(drop, (B, H))),
              *((j(h0),) if seeded else ()))
    got = tfr.fused_ligru_fwd(tt(g), tt(U), tt(drop),
                              tt(h0) if seeded else None, act=act,
                              qbits=qbits, stash=stash)
    got, ref = (got, ref) if stash else ((got,), (ref,))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=_atol(qbits))
    if seeded:   # the streaming entry: (hs, h_T), seeded from h0
        hs, hT = jfr.ligru_scan_fused_stream(j(g), j(U), j(drop), j(h0),
                                             act=act, quant_bits=qbits,
                                             interpret=True)
        ths, thT = tfr.ligru_scan_fused_stream(tt(g), tt(U), tt(drop), tt(h0),
                                               act=act, quant_bits=qbits)
        np.testing.assert_allclose(ths.numpy(), _np(hs), atol=_atol(qbits))
        np.testing.assert_array_equal(thT.numpy(), ths[-1].numpy())


def _residuals(jfr, g, U, drop, act, qbits):
    """The JAX stash forward's hs and acts, and h_prev."""
    import jax.numpy as jnp
    hs, acts = jfr._build_ligru_fwd(T, B, H, act, qbits, True, stash=True)(
        jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop))
    hs, acts = np.array(hs), np.array(acts)
    return hs, acts, np.concatenate([np.zeros((1, B, H), np.float32),
                                     hs[:-1]])


@pytest.mark.parametrize("act", ["relu", "tanh", "htanh", "linear"])
def test_bwd_stash_twin_matches_pallas(jfr, act):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(5)
    _, acts, h_prev = _residuals(jfr, g, U, drop, act, 0)
    j = jnp.asarray
    ref = jfr._build_ligru_bwd_stash(T, B, H, act, True)(
        j(acts), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_ligru_bwd_stash(tt(acts), tt(U), tt(drop), tt(h_prev),
                                    tt(dhs), act)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bwd_recompute_twin_matches_pallas(jfr, act, qbits):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(7)
    _, _, h_prev = _residuals(jfr, g, U, drop, act, qbits)
    j = jnp.asarray
    ref = jfr._build_ligru_bwd(T, B, H, act, qbits, True)(
        j(g), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_ligru_bwd(tt(g), tt(U), tt(drop), tt(h_prev), tt(dhs),
                              act, qbits)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=_atol(qbits))


def test_wrappers_reject_bad_inputs():
    g, U, drop, h0, dhs = (tt(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="U must be"):
        tfr.fused_ligru_fwd(g, U[:, :-1], drop)
    with pytest.raises(ValueError, match="float32"):
        tfr.fused_ligru_fwd(g.double(), U, drop)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_ligru_fwd(g, U, drop, act="sigmoid")
    with pytest.raises(ValueError, match="h0 must be"):
        tfr.fused_ligru_fwd(g, U, drop, h0=h0[:, :-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_ligru_bwd(g, U, drop, dhs, dhs[:-1])
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_ligru_fwd(g.requires_grad_(), U, drop)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _set_stash(monkeypatch, stash):
    monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    if stash:
        monkeypatch.setenv("PKC_BWD_STASH_CELLS", "ligru")
    else:
        monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)


def _torch_grads(g, U, drop, dhs, qbits, act, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(U).requires_grad_()]
    hs = tfr.ligru_scan_fused(leaves[0], leaves[1], d(drop), act=act,
                              quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_match_jax_vjp(jfr, monkeypatch, stash, qbits,
                                      drop_bh):
    """hs, dgates and dU of the Function against jax.vjp of the JAX
    custom VJP, both packages on the same stash/recompute choice (the
    default is recompute in both)."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    _set_stash(monkeypatch, stash)
    assert tfr.bwd_stash_enabled("ligru") == jfl._bwd_stash_enabled("ligru") \
        == stash
    g, U, drop, _, dhs = _inputs(13, drop_bh)
    j = jnp.asarray
    hs, vjp = jax.vjp(lambda g_, U_: jfr.ligru_scan_fused(
        g_, U_, j(drop), act="relu", quant_bits=qbits, interpret=True),
        j(g), j(U))
    ref = [_np(hs)] + [_np(a) for a in vjp(j(dhs))]
    got = _torch_grads(g, U, drop, dhs, qbits, "relu")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        atol = ATOL_DU_Q if (name == "dU" and qbits) else _atol(qbits)
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_equal_autograd_through_plain_loop(monkeypatch, stash,
                                                          qbits):
    """Independent of JAX: the Function's backward (BPTT twin + one dU
    product) equals torch.autograd through the plain forward loop with
    its straight-through recurrent quantizer."""
    _set_stash(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(17)
    got = _torch_grads(g, U, drop, dhs, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(U).requires_grad_()]
    hs = tfr.fused_ligru_fwd_plain(leaves[0], leaves[1], tt(drop), None,
                                   "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def ligru_opts(cdt="", laynorm=False, act="relu", bidir=False, fused=True,
               quant_inp=True, hcgsh="8,2", hcgsh_sparse="25,62.5", lay=16):
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "ligru",
        "ligru_lay": "%d,%d" % (lay, lay), "ligru_drop": "0.2,0.2",
        "ligru_use_batchnorm": "True,True",
        "ligru_use_laynorm": "%s,%s" % (laynorm, laynorm),
        "ligru_use_laynorm_inp": "False", "ligru_use_batchnorm_inp": "False",
        "ligru_act": "relu,%s" % act, "ligru_orthinit": "True",
        "ligru_bidir": str(bidir), "ligru_hcgs": "True",
        "hcgsx_block": "8,2", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": hcgsh, "hcgsh_sparse": hcgsh_sparse,
        "ligru_quant": "True", "param_quant": "8",
        "ligru_quant_inp": str(quant_inp), "inp_quant": "16",
        "ligru_fused_scan": str(fused), "scan_unroll": "1"}


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


def _port(opts, tree):
    m = liGRU(opts, F_IN, device="cpu")
    return m.load_variables(convert.from_jax_variables(tree))


def _assert_tree_equal(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("opts", [ligru_opts(),
                                  ligru_opts(laynorm=True, bidir=True)],
                         ids=["bn_hcgs", "ln_bidir"])
def test_init_equals_jax_init(jm, opts):
    for seed in (0, 7):
        port = liGRU(opts, F_IN, seed=seed, device="cpu")
        jtree = jm.liGRU(opts, F_IN).init(seed)
        _assert_tree_equal(convert.to_jax_variables(port.variables()), jtree)
        # the variables cross both ways unchanged
        back = convert.to_jax_variables(convert.from_jax_variables(jtree))
        _assert_tree_equal(back, jtree)


def _eval_both(jm, opts, x, seed=0):
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(seed), seed + 1)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(opts, tree).eval()(tt(x))
    return y.numpy(), np.asarray(y_ref), tree


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_ligru_eval_matches_jax_fused(jm, cdt):
    """The 2-layer HCGS + quant + BN liGRU against JAX apply on its fused
    Pallas recurrence. Under bf16 only the x-projections round to bf16
    (the fused liGRU is float32 in both packages), so the float32 bar
    holds; the JAX lax.scan recurrence, which rounds h and U to bf16,
    misses it."""
    x = np.random.RandomState(2).randn(11, 3, F_IN).astype(np.float32)
    y, y_ref, tree = _eval_both(jm, ligru_opts(cdt=cdt), x)
    np.testing.assert_allclose(y, y_ref, atol=ATOL_Q)
    if cdt:
        y_scan, _ = jm.liGRU(ligru_opts(cdt=cdt, fused=False), F_IN).apply(
            tree, x, train=False)
        assert float(np.abs(y - np.asarray(y_scan)).max()) > ATOL_Q
        y32, _, _ = _eval_both(jm, ligru_opts(), x)
        assert float(np.abs(y - y32).max()) > 0     # bf16 projections ran


@pytest.mark.parametrize("opts", [
    ligru_opts(fused=False), ligru_opts(cdt="bf16", act="sigmoid"),
    ligru_opts(laynorm=True, act="tanh"), ligru_opts(act="sigmoid"),
    ligru_opts(bidir=True)],
    ids=["fused_vs_jax_scan", "sigmoid_act_bf16", "laynorm", "sigmoid_act",
         "bidir"])
def test_ligru_plain_loop_and_bidir_match_jax(jm, opts):
    """Layers the fused recurrence does not take (in-scan layer norm,
    another activation) run the plain step loop (bf16-rounded recurrent
    dots under bf16, as the JAX lax.scan); bidir concatenates the
    time-reversed copy along the batch. ``fused_vs_jax_scan``: the port's
    fused float32 recurrence against the JAX ``lax.scan``
    (``ligru_fused_scan=False``, an option the port does not read)."""
    x = np.random.RandomState(5).randn(9, 2, F_IN).astype(np.float32)
    y, y_ref, _ = _eval_both(jm, opts, x, seed=3)
    atol = 2e-2 if opts["compute_dtype"] else ATOL_Q
    np.testing.assert_allclose(y, y_ref, atol=atol)


def test_fused_recurrence_ignores_size_rule_and_option(jfr, monkeypatch):
    """The port takes the fused recurrence by what its kernels support
    alone: at a batch for which the JAX package's VMEM rule would fall
    back to lax.scan, and with ``ligru_fused_scan=False``, both layers
    call ``ligru_scan_fused``; a sigmoid layer takes the step loop."""
    Bbig = 16384
    assert not jfr.fits_vmem(Bbig, 16, 2)
    calls = []
    real = tfr.ligru_scan_fused

    def spy(gates, *args, **kw):
        calls.append(gates.shape[1])
        return real(gates, *args, **kw)
    monkeypatch.setattr(tfr, "ligru_scan_fused", spy)
    x = torch.from_numpy(
        np.random.RandomState(4).randn(2, Bbig, F_IN).astype(np.float32))
    for opts, want in ((ligru_opts(fused=False), [Bbig, Bbig]),
                       (ligru_opts(act="sigmoid"), [Bbig])):
        calls.clear()
        with torch.no_grad():
            y = liGRU(opts, F_IN, device="cpu").eval()(x)
        assert calls == want and bool(torch.isfinite(y).all())


def test_ligru_train_mode_batch_norm_matches_jax(jm):
    """Train mode with dropout 0: batch statistics normalize, running
    ones update in place like the JAX package's returned state."""
    import jax
    opts = dict(ligru_opts(), ligru_drop="0.0,0.0")
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(0), 6)
    x = np.random.RandomState(7).randn(10, 3, F_IN).astype(np.float32)
    y_ref, state_ref = jmod.apply(tree, x, train=True,
                                  rng=jax.random.PRNGKey(0))
    port = _port(opts, tree).train()
    with torch.no_grad():
        y = port(tt(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL_Q)
    got = convert.flatten(convert.to_jax_variables(port.variables())["state"])
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-6,
                                   err_msg=k)


def test_ligru_streaming_equals_whole_utterance(jm):
    """Three chunks with the h carry seeding the fused forward reproduce
    the whole-utterance eval output, and match the JAX package's
    streaming (its seeded Pallas forward, interpret mode)."""
    opts = ligru_opts(quant_inp=False)
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(2), 3)
    x = np.random.RandomState(8).randn(24, 3, F_IN).astype(np.float32)
    port = _port(opts, tree).eval()
    xt = tt(x)
    with torch.no_grad():
        full = port(xt)
        carries, got = None, []
        for a, b in ((0, 7), (7, 8), (8, 24)):
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert len(carries) == 2 and carries[0].shape == (3, 16)
    np.testing.assert_allclose(torch.cat(got).numpy(), full.numpy(),
                               atol=1e-6)
    jc, jgot = None, []
    for a, b in ((0, 7), (7, 8), (8, 24)):
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(np.asarray(y))
    np.testing.assert_allclose(torch.cat(got).numpy(), np.concatenate(jgot),
                               atol=ATOL)


def test_sparse_recurrence_layout_raises_not_ported(monkeypatch):
    """A 128-block recurrent HCGS mask that drops half of each row's
    blocks, which the port once refused, now runs on the block-sparse
    liGRU kernels (their twins here) in both layers, at every batch;
    tests/test_torch_ligru_sparse.py holds them against the JAX package.
    The shipped TIMIT Li-GRU (128,4 at 25,62.5: Kb=8, R=6) keeps the
    dense fused recurrence."""
    assert get_model_class("pytorch_kaldi_cgs_tpu.models", "liGRU") is liGRU
    calls = []
    real = tfr.ligru_scan_fused_sparse

    def spy(gates, *a, **k):
        calls.append(gates.shape[1])
        return real(gates, *a, **k)
    monkeypatch.setattr(tfr, "ligru_scan_fused_sparse", spy)
    m = liGRU(ligru_opts(hcgsh="128,2", hcgsh_sparse="50,50", lay=256),
              F_IN, device="cpu").eval()
    assert sorted(m._rec_layouts) == [0, 1]
    for rows in (2, 300):
        with torch.no_grad():
            y = m(torch.randn(3, rows, F_IN))
        assert y.shape == (3, rows, 256) and bool(torch.isfinite(y).all())
    assert calls == [2, 2, 300, 300]
    shipped = liGRU(ligru_opts(hcgsh="128,4", lay=1024), F_IN, device="cpu")
    assert shipped._rec_layouts == {}


# ---------------------------------------------------------------------------
# 3 train steps against the JAX runner
# ---------------------------------------------------------------------------

SEED = 3
STEPS = 3
LOSS_TOL = 1e-5      # per-step loss and err
VAR_TOL = 1e-4       # raw parameters and BN running statistics


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    pytest.importorskip("jax")
    from pytorch_kaldi_cgs_tpu.data import synth
    tmp = tmp_path_factory.mktemp("torch_ligru")
    root = str(tmp / "data")
    synth.generate(root, synth.SynthSpec(
        num_utts=12, num_phones=4, states_per_phone=2, feat_dim=6,
        min_len=20, max_len=40, noise=0.4, seed=7))
    return tmp, root


def _chunk_cfg(synth_data, name, cdt, quant_inp):
    """make_synth_cfg(model=liGRU) -> check_cfg -> create_lists ->
    create_configs; the first train chunk config with HCGS, 8-bit
    weights, the 16-bit input quantizers (``quant_inp``) and the JAX
    fused recurrence set on the liGRU."""
    from pytorch_kaldi_cgs_tpu import config as C
    from pytorch_kaldi_cgs_tpu.utils import make_synth_cfg
    tmp, root = synth_data
    out = str(tmp / name)
    cfg = make_synth_cfg(str(tmp / (name + ".cfg")), root, out, model="liGRU",
                         hidden=16, n_epochs=1, n_chunks=1, batch_size=4,
                         lr=0.002, opt="rmsprop", cw=0)
    config = configparser.ConfigParser()
    config.read(cfg)
    config, _, _ = C.check_cfg(cfg, config, "proto/global.proto")
    C.create_lists(config)
    C.create_configs(config)
    chunks = open(os.path.join(out, "exp_files",
                               "list_chunks.txt")).read().split()
    path = [c for c in chunks if os.path.basename(c).startswith("train")][0]
    cc = configparser.ConfigParser()
    cc.read(path)
    sec = [s for s in cc.sections() if "architecture" in s
           and cc[s]["arch_class"] == "liGRU"][0]
    cc[sec].update({
        "ligru_hcgs": "True", "hcgsx_block": "8,2", "hcgsx_sparse": "25,50",
        "hcgsh_block": "8,2", "hcgsh_sparse": "25,50", "ligru_quant": "True",
        "param_quant": "8", "ligru_quant_inp": str(quant_inp),
        "inp_quant": "16",
        "ligru_fused_scan": "True"})
    for s in cc.sections():
        if "architecture" in s:
            # RMSprop's first step is lr * g / (sqrt(1 - alpha) |g| + eps):
            # at eps 1e-8 a gradient that cancels to float32 noise (a
            # layer-1 z-gate BN beta sums to -3e-10 against a 1.5e-3
            # scale) becomes a step of lr * noise / eps ~ 1e-4, different
            # in each package; eps 1e-6 keeps that below 1e-6 and leaves
            # every gradient above ~1e-5 as it was
            cc[s]["compute_dtype"] = cdt
            cc[s]["opt_eps"] = "1e-6"
    return cc, path


def _max_tree_diff(ref, got):
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got)
        return max([_max_tree_diff(ref[k], got[k]) for k in ref] or [0.0])
    return float(np.abs(np.asarray(ref) - np.asarray(got)).max())


@pytest.mark.parametrize("case", ["f32-recompute-q16", "f32-stash-q16",
                                  "bf16-recompute"])
def test_train_steps_match_jax(synth_data, monkeypatch, case):
    """Per-step loss and err to 1e-5, raw parameters and BN statistics
    to 1e-4 after 3 steps, dropout 0. The bf16 case runs without the
    input quantizers, as tests/test_torch_train.py's bf16 case: layer 1
    quantizes layer 0's h to 16 bits and then rounds it to bf16, so an
    ulp of difference in h can move a projection input by a bf16 ulp
    (2^-8 of it), and the parameters drift past 1e-4 in 3 steps."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cdt, bwd = case.split("-")[:2]
    _set_stash(monkeypatch, bwd == "stash")
    cc, path = _chunk_cfg(synth_data, "slice_" + case,
                          "" if cdt == "f32" else cdt, case.endswith("q16"))
    jchunk = JC.read_chunk_data(path)
    pchunk = tdata.ChunkData(
        list(jchunk.names), np.array(jchunk.data), np.array(jchunk.end_index),
        {n: tdata.FeaStream(s.name, s.fea_lst, s.fea_opts, s.cw_left,
                            s.cw_right, s.col_start, s.col_end)
         for n, s in jchunk.fea_streams.items()},
        {n: tdata.LabStream(s.name, s.lab_folder, s.lab_opts,
                            s.lab_count_file, s.lab_data_folder, s.lab_graph,
                            s.col)
         for n, s in jchunk.lab_streams.items()})
    jg = JG.NetGraph(cc, jchunk)
    jr = JC.ChunkRunner(jg, cc)
    jv = jg.init_variables(SEED)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    assert type(tg.nets["liGRU_layers"]) is liGRU
    batches = list(tchunk.make_seq_batches(pchunk, 4, True,
                                           np.random.RandomState(SEED)))
    jres, tres = [], []
    for k, (inp, mask, _, _) in enumerate(batches[:STEPS]):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
    np.testing.assert_allclose(tres, jres, atol=LOSS_TOL)
    assert tres[-1][0] < tres[0][0]            # it learns
    jv = jax.device_get(jv)
    tv = tg.jax_variables()
    for arch in jv:
        for coll in ("params", "state"):
            assert _max_tree_diff(jv[arch][coll], tv[arch][coll]) <= VAR_TOL, \
                (arch, coll)


# ---------------------------------------------------------------------------
# on the card: kernels against their twins
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
def test_cuda_kernels_match_plain_twins(cuda_device, act, qbits):
    """The forward (plain, stash, seeded) and both BPTT kernels against
    their twins on the card, on the same tensors; the forward on its
    persistent route (1 launch a call), the stash BPTT T launches, the
    recompute BPTT on its persistent route (2, or 4 with the
    quantizer)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, dhs = (tt(a).to(cuda_device) for a in _inputs(19))
    with torch.no_grad():
        before = tfr.fused_ligru_fwd.launches
        hs, acts = tfr.fused_ligru_fwd(g, U, drop, act=act, qbits=qbits,
                                       stash=True)
        hs1 = tfr.fused_ligru_fwd(g, U, drop, act=act, qbits=qbits)
        hs_s = tfr.fused_ligru_fwd(g, U, drop, h0, act=act, qbits=qbits)
        assert tfr.ligru_fwd_route(B, H, cuda_device)[0] == "persist"
        assert tfr.fused_ligru_fwd.launches == before + 3
        ref, ref_a = tfr.fused_ligru_fwd_plain(g, U, drop, None, act, qbits,
                                               True)
        ref_s = tfr.fused_ligru_fwd_plain(g, U, drop, h0, act, qbits)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = (tfr.fused_ligru_bwd_stash.launches,
                  tfr.fused_ligru_bwd.launches)
        dg_s = tfr.fused_ligru_bwd_stash(acts, U, drop, h_prev, dhs, act)
        dg_r = tfr.fused_ligru_bwd(g, U, drop, h_prev, dhs, act, qbits)
        assert tfr.ligru_bwd_route(B, H, cuda_device)[0] == "persist"
        assert (tfr.fused_ligru_bwd_stash.launches,
                tfr.fused_ligru_bwd.launches) == (
                    before[0] + T, before[1] + (4 if qbits else 2))
        ref_ds = tfr.fused_ligru_bwd_stash_plain(acts, U, drop, h_prev, dhs,
                                                 act)
        ref_dr = tfr.fused_ligru_bwd_plain(g, U, drop, h_prev, dhs, act,
                                           qbits)
    torch.cuda.synchronize()
    for a, b in ((hs, ref), (hs1, ref), (acts, ref_a), (hs_s, ref_s),
                 (dg_s, ref_ds), (dg_r, ref_dr)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=_atol(qbits))


def _wide_inputs(t, b, h, seed, act, dev):
    """Gates, U, drop and cotangents at width h: for relu the candidate's
    gate inputs at +-(4 + |N(0, 0.5)|) and U at 0.2/sqrt(h), so no
    pre-activation comes within an ulp of relu's kink (chip_smoke.py's
    gated_inputs)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(t, b, 2 * h) * 0.5
    u_scale = 1.0
    if act == "relu":
        sign = np.where(rng.rand(1, b, h) > 0.5, 1.0, -1.0)
        g[..., :h] = sign * (4.0 + np.abs(g[..., :h]))
        u_scale = 0.2
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return (d(g), d(rng.randn(2 * h, h) * u_scale / np.sqrt(h)),
            d(rng.rand(b, h) > 0.2), d(rng.randn(t, b, h) * 0.1))


def _bwd_case(t, b, h, seed, act, qbits, dev):
    g, U, drop, dhs = _wide_inputs(t, b, h, seed, act, dev)
    with torch.no_grad():
        hs = tfr.fused_ligru_fwd(g, U, drop, act=act, qbits=qbits)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    return g, U, drop, h_prev, dhs


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("shape", [(50, 8, 550), (300, 8, 1024),
                                   (9, 13, 100)],
                         ids=["h550", "timit", "b13"])
def test_cuda_bwd_persist_matches_twin(cuda_device, shape, act, qbits):
    """The recompute BPTT's persistent route (the rebuild's GEMM and one
    cooperative chain) against the twin at H=550, the TIMIT Li-GRU's
    training shape and a ragged 13 rows (8 units x 16 rows, 13 unit
    groups): 1e-4 of the twin's scale (its 300 reverse steps), two calls
    bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, h = shape
    route, plan = tfr.ligru_bwd_route(b, h, cuda_device)
    assert route == "persist" and plan.slabs == 1
    args = _bwd_case(t, b, h, 61, act, qbits, cuda_device) + (act, qbits)
    with torch.no_grad():
        before = tfr.fused_ligru_bwd.launches
        dg = tfr.fused_ligru_bwd(*args)
        assert tfr.fused_ligru_bwd.launches == before + (4 if qbits else 2)
        dg2 = tfr.fused_ligru_bwd(*args)
        ref = tfr.fused_ligru_bwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dg, dg2)
    scale = float(ref.abs().max())
    assert float((dg - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_bwd_step_route_matches_twin(cuda_device):
    """48 rows at H=1024 make 192 blocks of 16 units x 16 rows, one an SM:
    the per-step kernels (T launches), against the twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, h = 4, 48, 1024
    assert tfr.ligru_bwd_route(b, h, cuda_device)[0] == "step"
    args = _bwd_case(t, b, h, 63, "relu", 16, cuda_device) + ("relu", 16)
    with torch.no_grad():
        before = tfr.fused_ligru_bwd.launches
        dg = tfr.fused_ligru_bwd(*args)
        assert tfr.fused_ligru_bwd.launches == before + t
        ref = tfr.fused_ligru_bwd_plain(*args)
    torch.cuda.synchronize()
    assert float((dg - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_function_grads_match_cpu(cuda_device, monkeypatch, stash):
    """The autograd Function on the card (kernels) against the same call
    on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _set_stash(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(23)
    got = _torch_grads(g, U, drop, dhs, 16, "relu", dev=cuda_device)
    ref = _torch_grads(g, U, drop, dhs, 16, "relu")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL_DU_Q if name == "dU"
                                   else ATOL, err_msg=name)


def _fwd_cases(g, U, drop, h0, call, twin=True):
    """``call(h0, act, qbits, stash)`` over qbits 0/16 x relu/tanh x zero
    or seeded carry x stash or not: two calls bit for bit, and with
    ``twin`` against the twin (atol 1e-5, 1e-4 with 16 bits: a one-ulp
    difference at a ceil step is one step). -> {case: outputs}."""
    out = {}
    for qbits in (0, 16):
        for act in ("relu", "tanh"):
            for seed in (None, h0):
                for stash in (False, True):
                    case = (qbits, act, seed is not None, stash)
                    with torch.no_grad():
                        got, again = (call(seed, act, qbits, stash)
                                      for _ in range(2))
                        got, again = ((x,) if not stash else x
                                      for x in (got, again))
                        for a, b in zip(got, again):
                            assert torch.equal(a, b), case
                        if twin:
                            ref = tfr.fused_ligru_fwd_plain(
                                g, U, drop, seed, act, qbits, stash)
                            for a, r in zip(got, ref if stash else (ref,)):
                                np.testing.assert_allclose(
                                    a.cpu().numpy(), r.cpu().numpy(),
                                    atol=1e-4 if qbits else 1e-5,
                                    err_msg=str(case))
                    out[case] = got
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.LIGRU_FWD_SHAPES)
def test_cuda_fwd_persist_every_block_shape_gives_the_step_bits(cuda_device,
                                                                shape):
    """The persistent forward forced to each instantiated block shape at a
    ragged width (H=37: the last unit group masked, the exchange rows
    padded to 40 floats) and batch (8 bi + 3 rows), with and without the
    seed, the stash and the quantizer: against the twin, and equal to the
    step route bit for bit (the dots in the step kernel's order, q() with
    quant()'s bits); one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    t, b, h = 7, 8 * bi + 3, 37
    g, U, drop, dhs = _wide_inputs(t, b, h, 71 + bi + un, "tanh", cuda_device)
    h0 = dhs[0] * 3.0
    plan = tfr.ligru_fwd_plan(b, h, shape)
    before = tfr.fused_ligru_fwd.launches
    got = _fwd_cases(g, U, drop, h0, lambda s, a, q, st:
                     tfr._ligru_fwd_persist(plan, g, U, drop, s, a, q, st))
    assert tfr.fused_ligru_fwd.launches == before + 2 * len(got)
    want = _fwd_cases(g, U, drop, h0, lambda s, a, q, st:
                      tfr._ligru_fwd_step(g, U, drop, s, a, q, st), False)
    for case, outs in got.items():
        for a, w in zip(outs, want[case]):
            assert torch.equal(a, w), case


@pytest.mark.cuda
def test_cuda_fwd_routes(cuda_device):
    """The wrapper on the route its plan names: persistent at the TIMIT
    Li-GRU's 8 rows of 1024 (1 launch a call), the step route at 48 rows
    (256 blocks of 8 units x 32 rows, one an SM: T launches), both
    against the twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for (t, b, h), route, n in (((12, 8, 1024), "persist", 1),
                                ((4, 48, 1024), "step", 4)):
        g, U, drop, dhs = _wide_inputs(t, b, h, 73, "relu", cuda_device)
        assert tfr.ligru_fwd_route(b, h, cuda_device)[0] == route
        assert tfr.ligru_fwd_launches(route, t) == n
        with torch.no_grad():
            before = tfr.fused_ligru_fwd.launches
            hs, acts = tfr.fused_ligru_fwd(g, U, drop, dhs[0], act="relu",
                                           qbits=16, stash=True)
            assert tfr.fused_ligru_fwd.launches == before + n
            ref = tfr.fused_ligru_fwd_plain(g, U, drop, dhs[0], "relu", 16,
                                            True)
        torch.cuda.synchronize()
        for a, r in zip((hs, acts), ref):
            np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(),
                                       atol=1e-4)
