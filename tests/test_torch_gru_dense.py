"""The port's dense fused GRU (pytorch_kaldi_cgs_tpu_torch: the dense GRU
part of ops/fused_rnn.py, models/recurrent.py GRU without a sparse
layout, and streaming) against the JAX package on the same numpy inputs,
the Pallas kernels run in interpret mode.

- The three kernels' plain twins (forward: plain, stash, seeded; the
  stash and recompute BPTT) against ``_build_gru_fwd``,
  ``_build_gru_bwd_stash`` and ``_build_gru_bwd``, for tanh and relu
  with qbits 0/8/16 at a ragged shape (B=3, H=18).
- ``gru_scan_fused`` (the autograd Function) against ``jax.vjp`` of the
  JAX ``gru_scan_fused`` under the stash (the default in both) and the
  recompute backward, and against autograd through the ``gru_cell``
  loop.
- ``GRU.init(seed)`` array for array; a narrow 4-layer TIMIT-shaped GRU
  (the TIMIT cfg's tanh, BN on all three gates, no HCGS) against JAX
  ``apply`` with ``gru_fused_scan=True`` in eval (f32, bf16) and train
  mode (BN, dropout from the same masks in both), gradients against
  ``jax.grad``; one bf16 layer at H=1024 on both packages' fused kernels;
  streaming; variables through ``convert``; 3 train steps of a narrow
  TIMIT GRU chunk config against the JAX runner.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's); with a
16-bit quantizer 1e-4: a one-ulp difference at a ceil step becomes one
step, max|h|/2^15, which the next steps' dots carry on (8 bits put the
steps ~256x further apart than an ulp of difference can reach, so 8-bit
cases keep 1e-5); dU with the quantizer 5e-5 (q(h) one level apart times
|dg|). The model's outputs 1e-4 (BN divides by sqrt(var) over 27 rows);
gradients 1e-4 of each one's scale. bf16: the GRU's fused recurrence
stays float32 in both packages, so the bf16 model is held to the float32
bar; only its x-projections round to bf16, in both alike.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_gru_dense.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5, 1e-4 with 16 bits).
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import GRU
from pytorch_kaldi_cgs_tpu_torch.models import recurrent as trec
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

T, B, H = 9, 3, 18
F_IN = 12
ATOL = 1e-5
ATOL_Q = 1e-4          # a 16-bit quantizer; the model's outputs
ATOL_DU_Q = 5e-5       # dU through the recurrent quantizer
tt = torch.from_numpy


@pytest.fixture
def jfr():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _inputs(seed, drop_bh=True, h=H):
    rng = np.random.RandomState(seed)
    g = (rng.randn(T, B, 3 * h) * 0.5).astype(np.float32)
    U = (rng.randn(3 * h, h) * 0.3).astype(np.float32)
    drop = ((rng.rand(B, h) > 0.2).astype(np.float32) if drop_bh
            else np.full((1, 1), 0.8, np.float32))
    h0 = (rng.randn(B, h) * 0.3).astype(np.float32)
    dhs = rng.randn(T, B, h).astype(np.float32)
    return g, U, drop, h0, dhs


def _np(x):
    return np.asarray(x, np.float32)


def _atol(qbits):
    return ATOL_Q if qbits == 16 else ATOL


def _h_prev(hs, h0=None):
    first = np.zeros_like(hs[:1]) if h0 is None else h0[None]
    return np.concatenate([first, hs[:-1]])


# ---------------------------------------------------------------------------
# twins vs the Pallas kernels (_build_gru_fwd, _build_gru_bwd_stash,
# _build_gru_bwd)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "stash", "seeded"])
@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_fwd_twin_matches_pallas(jfr, act, qbits, variant):
    import jax.numpy as jnp
    g, U, drop, h0, _ = _inputs(3, drop_bh=variant != "seeded")
    seeded, stash = variant == "seeded", variant == "stash"
    fwd = jfr._build_gru_fwd(T, B, H, act, qbits, True, with_init=seeded,
                             stash=stash)
    j = jnp.asarray
    ref = fwd(j(g), j(U), j(np.broadcast_to(drop, (B, H))),
              *((j(h0),) if seeded else ()))
    got = tfr.fused_gru_fwd(tt(g), tt(U), tt(drop),
                            tt(h0) if seeded else None, act=act, qbits=qbits,
                            stash=stash)
    got, ref = (got, ref) if stash else ((got,), (ref,))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=_atol(qbits))
    if seeded:   # the streaming entry: (hs, h_T), seeded from h0
        hs, _ = jfr.gru_scan_fused_stream(j(g), j(U), j(drop), j(h0),
                                          act=act, quant_bits=qbits,
                                          interpret=True)
        ths, thT = tfr.gru_scan_fused_stream(tt(g), tt(U), tt(drop), tt(h0),
                                             act=act, quant_bits=qbits)
        np.testing.assert_allclose(ths.numpy(), _np(hs), atol=_atol(qbits))
        np.testing.assert_array_equal(thT.numpy(), ths[-1].numpy())


def _residuals(jfr, g, U, drop, act, qbits):
    """The JAX stash forward's acts and h_prev."""
    import jax.numpy as jnp
    hs, acts = jfr._build_gru_fwd(T, B, H, act, qbits, True, stash=True)(
        jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop))
    return np.array(acts), _h_prev(np.array(hs))


@pytest.mark.parametrize("act", ["tanh", "relu", "htanh", "linear"])
def test_bwd_stash_twin_matches_pallas(jfr, act):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(5)
    acts, h_prev = _residuals(jfr, g, U, drop, act, 0)
    j = jnp.asarray
    ref = jfr._build_gru_bwd_stash(T, B, H, act, True)(
        j(acts), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_gru_bwd_stash(tt(acts), tt(U), tt(drop), tt(h_prev),
                                  tt(dhs), act)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_bwd_recompute_twin_matches_pallas(jfr, act, qbits):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(7)
    _, h_prev = _residuals(jfr, g, U, drop, act, qbits)
    j = jnp.asarray
    ref = jfr._build_gru_bwd(T, B, H, act, qbits, True)(
        j(g), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_gru_bwd(tt(g), tt(U), tt(drop), tt(h_prev), tt(dhs), act,
                            qbits)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=_atol(qbits))


def test_wrappers_reject_bad_inputs():
    g, U, drop, h0, dhs = (tt(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="U must be"):
        tfr.fused_gru_fwd(g, U[:, :-1], drop)
    with pytest.raises(ValueError, match=r"\(T, B, 3H\)"):
        tfr.fused_gru_fwd(g[..., :-1], U, drop)
    with pytest.raises(ValueError, match="float32"):
        tfr.fused_gru_fwd(g.double(), U, drop)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_gru_fwd(g, U, drop, act="sigmoid")
    with pytest.raises(ValueError, match="h0 must be"):
        tfr.fused_gru_fwd(g, U, drop, h0=h0[:, :-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_gru_bwd(g, U, drop, dhs, dhs[:-1])
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_gru_fwd(g.requires_grad_(), U, drop)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _set_bwd(monkeypatch, stash):
    """The backward both packages take: the stash one by default (the
    JAX package's _STASH_DEFAULT["gru"]), recompute under
    PKC_LSTM_BWD_RECOMPUTE=1."""
    monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)
    if stash:
        monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    else:
        monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "1")


def _torch_grads(g, U, drop, dhs, qbits, act, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(U).requires_grad_()]
    hs = tfr.gru_scan_fused(leaves[0], leaves[1], d(drop), act=act,
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
    custom VJP, both packages on the same backward (the knobs set on
    both sides; the stash one is the default in both)."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    _set_bwd(monkeypatch, stash)
    assert tfr.bwd_stash_enabled("gru") == jfl._bwd_stash_enabled("gru") \
        == stash
    g, U, drop, _, dhs = _inputs(13, drop_bh)
    j = jnp.asarray
    hs, vjp = jax.vjp(lambda g_, U_: jfr.gru_scan_fused(
        g_, U_, j(drop), act="tanh", quant_bits=qbits, interpret=True),
        j(g), j(U))
    ref = [_np(hs)] + [_np(a) for a in vjp(j(dhs))]
    got = _torch_grads(g, U, drop, dhs, qbits, "tanh")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        atol = ATOL_DU_Q if (name == "dU" and qbits) else _atol(qbits)
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_equal_autograd_through_plain_loop(monkeypatch, stash,
                                                          qbits):
    """Independent of JAX: the Function's backward (BPTT twin + the two
    dU products) equals torch.autograd through the gru_cell loop with
    its straight-through quantizers."""
    _set_bwd(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(17)
    got = _torch_grads(g, U, drop, dhs, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(U).requires_grad_()]
    hs = tfr.fused_gru_fwd_plain(leaves[0], leaves[1], tt(drop), None,
                                 "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the model: the TIMIT GRU narrowed
# ---------------------------------------------------------------------------

TIMIT_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "TIMIT_baselines", "TIMIT_GRU_fmllr.cfg")
LAYERS = 4


def gru_opts(cdt="", lay=16, n=LAYERS, drop="0.2", hcgs=False,
             quant_inp=False):
    """The TIMIT GRU cfg's section narrowed to n x ``lay`` (tanh, BN on
    all three gates, no HCGS, no quantizers); ``hcgs`` puts a 128-block
    recurrent HCGS mask dropping half of each row's blocks (sparse
    layouts) and the 16-bit input quantizers (``quant_inp``) on it.
    ``gru_fused_scan=True`` takes the JAX fused kernels on the CPU."""
    src = configparser.ConfigParser()
    src.read(TIMIT_CFG)
    opts = dict(src["architecture1"])
    rep = lambda v: ",".join([v] * n)
    opts.update({
        "compute_dtype": cdt, "to_do": "forward", "gru_lay": rep(str(lay)),
        "gru_drop": rep(drop), "gru_fused_scan": "True", "scan_unroll": "1"})
    for k in ("gru_use_laynorm", "gru_use_batchnorm", "gru_act"):
        opts[k] = ",".join(opts[k].split(",")[:n])
    if hcgs:
        opts.update({"gru_hcgs": "True", "hcgsx_block": "4,2",
                     "hcgsx_sparse": "25,50", "hcgsh_block": "128,2",
                     "hcgsh_sparse": "50,50", "gru_quant": "True",
                     "param_quant": rep("8"),
                     "gru_quant_inp": str(quant_inp)})
    return opts


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


def _assert_tree_equal(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


def _port(opts, tree):
    return GRU(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port's calls into the dense fused GRU (whole utterance,
    stream) and the sparse one."""
    calls = {"fused": 0, "stream": 0, "sparse": 0}
    for name, key in (("gru_scan_fused", "fused"),
                      ("gru_scan_fused_stream", "stream"),
                      ("gru_scan_fused_sparse", "sparse")):
        real = getattr(tfr, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return calls


@pytest.mark.parametrize("hcgs", [False, True], ids=["timit", "hcgs"])
def test_init_equals_jax_init(jm, hcgs):
    """init(seed) with gru_orthinit=True gives the JAX package's arrays,
    and the variables cross both ways unchanged."""
    opts = gru_opts(hcgs=hcgs, lay=256 if hcgs else 16, n=2)
    assert opts["gru_orthinit"] == "True"
    for seed in (0, 7):
        port = GRU(opts, F_IN, seed=seed, device="cpu")
        jtree = jm.GRU(opts, F_IN).init(seed)
        _assert_tree_equal(convert.to_jax_variables(port.variables()), jtree)
        back = convert.to_jax_variables(convert.from_jax_variables(jtree))
        _assert_tree_equal(back, jtree)
        assert sorted(port._rec_layouts) == ([0, 1] if hcgs else [])


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_timit_gru_eval_matches_jax_fused(jm, fused_calls, cdt):
    """The narrow 4-layer TIMIT GRU against JAX apply on its fused Pallas
    recurrence; every layer takes gru_scan_fused. Under bf16 only the
    x-projections round to bf16 (the fused GRU is float32 in both)."""
    opts = gru_opts(cdt)
    jmod = jm.GRU(opts, F_IN)
    tree = _perturbed(jmod.init(0), 1)
    x = np.random.RandomState(2).randn(T, B, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(opts, tree).eval()(tt(x))
    assert fused_calls == {"fused": LAYERS, "stream": 0, "sparse": 0}
    assert y.shape == (T, B, 16)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


def _fixed_masks(monkeypatch, seed):
    """Both packages' recurrent dropout masks from one numpy stream, in
    layer order (the same draws on each side)."""
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.models import recurrent as jrec
    masks = []

    def mask(k, shape, rate):
        while len(masks) <= k:
            rng = np.random.RandomState(seed + len(masks))
            masks.append((rng.rand(*shape) >= rate).astype(np.float32))
        return masks[k]
    seen = {"jax": 0, "port": 0}

    def j_mask(rng, shape, rate, train):
        seen["jax"] += 1
        return jnp.asarray(mask(seen["jax"] - 1, shape, rate))

    def t_mask(shape, rate, train, device, generator=None):
        seen["port"] += 1
        return tt(mask(seen["port"] - 1, shape, rate)).to(device)
    monkeypatch.setattr(jrec, "shared_time_drop_mask", j_mask)
    monkeypatch.setattr(trec, "shared_time_drop_mask", t_mask)
    return masks


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_timit_gru_train_mode_and_grads_match_jax(jm, monkeypatch,
                                                  fused_calls, stash):
    """Train mode (batch statistics, dropout 0.2 from the same masks in
    both packages): the output, the updated BN statistics and the
    gradient of every parameter against jax.grad, through the stash and
    the recompute backward."""
    import jax
    import jax.numpy as jnp
    _set_bwd(monkeypatch, stash)
    masks = _fixed_masks(monkeypatch, 40)
    opts = gru_opts()
    jmod = jm.GRU(opts, F_IN)
    tree = _perturbed(jmod.init(3), 4)
    x = np.random.RandomState(5).randn(T, B, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(T, B, 16).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(tree["params"])
    port = _port(opts, tree).train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    assert len(masks) == LAYERS and 0 < np.mean(masks[0]) < 1
    assert fused_calls["fused"] == LAYERS
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


def test_bf16_1024_layer_matches_jax_fused(jm, fused_calls):
    """ROADMAP Queue 3's bf16 caveat: under bf16 the JAX package counts U
    in bf16 for its VMEM rule, so a 1024-wide GRU layer takes its fused
    kernel (with U in float32) at small batch. Both packages run that
    layer on their fused recurrence in float32."""
    jfr = pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")
    assert jfr.fits_vmem(2, 1024, 3, "bf16") and \
        not jfr.fits_vmem(2, 1024, 3, "")
    opts = gru_opts("bf16", lay=1024, n=1)
    jmod = jm.GRU(opts, F_IN)
    tree = _perturbed(jmod.init(1), 2)
    x = np.random.RandomState(3).randn(3, 2, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(opts, tree).eval()(tt(x))
    assert fused_calls["fused"] == 1
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


CHUNKS = ((0, 4), (4, 5), (5, T))


@pytest.mark.parametrize("hcgs", [False, True], ids=["timit", "hcgs"])
def test_streaming_equals_whole_utterance_and_jax(jm, fused_calls, hcgs):
    """Three chunks with the h carry seeding the fused forward reproduce
    the whole-utterance eval output, and match the JAX package's
    streaming (its seeded Pallas forward). The unidirectional HCGS GRU
    (both layers with sparse layouts) runs its whole utterance on the
    sparse kernels and streams on the dense seeded forward over the
    masked U, as the JAX package does."""
    opts = gru_opts(hcgs=hcgs, lay=256 if hcgs else 16, n=2)
    jmod = jm.GRU(opts, F_IN)
    tree = _perturbed(jmod.init(2), 3)
    if hcgs:
        jmod.prepare_block_sparse(tree)
    x = np.random.RandomState(8).randn(T, B, F_IN).astype(np.float32)
    port = _port(opts, tree).eval()
    assert sorted(port._rec_layouts) == ([0, 1] if hcgs else [])
    xt = tt(x)
    with torch.no_grad():
        full = port(xt)
        carries, got = None, []
        for a, b in CHUNKS:
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert fused_calls == {"fused": 0 if hcgs else 2, "stream": 6,
                           "sparse": 2 if hcgs else 0}
    assert len(carries) == 2 and tuple(carries[0].shape) == (B, full.shape[2])
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=1e-5)
    jc, jgot = None, []
    for a, b in CHUNKS:
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL_Q)


# ---------------------------------------------------------------------------
# 3 train steps of a narrow TIMIT GRU chunk config against the JAX runner
# ---------------------------------------------------------------------------

N_CD, ST_T, ST_B, SEED, STEPS = 40, 12, 4, 3, 3


def timit_chunk_config(lay=16):
    """The TIMIT GRU cfg's [architecture1..2] and [model] (RNN_layers ->
    MLP_cd, cost_nll on lab_cd), the GRU narrowed to 4 x ``lay`` with
    dropout 0, the head to N_CD classes, over an in-memory chunk."""
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
    cc["architecture1"].update({
        "gru_lay": ",".join([str(lay)] * LAYERS),
        "gru_drop": ",".join(["0.0"] * LAYERS), "gru_fused_scan": "True"})
    cc["architecture2"]["dnn_lay"] = str(N_CD)
    for sec in ("architecture1", "architecture2"):
        # RMSprop's first step is lr * g / (sqrt(1 - alpha) |g| + eps): at
        # eps 1e-8 a gradient that cancels to float32 noise becomes a step
        # of lr * noise / eps, different in each package (as in
        # tests/test_torch_ligru.py); eps 1e-6 keeps that below 1e-6
        cc[sec]["opt_eps"] = "1e-6"
    return cc


def _chunks():
    """The same in-memory chunk for both packages: x ~ N(0, 1) of width
    F_IN and cd labels."""
    from pytorch_kaldi_cgs_tpu.data import dataset as jdata
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    rng = np.random.RandomState(0)
    x = rng.randn(ST_T, ST_B, F_IN).astype(np.float32)
    cd = rng.randint(0, N_CD, (ST_T, ST_B))
    data = np.concatenate([np.concatenate([x[:, b], cd[:, b, None]], 1)
                           for b in range(ST_B)]).astype(np.float32)
    ends = np.cumsum([ST_T] * ST_B)
    names = ["u%d" % b for b in range(ST_B)]
    return [mod.ChunkData(
        names, data, ends,
        {"fmllr": mod.FeaStream("fmllr", "none", col_start=0, col_end=F_IN)},
        {"lab_cd": mod.LabStream("lab_cd", "none", col=F_IN)})
        for mod in (jdata, tdata)]


def test_convert_round_trip_of_runner_variables(jm):
    """A JAX graph's variables (the narrow TIMIT GRU and its head) load
    into the port's nets and come back equal."""
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cc = timit_chunk_config()
    jchunk, pchunk = _chunks()
    jv = JG.NetGraph(cc, jchunk).init_variables(SEED)
    tg = tgraph.NetGraph(cc, pchunk, seed=0, device="cpu")
    for arch, tree in jv.items():
        tg.nets[arch].load_variables(convert.from_jax_variables(tree))
    assert type(tg.nets["RNN_layers"]) is GRU
    for arch in jv:
        _assert_tree_equal(tg.jax_variables()[arch], jv[arch])


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_timit_train_steps_match_jax(jm, monkeypatch, fused_calls, stash):
    """Per-step loss and err to 1e-5 over 3 steps of the narrow TIMIT GRU
    net, every layer on the fused kernels (the JAX runner's under
    gru_fused_scan=True), and every parameter and BN statistic within
    1e-4 of the JAX runner's after the 3 steps."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    _set_bwd(monkeypatch, stash)
    cc = timit_chunk_config()
    jchunk, pchunk = _chunks()
    jg = JG.NetGraph(cc, jchunk)
    jr = JC.ChunkRunner(jg, cc)
    jv = jg.init_variables(SEED)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    assert type(tg.nets["RNN_layers"]) is GRU
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, ST_B, True, np.random.RandomState(SEED), bucket=ST_T))
    jres, tres = [], []
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
    assert fused_calls["fused"] == LAYERS * STEPS
    np.testing.assert_allclose(tres, jres, atol=1e-5)
    assert tres[-1][0] < tres[0][0]
    ref, got = jax.device_get(jv), tg.jax_variables()
    for arch in ref:
        for coll in ("params", "state"):
            fa = convert.flatten(ref[arch][coll])
            fb = convert.flatten(got[arch][coll])
            for key in fa:
                np.testing.assert_allclose(fb[key], _np(fa[key]), atol=1e-4,
                                           err_msg="%s/%s" % (arch, key))


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
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_cuda_kernels_match_plain_twins(cuda_device, act, qbits):
    """The forward (plain, stash, seeded; on its route, with the route's
    launches) and both BPTT kernels (the stash one on its route, with its
    launches; 2T + 2 for the recompute one) against their twins on the
    card, on the same tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, dhs = (tt(a).to(cuda_device) for a in _inputs(19))
    with torch.no_grad():
        before = tfr.fused_gru_fwd.launches
        hs, acts = tfr.fused_gru_fwd(g, U, drop, act=act, qbits=qbits,
                                     stash=True)
        hs1 = tfr.fused_gru_fwd(g, U, drop, act=act, qbits=qbits)
        hs_s = tfr.fused_gru_fwd(g, U, drop, h0, act=act, qbits=qbits)
        route = tfr.gru_fwd_route(B, H, 3, cuda_device)[0]
        assert tfr.fused_gru_fwd.launches == before + sum(
            tfr.gru_fwd_launches(route, T, seeded, qbits)
            for seeded in (False, False, True))
        ref, ref_a = tfr.fused_gru_fwd_plain(g, U, drop, None, act, qbits,
                                             True)
        ref_s = tfr.fused_gru_fwd_plain(g, U, drop, h0, act, qbits)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = (tfr.fused_gru_bwd_stash.launches, tfr.fused_gru_bwd.launches)
        dg_s = tfr.fused_gru_bwd_stash(acts, U, drop, h_prev, dhs, act)
        dg_r = tfr.fused_gru_bwd(g, U, drop, h_prev, dhs, act, qbits)
        bwd_route = tfr.gru_bwd_stash_route(B, H, cuda_device)[0]
        assert (tfr.fused_gru_bwd_stash.launches,
                tfr.fused_gru_bwd.launches) == (
                    before[0] + tfr.gru_bwd_stash_launches(bwd_route, T),
                    before[1] + 2 * T + 2)
        ref_ds = tfr.fused_gru_bwd_stash_plain(acts, U, drop, h_prev, dhs,
                                               act)
        ref_dr = tfr.fused_gru_bwd_plain(g, U, drop, h_prev, dhs, act, qbits)
    torch.cuda.synchronize()
    for a, b in ((hs, ref), (hs1, ref), (acts, ref_a), (hs_s, ref_s),
                 (dg_s, ref_ds), (dg_r, ref_dr)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=_atol(qbits))


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_function_grads_match_cpu(cuda_device, monkeypatch, stash):
    """The autograd Function on the card (kernels, dU by cuBLAS) against
    the same call on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _set_bwd(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(23)
    got = _torch_grads(g, U, drop, dhs, 16, "tanh", dev=cuda_device)
    ref = _torch_grads(g, U, drop, dhs, 16, "tanh")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL_DU_Q if name == "dU"
                                   else ATOL_Q, err_msg=name)


@pytest.mark.cuda
def test_cuda_wide_layer_matches_twin(cuda_device):
    """H=1024 (the bf16-caveat width, 12.6 MB of U, 64 KB of staged
    cotangents per block) at B=11: the forward and both BPTT kernels
    against their twins over a few steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(29)
    Tw, Bw, Hw = 4, 11, 1024
    d = lambda a: torch.tensor(a.astype(np.float32), device=cuda_device)
    g, U = d(rng.randn(Tw, Bw, 3 * Hw) * 0.5), d(rng.randn(3 * Hw, Hw) * 0.03)
    drop, dhs = d(rng.rand(Bw, Hw) > 0.2), d(rng.randn(Tw, Bw, Hw))
    with torch.no_grad():
        hs, acts = tfr.fused_gru_fwd(g, U, drop, qbits=16, stash=True)
        ref, ref_a = tfr.fused_gru_fwd_plain(g, U, drop, None, "tanh", 16,
                                             True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        pairs = [(hs, ref), (acts, ref_a),
                 (tfr.fused_gru_bwd_stash(acts, U, drop, h_prev, dhs),
                  tfr.fused_gru_bwd_stash_plain(acts, U, drop, h_prev, dhs)),
                 (tfr.fused_gru_bwd(g, U, drop, h_prev, dhs, qbits=16),
                  tfr.fused_gru_bwd_plain(g, U, drop, h_prev, dhs,
                                          qbits=16))]
    torch.cuda.synchronize()
    for a, b in pairs:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=ATOL_Q)


def _stash_bwd_inputs(T_, B_, H_, seed, dev, act="tanh"):
    """The stash forward's outputs and a cotangent at (T_, B_, H_) on the
    card: (acts, U, drop, h_prev, dhs)."""
    rng = np.random.RandomState(seed)
    d = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    g = d(rng.randn(T_, B_, 3 * H_) * 0.5)
    U = d(rng.randn(3 * H_, H_) * 0.3 * np.sqrt(18.0 / H_))
    drop, dhs = d(rng.rand(B_, H_) > 0.2), d(rng.randn(T_, B_, H_))
    with torch.no_grad():
        hs, acts = tfr.fused_gru_fwd(g, U, drop, act=act, stash=True)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    return acts, U, drop, h_prev, dhs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.GRU_BWD_SHAPES)
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_cuda_bwd_stash_persist_every_block_shape(cuda_device, act, shape):
    """The stash BPTT's persistent chain (TPU row 20) forced to each
    instantiated block shape at a ragged width (H=37: the last unit group
    masked, the exchange rows padded) and batch (8 bi + 3 rows: a ragged
    last block of rows), against the twin; two calls bit for bit, one
    launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    T_, B_, H_ = 7, 8 * bi + 3, 37
    acts, U, drop, h_prev, dhs = _stash_bwd_inputs(T_, B_, H_,
                                                   61 + 2 * un + bi,
                                                   cuda_device, act)
    plan = tfr.gru_bwd_stash_plan(B_, H_, shape)
    before = tfr.fused_gru_bwd_stash.launches
    with torch.no_grad():
        got = tfr._gru_bwd_stash_persist(plan, acts, U, drop, h_prev, dhs,
                                         act)
        again = tfr._gru_bwd_stash_persist(plan, acts, U, drop, h_prev, dhs,
                                           act)
        ref = tfr.fused_gru_bwd_stash_plain(acts, U, drop, h_prev, dhs, act)
    assert tfr.fused_gru_bwd_stash.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=ATOL * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B_, H_", [(8, 550), (11, 37), (16, 1024)])
def test_cuda_bwd_stash_routes(cuda_device, B_, H_):
    """The wrapper on the route its plan names (persistent at 8 rows of
    550, 69 blocks of 8 units, and at 11 rows of 37; the step route at 16
    rows of 1024, whose staged rows do not fit beside the weights) and the
    step route forced, each against the twin with its route's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T_ = 12
    acts, U, drop, h_prev, dhs = _stash_bwd_inputs(T_, B_, H_, 71 + B_,
                                                   cuda_device)
    route, plan = tfr.gru_bwd_stash_route(B_, H_, cuda_device)
    assert route == ("step" if H_ == 1024 else "persist")
    if (B_, H_) == (8, 550):
        assert (plan.bi, plan.units, plan.grid) == (1, 8, 69)
    w = tfr.fused_gru_bwd_stash
    with torch.no_grad():
        ref = tfr.fused_gru_bwd_stash_plain(acts, U, drop, h_prev, dhs)
        before = w.launches
        got = w(acts, U, drop, h_prev, dhs)
        assert w.launches == before + tfr.gru_bwd_stash_launches(route, T_)
        before = w.launches
        step = tfr._gru_bwd_step(w, "fused_gru_bwd", 3, acts, U, drop,
                                 h_prev, dhs, "tanh", 0, True)
        assert w.launches == before + tfr.gru_bwd_stash_launches("step", T_)
    scale = float(ref.abs().max())
    for a in (got, step):
        np.testing.assert_allclose(a.cpu().numpy(), ref.cpu().numpy(),
                                   atol=ATOL * scale)
