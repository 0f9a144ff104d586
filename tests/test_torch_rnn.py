"""The port's vanilla RNN and its cuDNN-class wrappers
(pytorch_kaldi_cgs_tpu_torch: the RNN part of ops/fused_rnn.py,
models/recurrent.py RNN, LSTM_cudnn and RNN_cudnn, and streaming) against
the JAX package on the same numpy inputs, the Pallas kernels run in
interpret mode.

- The three kernels' plain twins (forward: plain, stash, seeded; the
  stash and recompute BPTT) against ``_build_rnn_fwd``,
  ``_build_rnn_bwd_stash`` and ``_build_rnn_bwd``, for tanh and relu
  (and htanh, linear for the stash BPTT) with qbits 0/8/16 at a ragged
  shape (B=3, H=18).
- ``rnn_scan_fused`` (the autograd Function) against ``jax.vjp`` of the
  JAX ``rnn_scan_fused`` under the recompute backward (the default in
  both) and the stash one, with a (B, H) mask and the eval scalar, and
  against autograd through the ``rnn_cell`` loop.
- ``RNN.init(seed)`` array for array; a narrow 4-layer TIMIT-shaped RNN
  (the TIMIT cfg's relu, BN on the projection, no HCGS) against JAX
  ``apply`` with ``rnn_fused_scan=True`` in eval (f32, bf16) and train
  mode (BN, dropout from the same masks in both), gradients against
  ``jax.grad``; streaming (fused, and the plain loop under layer norm);
  the sparse layout's raise, and the dense fallback where the JAX size
  rule says ""; variables through ``convert``; 3 train steps of a narrow
  TIMIT RNN chunk config against the JAX runner.
- ``LSTM_cudnn`` and ``RNN_cudnn`` (2 layers, bidirectional) against the
  JAX classes with ``fused_scan=True``: ``init``, eval, gradients in
  train mode (dropout 0: the JAX package draws its inter-layer mask from
  ``jax.random``), and unidirectional streaming; the registry
  (``GRU_cudnn`` has its own tests/test_torch_gru_cudnn.py).

Tolerances: float32 atol 1e-5 (sums in another order than XLA's); with a
16-bit quantizer 1e-4: a one-ulp difference at a ceil step becomes one
step, max|h|/2^15, which the next steps' dots carry on (8 bits put the
steps ~256x further apart than an ulp of difference can reach, so 8-bit
cases keep 1e-5); dU with the quantizer one level, max|h|/2^15, times
max|dg| (an element of q(h) one level apart; relu's h is not bounded by
1, so this exceeds the tanh cells' 5e-5). The model's outputs 1e-4 (BN
divides by sqrt(var) over 27 rows); gradients 1e-4 of each one's scale.
bf16: the RNN's fused recurrence stays float32 in both packages, so the
bf16 model is held to the float32 bar; only its x-projections round to
bf16, in both alike.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_rnn.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5, 1e-4 with 16 bits).
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import (RNN, LSTM_cudnn, RNN_cudnn,
                                                get_model_class)
from pytorch_kaldi_cgs_tpu_torch.models import recurrent as trec
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
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


def _inputs(seed, drop_bh=True, h=H, t=T, b=B):
    rng = np.random.RandomState(seed)
    g = (rng.randn(t, b, h) * 0.5).astype(np.float32)
    U = (rng.randn(h, h) * 0.3).astype(np.float32)
    drop = ((rng.rand(b, h) > 0.2).astype(np.float32) if drop_bh
            else np.full((1, 1), 0.8, np.float32))
    h0 = (rng.randn(b, h) * 0.3).astype(np.float32)
    dhs = rng.randn(t, b, h).astype(np.float32)
    return g, U, drop, h0, dhs


def _np(x):
    return np.asarray(x, np.float32)


def _atol(qbits):
    return ATOL_Q if qbits == 16 else ATOL


def _du_atol(ref):
    """dU's bar through the 16-bit quantizer: one level of the largest
    step scale, max|h|/2^15, times max|dg| (``ref`` = [hs, dg, dU]), and
    at least ATOL_DU_Q."""
    level = float(np.abs(ref[0]).max()) / 2 ** 15
    return max(ATOL_DU_Q, level * float(np.abs(ref[1]).max()))


def _h_prev(hs, h0=None):
    first = np.zeros_like(hs[:1]) if h0 is None else h0[None]
    return np.concatenate([first, hs[:-1]])


# ---------------------------------------------------------------------------
# twins vs the Pallas kernels (_build_rnn_fwd, _build_rnn_bwd_stash,
# _build_rnn_bwd)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "stash", "seeded"])
@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_fwd_twin_matches_pallas(jfr, act, qbits, variant):
    import jax.numpy as jnp
    g, U, drop, h0, _ = _inputs(3, drop_bh=variant != "seeded")
    seeded, stash = variant == "seeded", variant == "stash"
    fwd = jfr._build_rnn_fwd(T, B, H, act, qbits, True, with_init=seeded,
                             stash=stash)
    j = jnp.asarray
    ref = fwd(j(g), j(U), j(np.broadcast_to(drop, (B, H))),
              *((j(h0),) if seeded else ()))
    got = tfr.fused_rnn_fwd(tt(g), tt(U), tt(drop),
                            tt(h0) if seeded else None, act=act, qbits=qbits,
                            stash=stash)
    got, ref = (got, ref) if stash else ((got,), (ref,))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=_atol(qbits))
    if seeded:   # the streaming entry: (hs, h_T), seeded from h0
        hs, _ = jfr.rnn_scan_fused_stream(j(g), j(U), j(drop), j(h0),
                                          act=act, quant_bits=qbits,
                                          interpret=True)
        ths, thT = tfr.rnn_scan_fused_stream(tt(g), tt(U), tt(drop), tt(h0),
                                             act=act, quant_bits=qbits)
        np.testing.assert_allclose(ths.numpy(), _np(hs), atol=_atol(qbits))
        np.testing.assert_array_equal(thT.numpy(), ths[-1].numpy())


def test_stash_holds_activation_before_dropout():
    """The stash is a = act(...), not h = a * drop: where the mask drops
    a unit, h is 0 and a is not."""
    g, U, drop, _, _ = _inputs(4)
    hs, acts = tfr.fused_rnn_fwd(tt(g), tt(U), tt(drop), act="tanh",
                                 stash=True)
    np.testing.assert_array_equal(hs.numpy(), (acts * tt(drop)).numpy())
    dropped = np.broadcast_to(drop == 0, acts.shape)
    assert dropped.any() and np.all(acts.numpy()[dropped] != 0)


def _residuals(jfr, g, U, drop, act, qbits):
    """The JAX stash forward's acts and h_prev."""
    import jax.numpy as jnp
    hs, acts = jfr._build_rnn_fwd(T, B, H, act, qbits, True, stash=True)(
        jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop))
    return np.array(acts), _h_prev(np.array(hs))


@pytest.mark.parametrize("act", ["tanh", "relu", "htanh", "linear"])
def test_bwd_stash_twin_matches_pallas(jfr, act):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(5)
    acts, _ = _residuals(jfr, g, U, drop, act, 0)
    j = jnp.asarray
    ref = jfr._build_rnn_bwd_stash(T, B, H, act, True)(
        j(acts), j(U), j(drop), j(dhs))
    got = tfr.fused_rnn_bwd_stash(tt(acts), tt(U), tt(drop), tt(dhs), act)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize("qbits", [0, 8, 16])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_bwd_recompute_twin_matches_pallas(jfr, act, qbits):
    import jax.numpy as jnp
    g, U, drop, _, dhs = _inputs(7)
    _, h_prev = _residuals(jfr, g, U, drop, act, qbits)
    j = jnp.asarray
    ref = jfr._build_rnn_bwd(T, B, H, act, qbits, True)(
        j(g), j(U), j(drop), j(h_prev), j(dhs))
    got = tfr.fused_rnn_bwd(tt(g), tt(U), tt(drop), tt(h_prev), tt(dhs), act,
                            qbits)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=_atol(qbits))


def test_relu_derivative_at_zero_is_zero_in_both_backwards():
    """relu' is 1 only where the value is > 0 (the JAX ``_DACTS`` and
    ``_dact_from_pre``): a pre-activation of exactly 0 passes no
    gradient in the stash or the recompute backward."""
    g = torch.zeros(2, 1, 3)
    U, drop, dhs = torch.zeros(3, 3), torch.ones(1, 3), torch.ones(2, 1, 3)
    hs, acts = tfr.fused_rnn_fwd(g, U, drop, act="relu", stash=True)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    assert not acts.any()
    for dg in (tfr.fused_rnn_bwd_stash(acts, U, drop, dhs, "relu"),
               tfr.fused_rnn_bwd(g, U, drop, h_prev, dhs, "relu")):
        assert not dg.any()


def test_wrappers_reject_bad_inputs():
    g, U, drop, h0, dhs = (tt(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="U must be"):
        tfr.fused_rnn_fwd(g, U[:, :-1], drop)
    with pytest.raises(ValueError, match="float32"):
        tfr.fused_rnn_fwd(g.double(), U, drop)
    with pytest.raises(ValueError, match="activation"):
        tfr.fused_rnn_fwd(g, U, drop, act="sigmoid")
    with pytest.raises(ValueError, match="h0 must be"):
        tfr.fused_rnn_fwd(g, U, drop, h0=h0[:, :-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_rnn_bwd(g, U, drop, dhs, dhs[:-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_rnn_bwd_stash(g, U, drop, dhs[:-1])
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_rnn_fwd(g.requires_grad_(), U, drop)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _set_bwd(monkeypatch, stash):
    """The backward both packages take: the recompute one by default (the
    JAX package's _STASH_DEFAULT["rnn"] = False), the stash one under
    PKC_BWD_STASH_CELLS=rnn."""
    monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    if stash:
        monkeypatch.setenv("PKC_BWD_STASH_CELLS", "rnn")
    else:
        monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)


def _torch_grads(g, U, drop, dhs, qbits, act, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(U).requires_grad_()]
    hs = tfr.rnn_scan_fused(leaves[0], leaves[1], d(drop), act=act,
                            quant_bits=qbits)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_function_grads_match_jax_vjp(jfr, monkeypatch, stash, qbits,
                                      drop_bh):
    """hs, dgates and dU of the Function against jax.vjp of the JAX
    custom VJP, both packages on the same backward (the knobs set on
    both sides; the recompute one is the default in both)."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    _set_bwd(monkeypatch, stash)
    assert tfl.bwd_stash_enabled("rnn") == jfl._bwd_stash_enabled("rnn") \
        == stash
    g, U, drop, _, dhs = _inputs(13, drop_bh)
    j = jnp.asarray
    hs, vjp = jax.vjp(lambda g_, U_: jfr.rnn_scan_fused(
        g_, U_, j(drop), act="relu", quant_bits=qbits, interpret=True),
        j(g), j(U))
    ref = [_np(hs)] + [_np(a) for a in vjp(j(dhs))]
    got = _torch_grads(g, U, drop, dhs, qbits, "relu")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        atol = _du_atol(ref) if (name == "dU" and qbits) else _atol(qbits)
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_function_grads_equal_autograd_through_plain_loop(monkeypatch, stash,
                                                          qbits):
    """Independent of JAX: the Function's backward (BPTT twin + the dU
    product) equals torch.autograd through the rnn_cell loop with its
    straight-through quantizer."""
    _set_bwd(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(17)
    got = _torch_grads(g, U, drop, dhs, qbits, "tanh")
    leaves = [tt(g).requires_grad_(), tt(U).requires_grad_()]
    hs = tfr.fused_rnn_fwd_plain(leaves[0], leaves[1], tt(drop), None,
                                 "tanh", qbits)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the model: the TIMIT RNN narrowed
# ---------------------------------------------------------------------------

TIMIT_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                         "TIMIT_baselines", "TIMIT_RNN_fmllr.cfg")
LAYERS = 4


def rnn_opts(cdt="", lay=16, n=LAYERS, drop="0.2", hcgs=False,
             laynorm=False):
    """The TIMIT RNN cfg's section narrowed to n x ``lay`` (relu, BN on
    the projection, no HCGS, no quantizers); ``hcgs`` puts a 128-block
    recurrent HCGS mask dropping half of each row's blocks (a sparse
    layout) on it; ``laynorm`` in-scan layer norm instead of BN (the
    plain step loop). ``rnn_fused_scan=True`` takes the JAX fused kernels
    on the CPU."""
    src = configparser.ConfigParser()
    src.read(TIMIT_CFG)
    opts = dict(src["architecture1"])
    rep = lambda v: ",".join([v] * n)
    opts.update({
        "compute_dtype": cdt, "to_do": "forward", "rnn_lay": rep(str(lay)),
        "rnn_drop": rep(drop), "rnn_fused_scan": "True", "scan_unroll": "1"})
    for k in ("rnn_use_laynorm", "rnn_use_batchnorm", "rnn_act"):
        opts[k] = ",".join(opts[k].split(",")[:n])
    if laynorm:
        opts.update({"rnn_use_laynorm": rep("True"),
                     "rnn_use_batchnorm": rep("False")})
    if hcgs:
        opts.update({"rnn_hcgs": "True", "hcgsx_block": "4,2",
                     "hcgsx_sparse": "25,50", "hcgsh_block": "128,2",
                     "hcgsh_sparse": "50,50"})
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


def _port(cls, opts, tree):
    return cls(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port's calls into the fused RNN (whole utterance,
    stream) and the fused LSTM (whole utterance, stream)."""
    calls = {"fused": 0, "stream": 0, "lstm": 0, "lstm_stream": 0}
    for mod, name, key in ((tfr, "rnn_scan_fused", "fused"),
                           (tfr, "rnn_scan_fused_stream", "stream"),
                           (tfl, "lstm_scan_fused", "lstm"),
                           (tfl, "lstm_scan_fused_stream", "lstm_stream")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("hcgs", [False, True], ids=["timit", "hcgs"])
def test_init_equals_jax_init(jm, hcgs):
    """init(seed) with rnn_orthinit=True gives the JAX package's arrays,
    and the variables cross both ways unchanged."""
    opts = rnn_opts(hcgs=hcgs, lay=256 if hcgs else 16, n=2)
    assert opts["rnn_orthinit"] == "True"
    for seed in (0, 7):
        port = RNN(opts, F_IN, seed=seed, device="cpu")
        jtree = jm.RNN(opts, F_IN).init(seed)
        _assert_tree_equal(convert.to_jax_variables(port.variables()), jtree)
        back = convert.to_jax_variables(convert.from_jax_variables(jtree))
        _assert_tree_equal(back, jtree)
        assert sorted(port._rec_layouts) == ([0, 1] if hcgs else [])


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_timit_rnn_eval_matches_jax_fused(jm, fused_calls, cdt):
    """The narrow 4-layer TIMIT RNN against JAX apply on its fused Pallas
    recurrence; every layer takes rnn_scan_fused. At eval each step's h
    is scaled by the scalar 1 - p. Under bf16 only the x-projections
    round to bf16 (the fused RNN is float32 in both)."""
    opts = rnn_opts(cdt)
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(0), 1)
    x = np.random.RandomState(2).randn(T, B, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(RNN, opts, tree).eval()(tt(x))
    assert fused_calls["fused"] == LAYERS and fused_calls["stream"] == 0
    assert y.shape == (T, B, 16) and float(y.abs().max()) > 0.1
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


def _grads_match(jax, got_params, grads):
    ref_g = convert.flatten(jax.device_get(grads))
    got_g = {k: p.grad.numpy() for k, p in got_params.items()}
    assert sorted(ref_g) == sorted(got_g)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got_g[k], _np(v), atol=ATOL_Q * scale,
                                   err_msg=k)


@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_timit_rnn_train_mode_and_grads_match_jax(jm, monkeypatch,
                                                  fused_calls, stash):
    """Train mode (batch statistics, dropout 0.2 from the same masks in
    both packages): the output, the updated BN statistics and the
    gradient of every parameter against jax.grad, through the recompute
    and the stash backward."""
    import jax
    import jax.numpy as jnp
    _set_bwd(monkeypatch, stash)
    masks = _fixed_masks(monkeypatch, 40)
    opts = rnn_opts()
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(3), 4)
    x = np.random.RandomState(5).randn(T, B, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(T, B, 16).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(tree["params"])
    port = _port(RNN, opts, tree).train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    assert len(masks) == LAYERS and 0 < np.mean(masks[0]) < 1
    assert fused_calls["fused"] == LAYERS
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL_Q)
    got = convert.flatten(convert.to_jax_variables(port.variables())["state"])
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(got[k], _np(v), atol=1e-5, err_msg=k)
    _grads_match(jax, port.params, grads)


CHUNKS = ((0, 4), (4, 5), (5, T))


@pytest.mark.parametrize("laynorm", [False, True], ids=["fused", "laynorm"])
def test_streaming_equals_whole_utterance_and_jax(jm, fused_calls, laynorm):
    """Three chunks with the h carry seeding the fused forward reproduce
    the whole-utterance eval output, and match the JAX package's
    streaming (its seeded Pallas forward). Under in-scan layer norm both
    packages stream on their plain step loop."""
    opts = rnn_opts(n=2, laynorm=laynorm)
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(2), 3)
    x = np.random.RandomState(8).randn(T, B, F_IN).astype(np.float32)
    port = _port(RNN, opts, tree).eval()
    xt = tt(x)
    with torch.no_grad():
        full = port(xt)
        carries, got = None, []
        for a, b in CHUNKS:
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    want = (0, 0) if laynorm else (2, 6)
    assert (fused_calls["fused"], fused_calls["stream"]) == want
    assert len(carries) == 2 and tuple(carries[0].shape) == (B, 16)
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=1e-5)
    jc, jgot = None, []
    for a, b in CHUNKS:
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL_Q)


def test_sparse_layout_raises_where_jax_takes_its_sparse_kernels(jm,
                                                                 monkeypatch,
                                                                 fused_calls):
    """A 128-block recurrent HCGS mask dropping half of each row's blocks
    gives a sparse layout, and where the JAX size rule lets the layer
    onto its sparse RNN kernels (rows 36-37) the port, which raised here
    before they were ported, now runs both layers on its own sparse
    kernels (their twins here) and agrees with JAX ``apply`` on its
    sparse Pallas kernels; no dense RNN kernel runs."""
    seen = []
    real = tfr.fused_rnn_fwd_sparse_plain

    def spy(*a, **k):
        seen.append(a[3])
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_rnn_fwd_sparse_plain", spy)
    opts = rnn_opts(hcgs=True, lay=256, n=2)
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(0), 1)
    jmod.prepare_block_sparse(tree)
    assert sorted(jmod._rec_layouts) == [0, 1]
    x = np.random.RandomState(4).randn(4, 2, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    port = _port(RNN, opts, tree).eval()
    assert sorted(port._rec_layouts) == [0, 1]
    with torch.no_grad():
        y = port(tt(x))
    assert seen == [port._rec_layouts[0], port._rec_layouts[1]]
    assert fused_calls["fused"] == 0
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


def test_sparse_layout_runs_dense_where_jax_size_rule_says_no(
        jm, monkeypatch, fused_calls):
    """Where the JAX size rule keeps the layer off its sparse kernels
    (a budget of PKC_SPARSE_SCAN_VMEM_MB=0) the JAX package runs the
    dense fused recurrence over the masked U; the port stays on its
    sparse kernels with float32 w3g (the same math to float32 rounding),
    and the two agree."""
    monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "0")
    seen = []
    real = tfr.fused_rnn_fwd_sparse

    def spy(*a, **k):
        seen.append(a[6] if len(a) > 6 else k.get("bf16", False))
        return real(*a, **k)
    monkeypatch.setattr(tfr, "fused_rnn_fwd_sparse", spy)
    opts = rnn_opts(hcgs=True, lay=256, n=1)
    jmod = jm.RNN(opts, F_IN)
    tree = _perturbed(jmod.init(1), 2)
    jmod.prepare_block_sparse(tree)
    x = np.random.RandomState(3).randn(4, 2, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    port = _port(RNN, opts, tree).eval()
    assert sorted(port._rec_layouts) == [0]
    assert tfl.sparse_scan_fits(2, 256, port._rec_layouts[0], 1) == ""
    with torch.no_grad():
        y = port(tt(x))
    assert seen == [False] and fused_calls["fused"] == 0
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)


# ---------------------------------------------------------------------------
# the cuDNN-class wrappers: LSTM_cudnn and RNN_cudnn
# ---------------------------------------------------------------------------

CUDNN = {"lstm": (LSTM_cudnn, "LSTM_cudnn", {}),
         "rnn_relu": (RNN_cudnn, "RNN_cudnn", {"nonlinearity": "relu"}),
         "rnn_tanh": (RNN_cudnn, "RNN_cudnn", {"nonlinearity": "tanh"})}


def cudnn_opts(kind, bidir=True, drop="0.2", bias=True):
    """2 layers of 16, both directions, with inter-layer dropout;
    ``fused_scan=True`` takes the JAX fused kernels on the CPU."""
    return dict({"hidden_size": "16", "num_layers": "2",
                 "bidirectional": str(bidir), "dropout": drop,
                 "bias": str(bias), "fused_scan": "True", "to_do": "forward"},
                **CUDNN[kind][2])


def _cudnn_pair(jm, kind, seed, **kw):
    cls, name, _ = CUDNN[kind]
    opts = cudnn_opts(kind, **kw)
    jmod = getattr(jm, name)(opts, F_IN)
    tree = jmod.init(seed)
    return opts, jmod, tree, _port(cls, opts, tree)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("kind", ["lstm", "rnn_relu"])
def test_cudnn_init_equals_jax_init(jm, kind, bias):
    """init(seed) gives the JAX package's w_ih/w_hh/b_ih/b_hh of every
    layer and direction."""
    cls, name, _ = CUDNN[kind]
    opts = cudnn_opts(kind, bias=bias)
    port = cls(opts, F_IN, seed=5, device="cpu")
    jtree = getattr(jm, name)(opts, F_IN).init(5)
    _assert_tree_equal(convert.to_jax_variables(port.variables()), jtree)
    assert port.out_dim == 32 and ("b_hh_l1_r" in jtree["params"]) == bias


@pytest.mark.parametrize("kind", ["lstm", "rnn_relu", "rnn_tanh"])
def test_cudnn_eval_matches_jax(jm, fused_calls, kind):
    """Both directions of both layers on the fused kernels (b_hh folded,
    a mask of ones), against the JAX classes on theirs."""
    _, jmod, tree, port = _cudnn_pair(jm, kind, 1)
    x = np.random.RandomState(2).randn(T, B, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = port.eval()(tt(x))
    key = "lstm" if kind == "lstm" else "fused"
    assert fused_calls[key] == 4 and y.shape == (T, B, 32)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL)


@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
@pytest.mark.parametrize("kind", ["lstm", "rnn_relu"])
def test_cudnn_grads_match_jax(jm, monkeypatch, kind, stash):
    """Train mode without dropout: the gradient of every w_ih, w_hh,
    b_ih and b_hh against jax.grad, both packages on the same backward
    (the LSTM's stash one by default, the RNN's recompute one)."""
    import jax
    import jax.numpy as jnp
    monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)
    if kind == "lstm":
        monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    else:
        _set_bwd(monkeypatch, stash)
    _, jmod, tree, port = _cudnn_pair(jm, kind, 3, drop="0.0")
    x = np.random.RandomState(4).randn(T, B, F_IN).astype(np.float32)
    wy = np.random.RandomState(5).randn(T, B, 32).astype(np.float32)

    def loss(params):
        y, _ = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                          train=True)
        return jnp.sum(y * wy), y
    (_, y_ref), grads = jax.value_and_grad(loss, has_aux=True)(
        tree["params"])
    y = port.train()(tt(x))
    (y * tt(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL)
    _grads_match(jax, port.params, grads)


@pytest.mark.parametrize("kind", ["lstm", "rnn_relu"])
def test_cudnn_streaming_equals_whole_utterance_and_jax(jm, fused_calls,
                                                        kind):
    """Unidirectional: three chunks on the seeded kernels reproduce the
    whole utterance and the JAX package's stream (its seeded LSTM kernel;
    its RNN_cudnn streams on a seeded lax.scan, the same math). A
    bidirectional wrapper cannot stream."""
    _, jmod, tree, port = _cudnn_pair(jm, kind, 6, bidir=False)
    x = np.random.RandomState(7).randn(T, B, F_IN).astype(np.float32)
    xt = tt(x)
    with torch.no_grad():
        full = port.eval()(xt)
        carries, got = None, []
        for a, b in CHUNKS:
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    key = "lstm_stream" if kind == "lstm" else "stream"
    assert fused_calls[key] == 6 and len(carries) == 2
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)
    jc, jgot = None, []
    for a, b in CHUNKS:
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL)
    bidir = _cudnn_pair(jm, kind, 6)[3]
    with pytest.raises(ValueError, match="cannot stream"):
        bidir.apply_streaming(xt[:2])


def test_cudnn_train_dropout_is_inverted_and_seeded(monkeypatch):
    """The inter-layer dropout is inverted (kept units scaled by
    1/(1-p)) and drawn from the caller's generator: the same seed gives
    the same output; eval drops nothing."""
    port = RNN_cudnn(cudnn_opts("rnn_relu", drop="0.5"), F_IN, seed=0,
                     device="cpu")
    x = tt(np.random.RandomState(1).randn(T, B, F_IN).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(3)
    with torch.no_grad():
        a = port.run(x, train=True, generator=gen())
        b = port.run(x, train=True, generator=gen())
        c = port.run(x, train=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.allclose(a.numpy(), c.numpy())
    seen = []
    real = trec.dropout

    def spy(x_, rate, train, generator=None):
        out = real(x_, rate, train, generator)
        seen.append((x_, out))
        return out
    monkeypatch.setattr(trec, "dropout", spy)
    with torch.no_grad():
        port.run(x, train=True, generator=gen())
    (x1, y1), = seen
    kept = y1 != 0
    assert 0 < float(kept.float().mean()) < 1
    np.testing.assert_allclose(y1[kept].numpy(), (x1[kept] * 2).numpy(),
                               rtol=1e-6)


def test_model_registry():
    """The configs' names resolve, GRU_cudnn's and minimalGRU's too now
    that their kernels (rows 22-26, 34-35) are ported; a built-in class
    not ported yet raises."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU_cudnn, minimalGRU
    for lib in ("pytorch_kaldi_cgs_tpu.models",
                "pytorch_kaldi_cgs_tpu_torch.models"):
        assert get_model_class(lib, "RNN") is RNN
        assert get_model_class(lib, "LSTM_cudnn") is LSTM_cudnn
        assert get_model_class(lib, "RNN_cudnn") is RNN_cudnn
        assert get_model_class(lib, "GRU_cudnn") is GRU_cudnn
        assert get_model_class(lib, "minimalGRU") is minimalGRU
        with pytest.raises(NotImplementedError, match="SRU"):
            get_model_class(lib, "SRU")


# ---------------------------------------------------------------------------
# 3 train steps of a narrow TIMIT RNN chunk config against the JAX runner
# ---------------------------------------------------------------------------

N_CD, ST_T, ST_B, SEED, STEPS = 40, 12, 4, 3, 3


def timit_chunk_config(lay=16):
    """The TIMIT RNN cfg's [architecture1..2] and [model] (RNN_layers ->
    MLP_cd, cost_nll on lab_cd), the RNN narrowed to 4 x ``lay`` with
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
        "rnn_lay": ",".join([str(lay)] * LAYERS),
        "rnn_drop": ",".join(["0.0"] * LAYERS), "rnn_fused_scan": "True"})
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
    """A JAX graph's variables (the narrow TIMIT RNN and its head) load
    into the port's nets and come back equal; so do the cuDNN-class
    wrappers' flat trees."""
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cc = timit_chunk_config()
    jchunk, pchunk = _chunks()
    jv = JG.NetGraph(cc, jchunk).init_variables(SEED)
    tg = tgraph.NetGraph(cc, pchunk, seed=0, device="cpu")
    for arch, tree in jv.items():
        tg.nets[arch].load_variables(convert.from_jax_variables(tree))
    assert type(tg.nets["RNN_layers"]) is RNN
    for arch in jv:
        _assert_tree_equal(tg.jax_variables()[arch], jv[arch])
    for kind in ("lstm", "rnn_relu"):
        _, _, tree, port = _cudnn_pair(jm, kind, 2)
        _assert_tree_equal(convert.to_jax_variables(port.variables()), tree)


@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_timit_train_steps_match_jax(jm, monkeypatch, fused_calls, stash):
    """Per-step loss and err to 1e-5 over 3 steps of the narrow TIMIT RNN
    net, every layer on the fused kernels (the JAX runner's under
    rnn_fused_scan=True), and every parameter and BN statistic within
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
    assert type(tg.nets["RNN_layers"]) is RNN
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
    launches) and both BPTT kernels (T for the stash one, the recompute
    one's on its route: rnn_bwd_launches) against their twins on the card,
    on the same tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, dhs = (tt(a).to(cuda_device) for a in _inputs(19))
    with torch.no_grad():
        before = tfr.fused_rnn_fwd.launches
        hs, acts = tfr.fused_rnn_fwd(g, U, drop, act=act, qbits=qbits,
                                     stash=True)
        hs1 = tfr.fused_rnn_fwd(g, U, drop, act=act, qbits=qbits)
        hs_s = tfr.fused_rnn_fwd(g, U, drop, h0, act=act, qbits=qbits)
        route = tfr.rnn_fwd_route(B, H, cuda_device)[0]
        assert tfr.fused_rnn_fwd.launches == before + 3 * tfr.rnn_fwd_launches(
            route, T)
        ref, ref_a = tfr.fused_rnn_fwd_plain(g, U, drop, None, act, qbits,
                                             True)
        ref_s = tfr.fused_rnn_fwd_plain(g, U, drop, h0, act, qbits)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = (tfr.fused_rnn_bwd_stash.launches, tfr.fused_rnn_bwd.launches)
        dg_s = tfr.fused_rnn_bwd_stash(acts, U, drop, dhs, act)
        dg_r = tfr.fused_rnn_bwd(g, U, drop, h_prev, dhs, act, qbits)
        b_route = tfr.rnn_bwd_route(B, H, cuda_device)[0]
        assert (tfr.fused_rnn_bwd_stash.launches,
                tfr.fused_rnn_bwd.launches) == (
                    before[0] + T,
                    before[1] + tfr.rnn_bwd_launches(b_route, T, qbits))
        ref_ds = tfr.fused_rnn_bwd_stash_plain(acts, U, drop, dhs, act)
        ref_dr = tfr.fused_rnn_bwd_plain(g, U, drop, h_prev, dhs, act, qbits)
    torch.cuda.synchronize()
    for a, b in ((hs, ref), (hs1, ref), (acts, ref_a), (hs_s, ref_s),
                 (dg_s, ref_ds), (dg_r, ref_dr)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=_atol(qbits))


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_cuda_function_grads_match_cpu(cuda_device, monkeypatch, stash):
    """The autograd Function on the card (kernels, dU by cuBLAS) against
    the same call on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _set_bwd(monkeypatch, stash)
    g, U, drop, _, dhs = _inputs(23)
    got = _torch_grads(g, U, drop, dhs, 16, "relu", dev=cuda_device)
    ref = _torch_grads(g, U, drop, dhs, 16, "relu")
    for name, a, b in zip(["hs", "dgates", "dU"], got, ref):
        np.testing.assert_allclose(a, b, atol=_du_atol(ref) if name == "dU"
                                   else ATOL_Q, err_msg=name)


@pytest.mark.cuda
def test_cuda_wide_layer_matches_twin(cuda_device):
    """H=1024 (32 KB of staged rows per block) at B=11, the eval scalar
    mask: the forward and both BPTT kernels against their twins over a
    few steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(29)
    Tw, Bw, Hw = 4, 11, 1024
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    g, U = d(rng.randn(Tw, Bw, Hw) * 0.5), d(rng.randn(Hw, Hw) * 0.03)
    drop, dhs = d(np.full((1, 1), 0.8)), d(rng.randn(Tw, Bw, Hw))
    with torch.no_grad():
        hs, acts = tfr.fused_rnn_fwd(g, U, drop, qbits=16, stash=True)
        ref, ref_a = tfr.fused_rnn_fwd_plain(g, U, drop, None, "tanh", 16,
                                             True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        pairs = [(hs, ref), (acts, ref_a),
                 (tfr.fused_rnn_bwd_stash(acts, U, drop, dhs),
                  tfr.fused_rnn_bwd_stash_plain(acts, U, drop, dhs)),
                 (tfr.fused_rnn_bwd(g, U, drop, h_prev, dhs, qbits=16),
                  tfr.fused_rnn_bwd_plain(g, U, drop, h_prev, dhs,
                                          qbits=16))]
    torch.cuda.synchronize()
    for a, b in pairs:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=ATOL_Q)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lstm", "rnn_relu"])
def test_cuda_cudnn_wrappers_match_cpu(cuda_device, kind):
    """LSTM_cudnn and RNN_cudnn (2 layers, bidirectional) on the card
    against the same model on the CPU, in eval and their gradients in
    train mode (dropout from one CPU generator)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cls = CUDNN[kind][0]
    opts = cudnn_opts(kind)
    x = np.random.RandomState(31).randn(T, B, F_IN).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        port = cls(opts, F_IN, seed=4, device=dev)
        with torch.no_grad():
            y_eval = port.run(tt(x).to(dev), train=False)
        y = port.run(tt(x).to(dev), train=True,
                     generator=torch.Generator().manual_seed(0))
        y.square().sum().backward()
        out[dev.type] = [y_eval.cpu(), y.detach().cpu()] + [
            p.grad.cpu() for _, p in sorted(port.params.items())]
    for a, b in zip(out["cuda"], out["cpu"]):
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.RNN_FWD_SHAPES)
def test_cuda_fwd_persist_is_the_step_routes_bits(cuda_device, shape):
    """The forward's persistent route (TPU row 27) forced to each
    instantiated block shape at a ragged width (H=37: the last unit group
    masked, the exchange rows padded to 40 floats) and batch (8 bi + 3
    rows): bit for bit its forced step route, stash and not, zero and
    seeded, qbits 0 and 16, tanh and relu (each dot is one warp's in
    rnn_step's order, q() quant()'s bits), within the twin's bar (times
    the outputs' scale where it passes 1); one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    T_, B_, H_ = 7, 8 * bi + 3, 37
    g, U, drop, h0, _ = (tt(a).to(cuda_device) for a in _inputs(
        83 + 2 * un + bi, h=H_, t=T_, b=B_))
    U = U * float(np.sqrt(H / H_))      # the recurrent gain of H=18's U
    plan = tfr.rnn_fwd_plan(B_, H_, shape)
    with torch.no_grad():
        for qbits in (0, 16):
            for act in ("tanh", "relu"):
                for seed in (None, h0):
                    for stash in (False, True):
                        before = tfr.fused_rnn_fwd.launches
                        got = tfr._rnn_fwd_persist(plan, g, U, drop, seed, act,
                                                   qbits, stash)
                        assert tfr.fused_rnn_fwd.launches == before + 1
                        want = tfr._rnn_fwd_step(g, U, drop, seed, act, qbits,
                                                 stash)
                        ref = tfr.fused_rnn_fwd_plain(g.cpu(), U.cpu(),
                                                      drop.cpu(),
                                                      None if seed is None
                                                      else seed.cpu(), act,
                                                      qbits, stash)
                        got, want, ref = ((x,) if not stash else x
                                          for x in (got, want, ref))
                        for a, b, r in zip(got, want, ref):
                            assert torch.equal(a, b), (shape, qbits, act,
                                                       seed is not None,
                                                       stash)
                            # a 16-bit level is max|h| / 2^15: the bar
                            # scales with the outputs, which relu lets pass 1
                            np.testing.assert_allclose(
                                a.cpu().numpy(), r.numpy(),
                                atol=_atol(qbits) * max(
                                    1.0, float(r.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("T_, B_, H_, act, qbits, seeded", [
    (300, 8, 550, "relu", 0, False),     # the TIMIT RNN's train shape
    (300, 8, 550, "tanh", 0, False),
    (300, 8, 1024, "relu", 16, True),    # the CGS-16x RNN's dense stream
])
def test_cuda_fwd_persist_at_the_timit_shapes(cuda_device, T_, B_, H_, act,
                                              qbits, seeded):
    """At full width the wrapper takes the persistent route (one launch a
    call) and gives its forced step route's bits, with the stash; the
    stash holds a before the dropout; a call seeded from h_{s-1} gives the
    zero-state call's steps s..T-1 bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(H_ + qbits)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    g = d(rng.randn(T_, B_, H_) * 0.5)
    U = d(rng.randn(H_, H_) * 0.3 / np.sqrt(H_))
    drop = d(rng.rand(B_, H_) > 0.2) / 0.8
    h0 = d(rng.randn(B_, H_) * 0.3) if seeded else None
    assert tfr.rnn_fwd_route(B_, H_, cuda_device)[0] == "persist"
    w = tfr.fused_rnn_fwd
    with torch.no_grad():
        before = w.launches
        hs, acts = w(g, U, drop, h0, act=act, qbits=qbits, stash=True)
        assert w.launches == before + 1
        s_hs, s_acts = tfr._rnn_fwd_step(g, U, drop, h0, act, qbits, True)
        assert torch.equal(hs, s_hs) and torch.equal(acts, s_acts)
        assert torch.equal(hs, acts * drop)
        s = T_ // 2
        shifted = w(g[s:].contiguous(), U, drop, hs[s - 1].contiguous(),
                    act=act, qbits=qbits)
        assert torch.equal(shifted, hs[s:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", tfr.RNN_BWD_SHAPES)
def test_cuda_bwd_persist_is_the_step_routes_bits(cuda_device, shape):
    """The recompute BPTT's persistent chain (TPU row 29) forced to each
    instantiated block shape at a ragged width (H=37: the last unit group
    masked, the exchange rows padded to 40 floats) and batch (8 bi + 3
    rows): bit for bit its forced step route (each dot is one warp's in
    rnn_bwd_step's order), qbits 0 and 16, tanh and relu, within the
    twin's bar; the rebuild and the chain a call, and the per-step scales
    with the quantizer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bi, un = shape
    T_, B_, H_ = 7, 8 * bi + 3, 37
    g, U, drop, _, dhs = (tt(a).to(cuda_device) for a in _inputs(
        91 + 2 * un + bi, h=H_, t=T_, b=B_))
    U = U * float(np.sqrt(H / H_))
    plan = tfr.rnn_bwd_plan(B_, H_, shape)
    w = tfr.fused_rnn_bwd
    with torch.no_grad():
        for qbits in (0, 16):
            for act in ("tanh", "relu"):
                hs = tfr.fused_rnn_fwd(g, U, drop, act=act, qbits=qbits)
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                before = w.launches
                got = tfr._rnn_bwd_persist(plan, g, U, drop, h_prev, dhs, act,
                                           qbits)
                assert w.launches == before + 2 + (qbits > 0)
                want = tfr._rnn_bwd_step(w, g, U, drop, h_prev, dhs, act,
                                         qbits, False)
                ref = tfr.fused_rnn_bwd_plain(g.cpu(), U.cpu(), drop.cpu(),
                                              h_prev.cpu(), dhs.cpu(), act,
                                              qbits)
                assert torch.equal(got, want), (shape, qbits, act)
                np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                                           atol=_atol(qbits) * max(
                                               1.0, float(ref.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("T_, B_, H_, act, qbits, route", [
    (300, 8, 550, "relu", 0, "persist"),   # the TIMIT RNN's train shape
    (300, 8, 550, "tanh", 16, "persist"),
    (300, 8, 512, "relu", 0, "persist"),   # RNN_cudnn's 512-wide layers
    (6, 96, 1024, "tanh", 0, "step"),      # 384 blocks: not co-resident
])
def test_cuda_bwd_route_at_the_timit_shapes(cuda_device, T_, B_, H_, act,
                                            qbits, route):
    """At full width the wrapper takes the route its plan names before
    the launch (2 launches a call on the persistent route, 3 with the
    quantizer; T + 1 on the step route) and gives its forced step route's
    bits, within the twin's bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(H_ + qbits + 1)
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    g = d(rng.randn(T_, B_, H_) * 0.5)
    U = d(rng.randn(H_, H_) * 0.3 / np.sqrt(H_))
    drop = d(rng.rand(B_, H_) > 0.2) / 0.8
    dhs = d(rng.randn(T_, B_, H_))
    assert tfr.rnn_bwd_route(B_, H_, cuda_device)[0] == route
    w = tfr.fused_rnn_bwd
    with torch.no_grad():
        hs = tfr.fused_rnn_fwd(g, U, drop, act=act, qbits=qbits)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = w.launches
        got = w(g, U, drop, h_prev, dhs, act, qbits)
        assert w.launches == before + tfr.rnn_bwd_launches(route, T_, qbits)
        want = tfr._rnn_bwd_step(w, g, U, drop, h_prev, dhs, act, qbits,
                                 False)
        assert torch.equal(got, want)
        ref = tfr.fused_rnn_bwd_plain(g, U, drop, h_prev, dhs, act, qbits)
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=_atol(qbits) * scale)
