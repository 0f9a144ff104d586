"""The port's torch-semantics GRU (pytorch_kaldi_cgs_tpu_torch: the
torch-GRU part of ops/fused_rnn.py and models/recurrent.py GRU_cudnn)
against the JAX package on the same numpy inputs, the Pallas kernels run
in interpret mode.

- The two kernels' plain twins against ``_build_gru_torch_fwd`` and
  ``_build_gru_torch_bwd`` (dg and dm) at a ragged shape (B=3, H=18),
  with a recurrent bias and with zeros; the seeded forward against the
  zero-state run's later steps.
- ``gru_cudnn_scan_fused`` (the autograd Function) against ``jax.vjp`` of
  the JAX ``gru_cudnn_scan_fused`` (dg, dW_hh, db_hh), and against
  autograd through the ``gru_torch_cell`` loop; the twin against
  ``torch.nn.GRU`` with the same weights.
- ``GRU_cudnn`` (2 layers, uni- and bidirectional, with and without
  bias) against the JAX class with ``fused_scan=True``: ``init``, eval,
  the gradient of every w_ih, w_hh, b_ih and b_hh in train mode (dropout
  0: the JAX package draws its inter-layer mask from ``jax.random``), and
  a unidirectional stream against the whole utterance and the JAX
  package's (its lax.scan stream: the same math); a bidirectional one
  raises. ``b_hh`` is not folded into the projection: ``b_hn`` sits
  inside the reset product, and folding it would miss the JAX class.

Tolerances: float32 atol 1e-5 (sums in another order than XLA's, over
the steps); gradients 1e-5 of each one's scale; the model's outputs and
gradients through two layers 1e-5 (no quantizer, no batch norm).

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_gru_cudnn.py``).
There the kernels are held against their twins on the same tensors
(float32 atol 1e-5 at the small shape, 1e-4 of scale at H=550 over 300
steps).
"""
import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import GRU_cudnn, get_model_class
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

T, B, H = 9, 3, 18
F_IN = 12
ATOL = 1e-5
CHUNKS = ((0, 4), (4, 5), (5, T))
tt = torch.from_numpy


@pytest.fixture
def jfr():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_rnn")


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _inputs(seed, bias=True, t=T, b=B, h=H):
    """Gates (t, b, 3h) [r | z | n], W_hh (3h, h) and b_hh (3h,) drawn
    as torch draws them (U(+-1/sqrt(h))), h0 and upstream dhs."""
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(h)
    g = (rng.randn(t, b, 3 * h) * 0.5).astype(np.float32)
    W = rng.uniform(-k, k, (3 * h, h)).astype(np.float32)
    bh = (rng.uniform(-k, k, (3 * h,)) if bias
          else np.zeros(3 * h)).astype(np.float32)
    h0 = (rng.randn(b, h) * 0.3).astype(np.float32)
    dhs = rng.randn(t, b, h).astype(np.float32)
    return g, W, bh, h0, dhs


def _np(x):
    return np.asarray(x, np.float32)


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

@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_fwd_twin_matches_pallas(jfr, bias):
    """The forward twin against ``_build_gru_torch_fwd``; the seeded
    forward from h_{k-1} reproduces the zero-state run's steps k..T-1."""
    import jax.numpy as jnp
    g, W, bh, _, _ = _inputs(3, bias)
    ref = jfr._build_gru_torch_fwd(T, B, H, True)(
        jnp.asarray(g), jnp.asarray(W), jnp.asarray(bh[None]))
    got = tfr.fused_gru_torch_fwd(tt(g), tt(W), tt(bh))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL)
    k = T // 2
    seeded = tfr.fused_gru_torch_fwd(tt(g[k:]), tt(W), tt(bh), got[k - 1])
    np.testing.assert_allclose(seeded.numpy(), got[k:].numpy(), atol=ATOL)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_bwd_twin_matches_pallas(jfr, bias):
    """dg = (da_r, da_z, da_n) and dm = da_n * r of the BPTT twin against
    ``_build_gru_torch_bwd``, both over the same forward's h_prev."""
    import jax.numpy as jnp
    g, W, bh, _, dhs = _inputs(5, bias)
    j = jnp.asarray
    hs = _np(jfr._build_gru_torch_fwd(T, B, H, True)(j(g), j(W), j(bh[None])))
    h_prev = _h_prev(hs)
    ref_dg, ref_dm = jfr._build_gru_torch_bwd(T, B, H, True)(
        j(g), j(W), j(bh[None]), j(h_prev), j(dhs))
    dg, dm = tfr.fused_gru_torch_bwd(tt(g), tt(W), tt(bh), tt(h_prev),
                                     tt(dhs))
    np.testing.assert_allclose(dg.numpy(), _np(ref_dg), atol=ATOL)
    np.testing.assert_allclose(dm.numpy(), _np(ref_dm), atol=ATOL)


def test_twin_equals_torch_nn_gru():
    """The twin is torch's own GRU: ``nn.GRU`` with the same weights,
    the projection x @ W_ih.T + b_ih as the gates."""
    gru = torch.nn.GRU(F_IN, H)
    x = torch.from_numpy(np.random.RandomState(1).randn(T, B, F_IN)
                         .astype(np.float32))
    with torch.no_grad():
        ref = gru(x)[0]
        g = x @ gru.weight_ih_l0.T + gru.bias_ih_l0
        got = tfr.fused_gru_torch_fwd(g, gru.weight_hh_l0, gru.bias_hh_l0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)


def test_wrappers_reject_bad_inputs():
    g, W, bh, h0, dhs = (tt(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="W_hh must be"):
        tfr.fused_gru_torch_fwd(g, W[:, :-1], bh)
    with pytest.raises(ValueError, match="b_hh must be"):
        tfr.fused_gru_torch_fwd(g, W, bh[:-1])
    with pytest.raises(ValueError, match=r"\(T, B, 3H\)"):
        tfr.fused_gru_torch_fwd(g[..., :-1], W, bh)
    with pytest.raises(ValueError, match="float32"):
        tfr.fused_gru_torch_fwd(g.double(), W, bh)
    with pytest.raises(ValueError, match="h0 must be"):
        tfr.fused_gru_torch_fwd(g, W, bh, h0[:, :-1])
    with pytest.raises(ValueError, match="dhs must be"):
        tfr.fused_gru_torch_bwd(g, W, bh, dhs, dhs[:-1])
    with pytest.raises(RuntimeError, match="no autograd"):
        tfr.fused_gru_torch_fwd(g.requires_grad_(), W, bh)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _torch_grads(g, W, bh, dhs, dev="cpu"):
    d = lambda a: tt(a).to(dev)
    leaves = [d(g).requires_grad_(), d(W).requires_grad_(),
              d(bh).requires_grad_()]
    hs = tfr.gru_cudnn_scan_fused(*leaves)
    hs.backward(d(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_function_grads_match_jax_vjp(jfr, bias):
    """hs, dgates, dW_hh and db_hh of the Function against jax.vjp of the
    JAX custom VJP (dW_hh and db_hh over the unrolled batch outside the
    kernel in both)."""
    import jax
    import jax.numpy as jnp
    g, W, bh, _, dhs = _inputs(13, bias)
    j = jnp.asarray
    hs, vjp = jax.vjp(lambda g_, W_, b_: jfr.gru_cudnn_scan_fused(
        g_, W_, b_, interpret=True), j(g), j(W), j(bh))
    ref = [_np(hs)] + [_np(a).reshape(np.shape(b_))
                       for a, b_ in zip(vjp(j(dhs)), (g, W, bh))]
    _assert_rel(_torch_grads(g, W, bh, dhs), ref, ATOL,
                ["hs", "dgates", "dW_hh", "db_hh"])


def test_function_grads_equal_autograd_through_plain_loop():
    """Independent of JAX: the Function's backward (BPTT twin, then one
    product and one sum) equals torch.autograd through the cell loop."""
    g, W, bh, _, dhs = _inputs(17)
    got = _torch_grads(g, W, bh, dhs)
    leaves = [tt(g).requires_grad_(), tt(W).requires_grad_(),
              tt(bh).requires_grad_()]
    hs = tfr.fused_gru_torch_fwd_plain(*leaves)
    hs.backward(tt(dhs))
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    _assert_rel(got, ref, ATOL, ["hs", "dgates", "dW_hh", "db_hh"])


def test_no_bias_takes_zeros():
    """``b_hh=None`` is the zero bias: the same hs and dgates."""
    g, W, bh, _, dhs = _inputs(19, bias=False)
    gl = tt(g).requires_grad_()
    hs = tfr.gru_cudnn_scan_fused(gl, tt(W), None)
    hs.backward(tt(dhs))
    ref = _torch_grads(g, W, bh, dhs)
    np.testing.assert_array_equal(hs.detach().numpy(), ref[0])
    np.testing.assert_array_equal(gl.grad.numpy(), ref[1])


# ---------------------------------------------------------------------------
# GRU_cudnn against the JAX class
# ---------------------------------------------------------------------------

def cudnn_opts(bidir=True, drop="0.2", bias=True, layers=2):
    """``layers`` of 16 with inter-layer dropout; ``fused_scan=True``
    takes the JAX fused kernels on the CPU."""
    return {"hidden_size": "16", "num_layers": str(layers),
            "bidirectional": str(bidir), "dropout": drop, "bias": str(bias),
            "fused_scan": "True", "to_do": "forward"}


def _pair(jm, seed, **kw):
    opts = cudnn_opts(**kw)
    jmod = jm.GRU_cudnn(opts, F_IN)
    tree = jmod.init(seed)
    port = GRU_cudnn(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    return jmod, tree, port


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the port's calls into the torch-semantics GRU (whole
    utterance, stream)."""
    calls = {"fused": 0, "stream": 0}
    for name, key in (("gru_cudnn_scan_fused", "fused"),
                      ("gru_cudnn_scan_fused_stream", "stream")):
        real = getattr(tfr, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return calls


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_init_equals_jax_init(jm, bias):
    """init(seed) gives the JAX package's w_ih/w_hh/b_ih/b_hh of every
    layer and direction; the registry resolves the name."""
    opts = cudnn_opts(bias=bias)
    port = GRU_cudnn(opts, F_IN, seed=5, device="cpu")
    jtree = jm.GRU_cudnn(opts, F_IN).init(5)
    fa = convert.flatten(convert.to_jax_variables(port.variables()))
    fb = convert.flatten(jtree)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)
    assert port.out_dim == 32 and ("b_hh_l1_r" in jtree["params"]) == bias
    assert get_model_class("pytorch_kaldi_cgs_tpu.models",
                           "GRU_cudnn") is GRU_cudnn


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("bidir", [True, False], ids=["bidir", "uni"])
def test_eval_matches_jax(jm, fused_calls, bidir, bias):
    """Every direction of both layers on the fused kernels, against the
    JAX class on its torch-semantics Pallas kernel."""
    jmod, tree, port = _pair(jm, 1, bidir=bidir, bias=bias)
    x = np.random.RandomState(2).randn(T, B, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = port.eval()(tt(x))
    nd = 2 if bidir else 1
    assert fused_calls["fused"] == 2 * nd and y.shape == (T, B, 16 * nd)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL)


def test_recurrent_bias_is_not_folded(jm):
    """b_hn sits inside r * (U_n h + b_hn): adding b_hh to the projection
    (as LSTM_cudnn and RNN_cudnn may) gives another function, which
    misses the JAX class."""
    jmod, tree, port = _pair(jm, 4, bidir=False)
    x = np.random.RandomState(3).randn(T, B, F_IN).astype(np.float32)
    y_ref = _np(jmod.apply(tree, x, train=False)[0])
    p = port.params
    with torch.no_grad():
        g = tt(x) @ p["w_ih_l0"].T + p["b_ih_l0"] + p["b_hh_l0"]
        folded = tfr.gru_cudnn_scan_fused(g, p["w_hh_l0"], None)
        y = port.eval()(tt(x))
    np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL)
    jm1, tree1, _ = _pair(jm, 4, bidir=False, layers=1)
    y1 = _np(jm1.apply(tree1, x, train=False)[0])
    assert float(np.abs(folded.numpy() - y1).max()) > 1e-3


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("bidir", [True, False], ids=["bidir", "uni"])
def test_grads_match_jax(jm, bidir, bias):
    """Train mode without dropout: the gradient of every w_ih, w_hh, b_ih
    and b_hh against jax.grad."""
    import jax
    import jax.numpy as jnp
    jmod, tree, port = _pair(jm, 3, bidir=bidir, bias=bias, drop="0.0")
    nd = 2 if bidir else 1
    x = np.random.RandomState(4).randn(T, B, F_IN).astype(np.float32)
    wy = np.random.RandomState(5).randn(T, B, 16 * nd).astype(np.float32)

    def loss(params):
        y, _ = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                          train=True)
        return jnp.sum(y * wy), y
    (_, y_ref), grads = jax.value_and_grad(loss, has_aux=True)(
        tree["params"])
    y = port.train()(tt(x))
    (y * tt(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL)
    ref_g = convert.flatten(jax.device_get(grads))
    got_g = {k: p.grad.numpy() for k, p in port.params.items()}
    assert sorted(ref_g) == sorted(got_g)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got_g[k], _np(v), atol=ATOL * scale,
                                   err_msg=k)


def test_streaming_equals_whole_utterance_and_jax(jm, fused_calls):
    """Unidirectional: three chunks on the seeded forward reproduce the
    whole utterance and the JAX package's stream (a seeded lax.scan
    there, the same math). A bidirectional wrapper cannot stream."""
    jmod, tree, port = _pair(jm, 6, bidir=False)
    x = np.random.RandomState(7).randn(T, B, F_IN).astype(np.float32)
    xt = tt(x)
    with torch.no_grad():
        full = port.eval()(xt)
        carries, got = None, []
        for a, b in CHUNKS:
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert fused_calls["stream"] == 6 and len(carries) == 2
    got = torch.cat(got).numpy()
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)
    jc, jgot = None, []
    for a, b in CHUNKS:
        y, jc = jmod.apply_streaming(tree, x[a:b], jc)
        jgot.append(_np(y))
    np.testing.assert_allclose(got, np.concatenate(jgot), atol=ATOL)
    bidir = _pair(jm, 6)[2]
    with pytest.raises(ValueError, match="cannot stream"):
        bidir.apply_streaming(xt[:2])


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
@pytest.mark.parametrize("shape", [(T, B, H), (300, 8, 550)],
                         ids=["small", "timit"])
def test_cuda_kernels_match_plain_twins(cuda_device, shape):
    """The forward (zero and seeded; one launch per step) and the BPTT
    (the persistent route at both shapes: the rebuild and one chain, 2
    launches) against their twins on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, h = shape
    g, W, bh, h0, dhs = (tt(a).to(cuda_device)
                         for a in _inputs(21, t=t, b=b, h=h))
    assert tfr.gru_torch_bwd_route(b, h, cuda_device)[0] == "persist"
    with torch.no_grad():
        before = (tfr.fused_gru_torch_fwd.launches,
                  tfr.fused_gru_torch_bwd.launches)
        hs = tfr.fused_gru_torch_fwd(g, W, bh)
        hs0 = tfr.fused_gru_torch_fwd(g, W, bh, h0)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dg, dm = tfr.fused_gru_torch_bwd(g, W, bh, h_prev, dhs)
        assert (tfr.fused_gru_torch_fwd.launches,
                tfr.fused_gru_torch_bwd.launches) == (before[0] + 2 * t,
                                                      before[1] + 2)
        refs = (tfr.fused_gru_torch_fwd_plain(g, W, bh),
                tfr.fused_gru_torch_fwd_plain(g, W, bh, h0),
                *tfr.fused_gru_torch_bwd_plain(g, W, bh, h_prev, dhs))
    torch.cuda.synchronize()
    tol = ATOL if t == T else 1e-4
    _assert_rel([a.cpu() for a in (hs, hs0, dg, dm)],
                [r.cpu() for r in refs], tol, ["hs", "hs0", "dg", "dm"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(T, B, H), (7, 13, 45), (40, 5, 550),
                                   (30, 40, 61), (12, 5, 64)],
                         ids=["small", "b13_h45", "h550_b5", "b40_h61",
                              "h64_16byte_loads"])
def test_cuda_bwd_persist_matches_twin(cuda_device, shape):
    """The persistent chain (route "persist") and the rebuild's GEMM
    against the twin at widths that are not multiples of the 8 units a
    block owns and batches that are not multiples of 8 (one block of 8 or
    32 rows, or two of 32, the second ragged), and at H=64, where the
    GEMM takes its 16-byte loads; two calls bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, h = shape
    route, plan = tfr.gru_torch_bwd_route(b, h, cuda_device)
    assert route == "persist" and plan.bi == (1 if b <= 8 else 4)
    g, W, bh, _, dhs = (tt(a).to(cuda_device)
                        for a in _inputs(27, t=t, b=b, h=h))
    with torch.no_grad():
        hs = tfr.fused_gru_torch_fwd(g, W, bh)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        dg, dm = tfr.fused_gru_torch_bwd(g, W, bh, h_prev, dhs)
        dg2, dm2 = tfr.fused_gru_torch_bwd(g, W, bh, h_prev, dhs)
        refs = tfr.fused_gru_torch_bwd_plain(g, W, bh, h_prev, dhs)
    torch.cuda.synchronize()
    assert torch.equal(dg, dg2) and torch.equal(dm, dm2)
    tol = ATOL if h < 100 else 1e-4
    _assert_rel([dg.cpu(), dm.cpu()], [r.cpu() for r in refs], tol,
                ["dg", "dm"])


@pytest.mark.cuda
def test_cuda_bwd_step_route_matches_twin(cuda_device):
    """At B=16 a 550-wide block (8 units, 32 rows) needs more shared
    memory than a block has: the per-step kernels (T + 1 launches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, b, h = 20, 16, 550
    assert tfr.gru_torch_bwd_route(b, h, cuda_device)[0] == "step"
    g, W, bh, _, dhs = (tt(a).to(cuda_device)
                        for a in _inputs(29, t=t, b=b, h=h))
    with torch.no_grad():
        hs = tfr.fused_gru_torch_fwd(g, W, bh)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        before = tfr.fused_gru_torch_bwd.launches
        dg, dm = tfr.fused_gru_torch_bwd(g, W, bh, h_prev, dhs)
        assert tfr.fused_gru_torch_bwd.launches == before + t + 1
        refs = tfr.fused_gru_torch_bwd_plain(g, W, bh, h_prev, dhs)
    torch.cuda.synchronize()
    _assert_rel([dg.cpu(), dm.cpu()], [r.cpu() for r in refs], 1e-4,
                ["dg", "dm"])


@pytest.mark.cuda
def test_cuda_function_grads_match_cpu(cuda_device):
    """The autograd Function on the card (kernels, dW_hh by cuBLAS)
    against the same call on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, W, bh, _, dhs = _inputs(23)
    _assert_rel(_torch_grads(g, W, bh, dhs, dev=cuda_device),
                _torch_grads(g, W, bh, dhs), ATOL,
                ["hs", "dgates", "dW_hh", "db_hh"])


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False], ids=["bidir", "uni"])
def test_cuda_wrapper_matches_cpu(cuda_device, bidir):
    """GRU_cudnn (2 layers) on the card against the same model on the
    CPU, in eval and its gradients in train mode (dropout from one CPU
    generator)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.random.RandomState(31).randn(T, B, F_IN).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        port = GRU_cudnn(cudnn_opts(bidir=bidir), F_IN, seed=4, device=dev)
        with torch.no_grad():
            y_eval = port.run(tt(x).to(dev), train=False)
        y = port.run(tt(x).to(dev), train=True,
                     generator=torch.Generator().manual_seed(0))
        y.square().sum().backward()
        out[dev.type] = [y_eval.cpu(), y.detach().cpu()] + [
            p.grad.cpu() for _, p in sorted(port.params.items())]
    _assert_rel(out["cuda"], out["cpu"], ATOL,
                ["eval", "train"] + ["grad"] * (len(out["cpu"]) - 2))
