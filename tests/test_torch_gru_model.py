"""The port's LibriSpeech GRU model (pytorch_kaldi_cgs_tpu_torch:
models/recurrent.py GRU over the sparse GRU of ops/fused_rnn.py and the
v3 projection of ops/block_sparse.py) against the JAX package on the
same numpy inputs, the Pallas kernels run in interpret mode. The
kernels' twins, the autograd Functions, the MLP's v3 path and the
training steps are tests/test_torch_gru.py's.

- ``GRU.init`` array for array; the bidirectional 2x256 HCGS + 8-bit +
  16-bit GRU (128-blocks, the libri cfg's 75,50 on x and h, so Kb=2, R=1
  recurrences, and ``gru_block_sparse=True`` puts both x-projections on
  v3: a K-padded 40-wide input and a 512-wide one) against JAX ``apply``
  (``gru_fused_scan=True``: the JAX sparse recurrence on the CPU) in eval
  and train mode, f32 and bf16 (1e-4), its parameter gradients against
  ``jax.grad``; the plain loop; the dense fused GRU (rows 19-21); the
  sparse recurrence at any batch; packing.
"""
import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import GRU, get_model_class
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

ATOL = 1e-5
ATOL_Q = 1e-4           # a 16-bit quantizer; bf16 w3g
tt = torch.from_numpy


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
# the model
# ---------------------------------------------------------------------------

F_IN = 40


def gru_opts(cdt="", mode="True", act="tanh", laynorm=False, bidir=True,
             quant_inp=True, drop="0.2", hcgsh_sparse="75,50", lay=256):
    """The libri cfg's GRU section narrowed to 2 x ``lay``: 128-blocks at
    75,50 on x and h; ``gru_block_sparse=True`` puts both x-projections
    on v3 (the narrow widths are below auto's Kb >= 16)."""
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "gru",
        "gru_lay": "%d,%d" % (lay, lay), "gru_drop": "%s,%s" % (drop, drop),
        "gru_use_batchnorm": "True,True",
        "gru_use_laynorm": "%s,%s" % (laynorm, laynorm),
        "gru_use_laynorm_inp": "False", "gru_use_batchnorm_inp": "False",
        "gru_act": "%s,%s" % (act, act), "gru_orthinit": "True",
        "gru_bidir": str(bidir), "gru_hcgs": "True",
        "gru_block_sparse": mode, "gru_fused_scan": "True",
        "hcgsx_block": "128,4", "hcgsx_sparse": "75,50",
        "hcgsh_block": "128,4", "hcgsh_sparse": hcgsh_sparse,
        "gru_quant": "True", "param_quant": "8,8",
        "gru_quant_inp": str(quant_inp), "inp_quant": "16",
        "gru_prune": "False", "gru_prune_perc": "50",
        "skip_regularization": "True", "scan_unroll": "1"}


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


def _jax_packed(jm, opts, seed, perturb=None):
    """The JAX GRU, its init(seed) (perturbed), and the packed tree its
    runner would train (prepare_block_sparse + pack_variables)."""
    jmod = jm.GRU(opts, F_IN)
    tree = jmod.init(seed)
    if perturb is not None:
        tree = _perturbed(tree, perturb)
    jmod.prepare_block_sparse(tree)
    return jmod, tree, jmod.pack_variables(tree)


def _port(opts, tree):
    return GRU(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))


def test_gru_init_equals_jax_init(jm):
    """init(seed) gives the JAX package's arrays; the layouts agree (both
    recurrences sparse, both x-projections on v3) and so do the packed
    trees."""
    assert get_model_class("pytorch_kaldi_cgs_tpu.models", "GRU") is GRU
    opts = gru_opts()
    for seed in (0, 5):
        port = GRU(opts, F_IN, seed=seed, device="cpu")
        jmod, jtree, jpacked = _jax_packed(jm, opts, seed)
        _assert_tree_equal(convert.to_jax_variables(port.variables()), jtree)
        assert sorted(port._rec_layouts) == sorted(jmod._rec_layouts) == [0, 1]
        assert sorted(port._bs_layouts) == sorted(jmod._bs_layouts) == [0, 1]
        assert port._bs_layouts[0][0].K_orig == F_IN
        for i, (layout, sub3) in port._bs_layouts.items():
            np.testing.assert_array_equal(sub3.numpy(),
                                          np.asarray(jmod._bs_layouts[i][1]))
        port.pack_variables()
        _assert_tree_equal(convert.to_jax_variables(port.variables()),
                           jpacked)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_gru_eval_matches_jax(jm, cdt):
    """The bidirectional 2-layer GRU against JAX apply on its packed
    variables (v3 projections, sparse recurrences), the port both
    unpacked (w3 gathered from the dense weights, as a recognizer runs)
    and packed. Under bf16 both packages run the v3 projections and the
    sparse recurrences in float32, so the float32 bar holds."""
    opts = gru_opts(cdt)
    jmod, tree, packed = _jax_packed(jm, opts, 0, perturb=1)
    x = np.random.RandomState(2).randn(11, 3, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(packed, x, train=False)
    port = _port(opts, tree).eval()
    with torch.no_grad():
        y = port(tt(x))
        port.pack_variables()
        y_packed = port(tt(x))
    assert y.shape == (11, 3, 512)
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q)
    np.testing.assert_allclose(y_packed.numpy(), y.numpy(), atol=1e-6)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_gru_train_mode_and_grads_match_jax(jm, cdt):
    """Train mode (batch statistics, dropout 0) on the packed variables:
    the output, the updated BN statistics and the gradients of every
    parameter (packed x-weights, dense U, BN) against jax.grad; under
    bf16 both packages keep the v3 projections and the sparse
    recurrences in float32. T*2B = 40 rows: the JAX package's
    ``sparse_dU`` drops the rows past a multiple of 8 (see
    test_gru_function_matches_jax_vjp)."""
    import jax
    import jax.numpy as jnp
    opts = gru_opts(cdt, drop="0.0")
    jmod, tree, packed = _jax_packed(jm, opts, 3, perturb=4)
    x = np.random.RandomState(5).randn(10, 2, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(10, 2, 512).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**packed, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(packed["params"])
    port = _port(opts, tree).train()
    port.pack_variables()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(y_ref), atol=ATOL_Q)
    got = convert.flatten(convert.to_jax_variables(port.variables())["state"])
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(got[k], _np(v), atol=1e-5, err_msg=k)
    ref_g = convert.flatten(jax.device_get(grads))
    got_g = {k: p.grad.numpy() for k, p in port.params.items()}
    assert sorted(ref_g) == sorted(got_g)
    assert any(k.endswith("__bs") for k in got_g)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got_g[k], _np(v), atol=ATOL_Q * scale,
                                   err_msg=k)


@pytest.mark.parametrize("opts", [
    gru_opts(laynorm=True), gru_opts(act="sigmoid"),
    gru_opts(cdt="bf16", act="sigmoid", mode="False")],
    ids=["laynorm", "sigmoid_act", "sigmoid_act_bf16_dense"])
def test_gru_plain_loop_matches_jax(jm, opts):
    """Layers the sparse kernels do not take (in-scan layer norm, another
    activation) run the plain step loop, against the JAX lax.scan;
    under bf16 with gru_block_sparse=False the x-projections and the
    recurrent dots round to bf16 in both (the JAX package's bf16 bar)."""
    jmod, tree, packed = _jax_packed(jm, opts, 2, perturb=3)
    x = np.random.RandomState(7).randn(8, 2, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(packed, x, train=False)
    with torch.no_grad():
        y = _port(opts, tree).eval()(tt(x))
    atol = 2e-2 if opts["compute_dtype"] else ATOL_Q
    np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=atol)


@pytest.mark.parametrize("case", ["no_sparse_layout", "streaming"])
def test_gru_dense_fused_layer_runs(jm, monkeypatch, case):
    """A layer the JAX package runs on its dense fused GRU (rows 19-21: no
    sparse recurrent layout, or a stream, which drops the sparse layout)
    runs on the port's (``gru_scan_fused``, ``gru_scan_fused_stream``)
    and matches JAX's output (its Pallas kernels, interpret mode);
    tests/test_torch_gru_dense.py holds those kernels in full."""
    name = "gru_scan_fused" if case == "no_sparse_layout" \
        else "gru_scan_fused_stream"
    calls, real = [], getattr(tfr, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tfr, name, spy)
    opts = gru_opts(mode="False" if case == "no_sparse_layout" else "True",
                    bidir=False)
    jmod, tree, packed = _jax_packed(jm, opts, 6, perturb=7)
    m = _port(opts, tree).eval()
    assert sorted(m._rec_layouts) == ([] if case == "no_sparse_layout"
                                      else [0, 1])
    x = np.random.RandomState(8).randn(5, 2, F_IN).astype(np.float32)
    with torch.no_grad():
        if case == "no_sparse_layout":
            y = m(tt(x)).numpy()
            y_ref = _np(jmod.apply(packed, x, train=False)[0])
        else:
            y0, carries = m.apply_streaming(tt(x[:2]))
            y1, _ = m.apply_streaming(tt(x[2:]), carries)
            y = torch.cat([y0, y1]).numpy()
            j0, jc = jmod.apply_streaming(packed, x[:2])
            y_ref = np.concatenate([_np(j0), _np(
                jmod.apply_streaming(packed, x[2:], jc)[0])])
    assert len(calls) == (2 if case == "no_sparse_layout" else 4)
    np.testing.assert_allclose(y, y_ref, atol=ATOL_Q)


def test_sparse_recurrence_at_any_batch(jm, monkeypatch):
    """The port keeps a recurrence with a sparse layout on the sparse
    kernels at every batch. With a 1 MB budget the JAX size rule says ""
    at 40 rows for a 256-wide GRU and LSTM (Kb=2, R=1), and the JAX
    package runs its float32 lax.scan over the masked U
    (``*_fused_scan=False`` keeps it off its fused kernels); the port
    runs the sparse twins with float32 w3g, and the outputs agree."""
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
    monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", "1")
    rows, calls = 40, []
    for mod, name in ((tfr, "fused_gru_fwd_sparse_plain"),
                      (tfl, "fused_lstm_fwd_sparse_plain")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    lstm = {"compute_dtype": "", "to_do": "forward", "arch_name": "lstm",
            "lstm_lay": "256", "lstm_drop": "0.0",
            "lstm_use_batchnorm": "True", "lstm_use_laynorm": "False",
            "lstm_use_laynorm_inp": "False", "lstm_use_batchnorm_inp": "False",
            "lstm_act": "tanh", "lstm_orthinit": "True", "lstm_bidir": "False",
            "lstm_hcgs": "True", "hcgsx_block": "8,2", "hcgsx_sparse": "25,50",
            "hcgsh_block": "128,8", "hcgsh_sparse": "50,75",
            "lstm_quant": "True", "param_quant": "8",
            "lstm_quant_inp": "True", "inp_quant": "16",
            "lstm_fused_scan": "False", "scan_unroll": "1"}
    x = np.random.RandomState(9).randn(4, rows, F_IN).astype(np.float32)
    for jcls, tcls, opts, G, n in (
            (jm.GRU, GRU, dict(gru_opts(mode="auto", bidir=False),
                               gru_fused_scan="False"), 3, 2),
            (jm.LSTM, LSTM, lstm, 4, 1)):
        jmod = jcls(opts, F_IN)
        tree = _perturbed(jmod.init(1), 2)
        port = tcls(opts, F_IN, device="cpu").load_variables(
            convert.from_jax_variables(tree))
        layout = port._rec_layouts[0]
        assert sorted(port._rec_layouts) == list(range(n))
        assert (layout.Kb, layout.R) == (2, 1)
        from pytorch_kaldi_cgs_tpu_torch.ops.fused_lstm import \
            sparse_scan_fits
        assert sparse_scan_fits(rows, 256, layout, G) == ""
        calls.clear()
        with torch.no_grad():
            y = port.eval()(tt(x))
        assert calls == [("fused_gru_fwd_sparse_plain" if G == 3
                          else "fused_lstm_fwd_sparse_plain")] * n
        y_ref, _ = jmod.apply(tree, x, train=False)
        np.testing.assert_allclose(y.numpy(), _np(y_ref), atol=ATOL_Q,
                                   err_msg=tcls.__name__)


def test_gru_pack_unpack_round_trip():
    """pack_variables keeps the kept blocks only (idempotent);
    unpack_variables gives the dense weights back with dropped blocks
    zero, i.e. the masked ones."""
    m = GRU(gru_opts(), F_IN, seed=1, device="cpu")
    dense = {k: v.clone() for k, v in m.variables()["params"].items()}
    m.pack_variables()
    m.pack_variables()
    keys = sorted(k for k in m.params if k.endswith("__bs"))
    assert keys == sorted("%s%d__bs" % (g, i) for g in ("wh", "wz", "wr")
                          for i in (0, 1))
    layout = m._bs_layouts[1][0]
    assert tuple(m.params["wz1__bs"].shape) == (layout.Nb, 128,
                                                layout.R * 128)
    m.unpack_variables()
    assert sorted(m.params) == sorted(dense)
    for k, v in dense.items():
        got = m.params[k].detach().numpy()
        if k[:2] in ("wh", "wz", "wr") and k[2:].isdigit():
            mask = m.masks["hcgs_" + k].numpy()
            lay = m._bs_layouts[int(k[2:])][0]
            np.testing.assert_array_equal(got * mask, v.numpy() * mask)
            np.testing.assert_array_equal(
                got, tbs.unpack_w3(tbs.pack_w3(v.numpy(), lay), lay))
        else:
            np.testing.assert_array_equal(got, v.numpy(), err_msg=k)


def test_gru_scan_fits_rule_is_the_jax_rule(jfr, monkeypatch):
    """The size rule that picks f32 or bf16 w3g (or keeps a layer off the
    sparse recurrence) is the JAX package's, at the GRU's G=3."""
    from pytorch_kaldi_cgs_tpu.ops import fused_lstm as jfl
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
    mask = hcgs_mask(1024, 1024, [128, 4], [75, 50],
                     rng=np.random.RandomState(0))
    layout = tbs.pack_layout(mask, 128)
    for mb in (None, "4", "2"):
        if mb is None:
            monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
        else:
            monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", mb)
        for b in (16, 32, 192):
            assert tfl.sparse_scan_fits(b, 1024, layout, 3) == \
                jfl.sparse_scan_fits_vmem(b, 1024, layout, 3)
    monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    assert [tfl.sparse_scan_fits(b, 1024, layout, 3)
            for b in (16, 32, 192)] == ["f32", "f32", ""]
