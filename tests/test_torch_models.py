"""The port's LSTM and MLP (pytorch_kaldi_cgs_tpu_torch/models) against
the JAX package's: ``init(seed)`` array for array, eval forward with
non-trivial batch-norm statistics carried over by ``convert``, train-mode
batch norm, and streaming.

Tolerances: float32 atol 1e-5 (matmul sum order differs from XLA's);
with 16-bit input quantization atol 1e-4 (the ceil quantizer turns a
one-ulp difference at a step into one step, max|x|/2^15); bf16 compute
atol 2e-2 (the JAX package's bf16 bar: a one-ulp input difference can
round to a neighbouring bf16 value). The JAX LSTM runs
both its lax.scan path and its Pallas kernel in interpret mode
(``lstm_fused_scan=True``).
"""
import jax
import numpy as np
import pytest
import torch

import pytorch_kaldi_cgs_tpu.models as JM
from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP

F_IN = 12


def lstm_opts(quant=True, cdt="", laynorm=False, act="tanh", bidir=False,
              fused=False, quant_inp=None):
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "lstm",
        "lstm_lay": "16,16", "lstm_drop": "0.0,0.0",
        "lstm_use_batchnorm": "True,True",
        "lstm_use_laynorm": "%s,%s" % (laynorm, laynorm),
        "lstm_use_laynorm_inp": "False", "lstm_use_batchnorm_inp": "True",
        "lstm_act": "tanh,%s" % act, "lstm_orthinit": "True",
        "lstm_bidir": str(bidir), "lstm_hcgs": "True",
        "hcgsx_block": "8,2", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "8,2", "hcgsh_sparse": "25,62.5",
        "lstm_quant": str(quant), "param_quant": "8,8",
        "lstm_quant_inp": str(quant if quant_inp is None else quant_inp),
        "inp_quant": "16", "lstm_fused_scan": str(fused), "scan_unroll": "1"}


def mlp_opts(cdt="", quant=True):
    return {
        "compute_dtype": cdt, "to_do": "forward", "arch_name": "mlp",
        "dnn_lay": "24,18", "dnn_drop": "0.0,0.0",
        "dnn_use_batchnorm": "True,False", "dnn_use_laynorm": "False,True",
        "dnn_use_laynorm_inp": "True", "dnn_use_batchnorm_inp": "False",
        "dnn_act": "relu,softmax", "mlp_hcgs": "True", "hcgs_block": "8,2",
        "hcgs_sparse": "25,50", "mlp_quant": str(quant), "param_quant": "8",
        "mlp_quant_inp": str(quant), "inp_quant": "16"}


def _atol(cdt, quant_inp):
    return 2e-2 if cdt else (1e-4 if quant_inp else 1e-5)


def _perturbed(tree, seed):
    """Non-trivial BN statistics and norm parameters, so that carrying
    them across packages is really tested."""
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


def _port(cls, opts, tree):
    m = cls(opts, F_IN if cls is LSTM else 10, device="cpu")
    return m.load_variables(convert.from_jax_variables(tree))


def _assert_tree_equal(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("cls,jcls,opts,inp", [
    (LSTM, JM.LSTM, lstm_opts(), F_IN),
    (LSTM, JM.LSTM, lstm_opts(laynorm=True, bidir=True), F_IN),
    (MLP, JM.MLP, mlp_opts(), 10)], ids=["lstm", "lstm_ln_bidir", "mlp"])
def test_init_equals_jax_init(cls, jcls, opts, inp):
    for seed in (0, 7):
        port = cls(opts, inp, seed=seed, device="cpu")
        _assert_tree_equal(convert.to_jax_variables(port.variables()),
                           jcls(opts, inp).init(seed))


def test_convert_round_trip():
    tree = _perturbed(JM.LSTM(lstm_opts(), F_IN).init(1), 2)
    back = convert.to_jax_variables(convert.from_jax_variables(tree))
    _assert_tree_equal(back, tree)


@pytest.mark.parametrize("jax_path", ["scan", "pallas"])
@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["noquant", "quant"])
def test_lstm_eval_matches_jax(quant, cdt, jax_path):
    opts = lstm_opts(quant=quant, cdt=cdt, fused=jax_path == "pallas")
    jm = JM.LSTM(opts, F_IN)
    tree = _perturbed(jm.init(0), 1)
    x = np.random.RandomState(2).randn(11, 3, F_IN).astype(np.float32)
    y_ref, _ = jm.apply(tree, x, train=False)
    port = _port(LSTM, opts, tree).eval()
    with torch.no_grad():
        y = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               atol=_atol(cdt, quant))


@pytest.mark.parametrize("opts", [
    lstm_opts(laynorm=True, act="relu"), lstm_opts(act="sigmoid"),
    lstm_opts(bidir=True)], ids=["laynorm", "sigmoid_act", "bidir"])
def test_lstm_plain_loop_and_bidir_match_jax(opts):
    """Layers the kernel does not take (in-scan layer norm, another
    activation) run the plain step loop; bidir concatenates the
    time-reversed copy along the batch."""
    jm = JM.LSTM(opts, F_IN)
    tree = _perturbed(jm.init(3), 4)
    x = np.random.RandomState(5).randn(9, 2, F_IN).astype(np.float32)
    y_ref, _ = jm.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(LSTM, opts, tree).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               atol=_atol("", True))


def test_lstm_train_mode_batch_norm_matches_jax():
    """Train mode: batch statistics normalize, running ones update in
    place like the JAX package's returned state (dropout 0: the two
    packages' random streams differ)."""
    opts = lstm_opts()
    jm = JM.LSTM(opts, F_IN)
    tree = _perturbed(jm.init(0), 6)
    x = np.random.RandomState(7).randn(10, 3, F_IN).astype(np.float32)
    y_ref, state_ref = jm.apply(tree, x, train=True,
                                rng=jax.random.PRNGKey(0))
    port = _port(LSTM, opts, tree).train()
    with torch.no_grad():
        y = port(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               atol=_atol("", True))
    got = convert.to_jax_variables(port.variables())["state"]
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(convert.flatten(got)[k], np.asarray(v),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["noquant", "quant"])
def test_mlp_eval_matches_jax(quant, cdt):
    opts = mlp_opts(cdt=cdt, quant=quant)
    jm = JM.MLP(opts, 10)
    tree = _perturbed(jm.init(0), 1)
    x = np.random.RandomState(3).randn(20, 10).astype(np.float32)
    y_ref, _ = jm.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(MLP, opts, tree).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               atol=_atol(cdt, quant))


def test_guided_masks_and_pruning_match_jax():
    """The rest of the effective-weight chain: guided HCGS masks (built
    by init from the weights) and per-forward magnitude pruning."""
    opts = dict(mlp_opts(quant=False), guided_hcgs="True",
                apply_guided_hcgs="True", mlp_prune="True",
                mlp_prune_perc="30,50")
    jm = JM.MLP(opts, 10)
    tree = jm.init(4)
    _assert_tree_equal(convert.to_jax_variables(
        MLP(opts, 10, seed=4, device="cpu").variables()), tree)
    x = np.random.RandomState(5).randn(16, 10).astype(np.float32)
    y_ref, _ = jm.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(MLP, opts, tree).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_lstm_streaming_equals_whole_utterance(cdt):
    """Three chunks with carried (h, c) reproduce the whole-utterance
    eval output (same arithmetic, so to float32 rounding), and match the
    JAX package's streaming."""
    opts = lstm_opts(cdt=cdt, quant_inp=False)
    jm = JM.LSTM(opts, F_IN)
    tree = _perturbed(jm.init(2), 3)
    x = np.random.RandomState(8).randn(24, 3, F_IN).astype(np.float32)
    port = _port(LSTM, opts, tree).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = port(xt)
        carries, got = None, []
        for a, b in ((0, 7), (7, 8), (8, 24)):
            y, carries = port.apply_streaming(xt[a:b], carries)
            got.append(y)
    assert len(carries) == 2 and carries[0][1].shape == (3, 16)
    np.testing.assert_allclose(torch.cat(got).numpy(), full.numpy(),
                               atol=1e-6)
    jc, jgot = None, []
    for a, b in ((0, 7), (7, 8), (8, 24)):
        y, jc = jm.apply_streaming(tree, x[a:b], jc)
        jgot.append(np.asarray(y))
    np.testing.assert_allclose(torch.cat(got).numpy(),
                               np.concatenate(jgot),
                               atol=2e-2 if cdt else 1e-5)


def test_mlp_streams_trivially():
    m = MLP(mlp_opts(), 10, device="cpu").eval()
    x = torch.from_numpy(
        np.random.RandomState(9).randn(6, 10).astype(np.float32))
    with torch.no_grad():
        y, carries = m.apply_streaming(x)
        np.testing.assert_array_equal(y.numpy(), m(x).numpy())
    assert carries == []


def test_bidirectional_refuses_streaming():
    m = LSTM(lstm_opts(bidir=True), F_IN, device="cpu")
    with pytest.raises(ValueError, match="bidirectional"):
        m.apply_streaming(torch.zeros(4, 2, F_IN))
