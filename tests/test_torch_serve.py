"""The port's serving path (frontend, Viterbi, Recognizer,
StreamingRecognizer) against the JAX package's on the same inputs and
weights, on the CPU.

Tolerances: log-mel features rtol 1e-4 / atol 1e-3 (the two libraries'
FFTs round differently); log-posteriors atol 1e-4 (those feature
differences pass through CMVN and the model); decoded phone sequences
exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_kaldi_cgs_tpu.models as JM
from pytorch_kaldi_cgs_tpu.decode import viterbi as jvit
from pytorch_kaldi_cgs_tpu.ops import frontend as jfe
from pytorch_kaldi_cgs_tpu.runtime import serve as jserve
from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.decode import viterbi as tvit
from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP
from pytorch_kaldi_cgs_tpu_torch.ops import frontend as tfe
from pytorch_kaldi_cgs_tpu_torch.runtime import serve as tserve

MEL, H, PHONES, SPP = 10, 16, 4, 3


def _audio(B, n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    tone = np.sin(2 * np.pi * rng.uniform(200, 2000, (B, 1)) * t)
    return (tone + 0.3 * rng.randn(B, n)).astype(np.float32)


def test_fbank_mfcc_deltas_cmvn_match_jax():
    audio = _audio(2, 8000)
    jf = jfe.Frontend(sample_rate=16000, num_mel_bins=MEL, use_energy=True)
    tf = tfe.Frontend(sample_rate=16000, num_mel_bins=MEL, use_energy=True)
    a = torch.from_numpy(audio)
    fb = tf.fbank(a)
    assert fb.shape == (2, tf.num_frames(8000), MEL)
    for b in range(2):
        ref = np.asarray(jf.fbank(jnp.asarray(audio[b])))
        np.testing.assert_allclose(fb[b].numpy(), ref, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            tf.mfcc(a)[b].numpy(), np.asarray(jf.mfcc(jnp.asarray(audio[b]))),
            rtol=1e-4, atol=1e-3)
    ref = np.asarray(fb[0])
    np.testing.assert_allclose(
        tfe.add_deltas(fb[0], 2, 2).numpy(),
        np.asarray(jfe.add_deltas_jax(jnp.asarray(ref), 2, 2)), atol=1e-5)
    np.testing.assert_allclose(
        tfe.cmvn(fb[0], norm_vars=True).numpy(),
        np.asarray(jfe.cmvn_jax(jnp.asarray(ref), True)), atol=1e-5)


@pytest.mark.parametrize("acwt", [1.0, 0.2])
def test_batched_viterbi_matches_jax_with_ragged_lengths(acwt):
    hmm_j = jvit.PhoneLoopHMM(PHONES, SPP, phone_insertion_penalty=0.5)
    hmm_t = tvit.PhoneLoopHMM(PHONES, SPP, phone_insertion_penalty=0.5)
    rng = np.random.RandomState(1)
    ll = (rng.randn(5, 30, PHONES * SPP) * 3).astype(np.float32)
    lengths = np.array([30, 17, 1, 2, 29])
    got = tvit.batched_viterbi_decode(torch.from_numpy(ll), lengths, hmm_t,
                                      acwt=acwt)
    assert got == jvit.batched_viterbi_decode(ll, lengths, hmm_j, acwt=acwt)
    for b in range(5):
        L = int(lengths[b])
        assert tvit.viterbi_decode(ll[b, :L], hmm_t, acwt) == \
            jvit.viterbi_decode(ll[b, :L], hmm_j, acwt)


def test_viterbi_ties_take_the_first_maximum():
    """All-equal scores: every transition ties, and the JAX package's
    first-maximum rule decides the path."""
    hmm_j, hmm_t = jvit.PhoneLoopHMM(3, 2), tvit.PhoneLoopHMM(3, 2)
    ll = np.zeros((2, 9, 6), np.float32)
    lengths = np.array([9, 5])
    assert tvit.batched_viterbi_decode(ll, lengths, hmm_t, device="cpu") == \
        jvit.batched_viterbi_decode(ll, lengths, hmm_j)


def _small_stack(seed=0):
    lopts = {"to_do": "forward", "arch_name": "lstm", "lstm_lay": "%d,%d" % (H, H),
             "lstm_drop": "0.0,0.0", "lstm_use_batchnorm": "True,True",
             "lstm_use_laynorm": "False,False", "lstm_use_laynorm_inp": "False",
             "lstm_use_batchnorm_inp": "False", "lstm_act": "tanh,tanh",
             "lstm_orthinit": "True", "lstm_bidir": "False",
             "lstm_hcgs": "True", "hcgsx_block": "8,2",
             "hcgsx_sparse": "25,62.5", "hcgsh_block": "8,2",
             "hcgsh_sparse": "25,62.5", "lstm_quant": "True",
             "param_quant": "8,8", "lstm_quant_inp": "False",
             "inp_quant": "16"}
    mopts = {"to_do": "forward", "arch_name": "mlp",
             "dnn_lay": str(PHONES * SPP), "dnn_drop": "0.0",
             "dnn_use_batchnorm": "False", "dnn_use_laynorm": "False",
             "dnn_use_laynorm_inp": "False", "dnn_use_batchnorm_inp": "False",
             "dnn_act": "softmax"}
    jl, jm = JM.LSTM(lopts, MEL), JM.MLP(mopts, H)
    variables = {"lstm": jl.init(seed), "mlp": jm.init(seed + 1)}
    rng = np.random.RandomState(seed + 2)
    for k, v in variables["lstm"]["state"].items():   # non-trivial BN stats
        variables["lstm"]["state"][k] = {
            "mean": (rng.randn(H) * 0.1).astype(np.float32),
            "var": (rng.rand(H) + 0.5).astype(np.float32)}
    tl = LSTM(lopts, MEL, device="cpu").load_variables(
        convert.from_jax_variables(variables["lstm"]))
    tm = MLP(mopts, H, device="cpu").load_variables(
        convert.from_jax_variables(variables["mlp"]))
    return _JaxStack(jl, jm), variables, TorchStack(tl, tm)


class _JaxStack:
    """LSTM -> MLP head for the JAX recognizers (as tests/test_streaming.py
    writes it)."""
    arch_name = "stack"
    bidir = False

    def __init__(self, lstm, mlp):
        self.lstm, self.mlp = lstm, mlp

    def apply(self, variables, x, *, train):
        h, _ = self.lstm.apply(variables["lstm"], x, train=train)
        T, B, _ = h.shape
        y, _ = self.mlp.apply(variables["mlp"], h.reshape(T * B, -1),
                              train=train)
        return y.reshape(T, B, -1), {}

    def apply_streaming(self, variables, x, carries=None):
        h, carries = self.lstm.apply_streaming(variables["lstm"], x, carries)
        T, B, _ = h.shape
        y, _ = self.mlp.apply(variables["mlp"], h.reshape(T * B, -1),
                              train=False)
        return y.reshape(T, B, -1), carries


class TorchStack(torch.nn.Module):
    """The same LSTM -> MLP composition over the port's modules."""

    def __init__(self, lstm, mlp):
        super().__init__()
        self.lstm, self.mlp = lstm, mlp

    def forward(self, x):
        h = self.lstm(x)
        T, B, _ = h.shape
        return self.mlp(h.reshape(T * B, -1)).reshape(T, B, -1)

    def apply_streaming(self, x, carries=None):
        h, carries = self.lstm.apply_streaming(x, carries)
        T, B, _ = h.shape
        return self.mlp(h.reshape(T * B, -1)).reshape(T, B, -1), carries


def _log_priors(seed):
    p = np.random.RandomState(seed).rand(PHONES * SPP) + 0.2
    return np.log(p / p.sum()).astype(np.float32)


def test_recognizer_matches_jax_end_to_end():
    jstack, variables, tstack = _small_stack()
    priors = _log_priors(5)
    hmm_j, hmm_t = jvit.PhoneLoopHMM(PHONES, SPP), tvit.PhoneLoopHMM(PHONES, SPP)
    jf = jfe.Frontend(sample_rate=16000, num_mel_bins=MEL)
    tf = tfe.Frontend(sample_rate=16000, num_mel_bins=MEL)
    audio = _audio(3, 6400, seed=3)
    lens = [6400, 4000, 300]          # the last one is a single frame
    audio[1, 4000:] = 0.0
    audio[2, 300:] = 0.0
    jrec = jserve.Recognizer(jstack, variables, hmm_j, frontend=jf,
                             log_priors=priors, seq_model=True)
    trec = tserve.Recognizer(tstack, hmm_t, frontend=tf, log_priors=priors,
                             seq_model=True, device="cpu")
    logp_ref = np.asarray(jrec._build(3, 6400)(jnp.asarray(audio)))
    logp = trec.posteriors(audio).numpy()
    np.testing.assert_allclose(logp, logp_ref, atol=1e-4)
    got = trec.recognize(audio, lens)
    assert got == jrec.recognize(audio, lens)
    assert len(got[2]) == 1


def test_frame_wise_recognizer_with_deltas_matches_jax():
    """seq_model=False: the MLP takes flat frames; deltas widen the
    features to 3 x MEL."""
    mopts = {"to_do": "forward", "arch_name": "mlp",
             "dnn_lay": "20,%d" % (PHONES * SPP), "dnn_drop": "0.0,0.0",
             "dnn_use_batchnorm": "False,False",
             "dnn_use_laynorm": "False,False", "dnn_use_laynorm_inp": "False",
             "dnn_use_batchnorm_inp": "False", "dnn_act": "relu,softmax"}
    jm = JM.MLP(mopts, 3 * MEL)
    v = jm.init(2)
    v["params"]["w1"] = v["params"]["w1"] * 50.0     # a non-flat head
    tm = MLP(mopts, 3 * MEL, device="cpu").load_variables(
        convert.from_jax_variables(v))
    hmm_j, hmm_t = jvit.PhoneLoopHMM(PHONES, SPP), tvit.PhoneLoopHMM(PHONES, SPP)
    jf = jfe.Frontend(sample_rate=16000, num_mel_bins=MEL)
    tf = tfe.Frontend(sample_rate=16000, num_mel_bins=MEL)
    audio = _audio(2, 4800, seed=8)
    jrec = jserve.Recognizer(jm, v, hmm_j, frontend=jf, delta_order=2,
                             acwt=0.5)
    trec = tserve.Recognizer(tm, hmm_t, frontend=tf, delta_order=2, acwt=0.5,
                             device="cpu")
    np.testing.assert_allclose(
        trec.posteriors(audio).numpy(),
        np.asarray(jrec._build(2, 4800)(jnp.asarray(audio))), atol=1e-4)
    assert trec.recognize(audio) == jrec.recognize(audio)


def test_streaming_recognizer_matches_jax():
    jstack, variables, tstack = _small_stack(seed=4)
    priors = _log_priors(6)
    hmm_j, hmm_t = jvit.PhoneLoopHMM(PHONES, SPP), tvit.PhoneLoopHMM(PHONES, SPP)
    jrec = jserve.StreamingRecognizer(jstack, variables, hmm=hmm_j,
                                      log_priors=priors)
    trec = tserve.StreamingRecognizer(tstack, hmm=hmm_t, log_priors=priors,
                                      device="cpu")
    x = np.random.RandomState(7).randn(30, 2, MEL).astype(np.float32)
    js, ts = jrec.start(), trec.start()
    for a, b in ((0, 11), (11, 12), (12, 30)):
        out = trec.accept(ts, x[a:b])
        np.testing.assert_allclose(out, jrec.accept(js, jnp.asarray(x[a:b])),
                                   atol=1e-5)
    with torch.no_grad():
        full = tstack.eval()(torch.from_numpy(x)).numpy() - priors
    np.testing.assert_allclose(np.concatenate(ts["chunks"]), full, atol=1e-6)
    assert trec.partial(ts) == jrec.partial(js)
    assert trec.finalize(ts) == jrec.finalize(js)
    assert trec.finalize(ts, [30, 9]) == jrec.finalize(js, [30, 9])

