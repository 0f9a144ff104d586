#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the serving path and
the training step.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   — nvcc builds every kernel from ``pytorch_kaldi_cgs_tpu_torch/
             ops/csrc`` (one nvcc per source, in parallel) into
             ``build/torch_kernels/``; prints the card.
2. kernels — each kernel against its plain PyTorch twin on the card, in
             every variant: the forward at a small ragged shape and at the
             serving shape; the stash forward and both BPTT kernels at the
             small shape and at the training shape (T=300, B=16, H=512).
3. serve   — ``Recognizer.recognize`` on 8 ragged 4 s utterances through
             the flagship 2x512 HCGS LSTM -> 1944-way MLP head (weights
             from ``init(0)``/``init(1)``), the launch counters read just
             before and after; the same recognizer on the CPU must agree.
4. stream  — ``StreamingRecognizer`` over the same features in chunks of
             100 frames: same posteriors, same phones.
5. entry   — the model forward at ``__graft_entry__.entry()``'s shape
             (T=200, B=8, F=143), kernel against the plain twin.
6. train   — the flagship train step of ``bench.py`` (F=143, 2x512 HCGS +
             8-bit LSTM with BN, 1944-way head, T=300, B=16, RMSprop)
             through ``NetGraph`` + ``ChunkRunner`` on an in-memory chunk
             config: one step on the card against the same step on the
             CPU (loss and every gradient), launch counts per step with
             the stash and with the recompute backward, 10 steps on one
             batch in f32 and in bf16 (the loss must fall).
7. times   — CUDA-event times of every kernel, its twin, its bound and a
             cuDNN yardstick; the recognizer's ms per batch and audio-s/s;
             the train step's ms and frames/s and its device busy share.

The line before the last pair is the kernels JSON, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, ...}``. Needs
no network and one card; exits non-zero without one.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = ["fused_lstm_fwd", "fused_lstm_bwd"]
SERVE_TBH = (398, 8, 512)        # 4 s at 16 kHz -> 398 frames, B=8, H=512
TRAIN_TBH = (300, 16, 512)       # bench.py's flagship train step
SMALL_TBH = (13, 5, 18)          # ragged: B not a multiple of 8, H of 4
FEAT = 143                       # fMLLR-shaped training input
SR, SECONDS, N_UTT = 16000, 4.0, 8
PHONES, SPP = 648, 3             # S = 1944 = the head's width

# Tolerances of kernel vs plain twin. float32: the recurrent dot sums in
# another order, compounded over the steps; with the 16-bit quantizer a
# one-ulp difference at a ceil step becomes one step (max|h|/2^15).
# bf16: the JAX package's bf16 bar (a one-ulp difference can round h to
# a neighbouring bf16 value).
TOL_F32_SMALL, TOL_F32_SERVE, TOL_BF16 = 1e-5, 1e-4, 2e-2
# Backward kernels vs twins, as a share of the reference's largest
# magnitude (gradients scale with the upstream dhs): float32 1e-5 at the
# small shape, 1e-4 over the 300 reverse steps of the training shape;
# bf16 2e-2 (dg is rounded to bf16 before each dot, and an ulp of
# difference upstream can round it the other way).
# Train step, card vs CPU (cuBLAS vs the CPU's sgemm, BN sums in another
# order, 300 steps each way): loss within 1e-4 relative, each gradient
# within 1e-3 of its largest magnitude.
TOL_LOSS_REL, TOL_GRAD_REL = 1e-4, 1e-3
TRAIN_STEPS = 10
# Recognizer log-posteriors, card vs CPU: cuFFT vs pocketfft, cuBLAS vs
# the CPU's sgemm, then 398 recurrent steps.
TOL_POST = 1e-3
TOL_STREAM = 1e-5                # same kernels, chunked: row-count-dependent GEMMs
# init(1)'s head, U(+-sqrt(0.01/(512+1944))), moves the log-posteriors by
# ~6e-4 across classes: every utterance would decode to one phone. The
# smoke scales that head so its logits spread ~0.6, and the decode is a
# real check.
HEAD_GAIN = 1000.0
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FLOPS = {"f32": 67e12, "bf16": 989e12}   # f32 without tensor cores


def flagship_options(to_do="forward", compute_dtype=""):
    """``__graft_entry__._flagship``: 2x512 LSTM, BN on the gate
    projections, HCGS 128/4 at 25/62.5% on x and h, 8-bit weights, tanh,
    drop 0, feeding the 1944-way log-softmax MLP head."""
    lstm = {
        "to_do": to_do, "compute_dtype": compute_dtype,
        "arch_name": "LSTM_layers",
        "lstm_lay": "512,512", "lstm_drop": "0.0,0.0",
        "lstm_use_batchnorm": "True,True", "lstm_use_laynorm": "False,False",
        "lstm_use_laynorm_inp": "False", "lstm_use_batchnorm_inp": "False",
        "lstm_act": "tanh,tanh", "lstm_orthinit": "True",
        "lstm_bidir": "False", "lstm_hcgs": "True",
        "hcgsx_block": "128,4", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "128,4", "hcgsh_sparse": "25,62.5",
        "lstm_quant": "True", "param_quant": "8,8",
        "lstm_quant_inp": "False", "inp_quant": "16",
        "lstm_prune": "False", "lstm_prune_perc": "50",
        "skip_regularization": "True"}
    mlp = {
        "to_do": to_do, "compute_dtype": compute_dtype,
        "arch_name": "MLP_out",
        "dnn_lay": str(PHONES * SPP), "dnn_drop": "0.0",
        "dnn_use_batchnorm": "False", "dnn_use_laynorm": "False",
        "dnn_use_laynorm_inp": "False", "dnn_use_batchnorm_inp": "False",
        "dnn_act": "softmax"}
    return lstm, mlp


class Stack(torch.nn.Module):
    """LSTM -> MLP head over (T, B, F) sequences."""

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


def build_stack(dev, feat_dim=40):
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP
    lo, mo = flagship_options()
    lstm = LSTM(lo, feat_dim, seed=0, device=dev)
    mlp = MLP(mo, lstm.out_dim, seed=1, device=dev)
    with torch.no_grad():
        mlp.params["w0"].mul_(HEAD_GAIN)
    return Stack(lstm, mlp).eval()


def build_recognizer(dev):
    from pytorch_kaldi_cgs_tpu_torch.decode.viterbi import PhoneLoopHMM
    from pytorch_kaldi_cgs_tpu_torch.ops.frontend import Frontend
    from pytorch_kaldi_cgs_tpu_torch.runtime.serve import Recognizer
    p = np.random.RandomState(2).rand(PHONES * SPP) + 0.1
    log_priors = np.log(p / p.sum()).astype(np.float32)
    return Recognizer(build_stack(dev), PhoneLoopHMM(PHONES, SPP),
                      frontend=Frontend(sample_rate=SR, num_mel_bins=40),
                      log_priors=log_priors, seq_model=True, device=dev)


def make_audio():
    """8 utterances of 4 s at 16 kHz, true lengths 64000 down to 36000
    samples, zero-padded: a tone sweep plus noise, from a seed."""
    n = int(SR * SECONDS)
    rng = np.random.RandomState(0)
    lens = np.linspace(n, 36000, N_UTT).astype(int)
    t = np.arange(n) / SR
    f0 = rng.uniform(150, 400, (N_UTT, 1))
    audio = (np.sin(2 * np.pi * f0 * t * (1 + t / 8)) * 0.3
             + rng.randn(N_UTT, n) * 0.05).astype(np.float32)
    for b, L in enumerate(lens):
        audio[b, L:] = 0.0
    return audio, lens


def lstm_inputs(T, B, H, seed, dev, drop_bh):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    g = t(rng.randn(T, B, 4 * H) * 0.5)
    U = t(rng.randn(4 * H, H) / np.sqrt(H))
    drop = t((rng.rand(B, H) > 0.2) * 1.0) if drop_bh else t(np.full((1, 1), 0.8))
    return g, U, drop, t(rng.randn(B, H) * 0.3), t(rng.randn(B, H) * 0.3)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    for name, log in logs.items():
        print("[build] %s.cu (nvcc -Xptxas -v):\n%s" % (name, log.strip()))
    print("[build] %d kernel source(s) in %.1f s -> %s"
          % (len(KERNELS), time.perf_counter() - t0, _build.BUILD_DIR))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print("[build] card: %s" % smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_kernels(dev, shapes=(SMALL_TBH, SERVE_TBH)):
    """Kernel vs plain twin in every variant; returns the checks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    checks = []
    for (T, B, H) in shapes:
        serve = (T, B, H) == SERVE_TBH
        cases = [(bf16, seeded, qbits, "tanh")
                 for bf16 in (False, True) for seeded in (False, True)
                 for qbits in (0, 16)]
        if not serve:
            cases += [(False, True, 16, a) for a in ("relu", "htanh", "linear")]
        for k, (bf16, seeded, qbits, act) in enumerate(cases):
            g, U, drop, h0, c0 = lstm_inputs(T, B, H, 10 + k, dev,
                                             drop_bh=not serve)
            carry = (h0, c0) if seeded else (None, None)
            with torch.no_grad():
                hs, cs = F.fused_lstm_fwd(g, U, drop, *carry, act=act,
                                          qbits=qbits, bf16=bf16)
                hp, cp = F.fused_lstm_fwd_plain(g, U, drop, *carry, act,
                                                qbits, bf16)
            sync(dev)
            err = max(float((hs - hp).abs().max()), float((cs - cp).abs().max()))
            tol = TOL_BF16 if bf16 else (TOL_F32_SERVE if serve else TOL_F32_SMALL)
            ok = bool(np.isfinite(err) and err <= tol)
            c = {"T": T, "B": B, "H": H, "dtype": "bf16" if bf16 else "f32",
                 "carry": "seeded" if seeded else "zero", "qbits": qbits,
                 "act": act, "drop": "(1,1)" if serve else "(B,H)",
                 "max_abs_err": err, "tol": tol, "ok": ok}
            checks.append(c)
            print("[kernels] fused_lstm_fwd %s" % json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("fused_lstm_fwd disagrees with its plain twin: %s"
                             % bad)
    return checks


def phase_serve(dev, audio, lens):
    """The main path: Recognizer.recognize, launch counter read around
    it; then the same recognizer on the CPU (plain twin)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    rec = build_recognizer(dev)
    T_frames = rec.frontend.num_frames(audio.shape[1])
    F.fused_lstm_fwd.launches = 0
    phones = rec.recognize(audio, lens)
    launches = F.fused_lstm_fwd.launches
    print("[serve] recognize: fused_lstm_fwd launches %d (2 layers x %d steps)"
          % (launches, T_frames))
    if torch.device(dev).type == "cuda" and launches != 2 * T_frames:
        raise AssertionError("the main path did not run the kernel: %d "
                             "launches, expected %d" % (launches, 2 * T_frames))
    logp = rec.posteriors(audio)
    if tuple(logp.shape) != (N_UTT, T_frames, PHONES * SPP) or \
            not bool(torch.isfinite(logp).all()):
        raise AssertionError("bad posteriors: %s" % (tuple(logp.shape),))
    ref = build_recognizer("cpu")
    logp_ref = ref.posteriors(audio)
    err = float((logp.cpu() - logp_ref.cpu()).abs().max())
    phones_ref = ref.recognize(audio, lens)
    print("[serve] log-posteriors %s vs %s: max abs err %.3g (tol %g); "
          "phones equal: %s; phones per utt: %s"
          % (dev, "cpu", err, TOL_POST, phones == phones_ref,
             [len(p) for p in phones]))
    if not err <= TOL_POST:
        raise AssertionError("recognizer posteriors disagree with the CPU")
    if phones != phones_ref:
        raise AssertionError("recognizer phones disagree with the CPU")
    return rec, phones, logp, launches, err


def phase_stream(dev, rec, audio, lens, phones, logp, chunk=100):
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.runtime.serve import StreamingRecognizer
    srec = StreamingRecognizer(rec.model, hmm=rec.hmm,
                               log_priors=rec.log_priors.cpu().numpy(),
                               device=dev)
    x = rec.features(audio).transpose(0, 1).contiguous()      # (T, B, F)
    T = x.shape[0]
    F.fused_lstm_fwd.launches = 0
    sess = srec.start()
    for a in range(0, T, chunk):
        srec.accept(sess, x[a:a + chunk])
    launches = F.fused_lstm_fwd.launches
    streamed = np.concatenate(sess["chunks"]).transpose(1, 0, 2)
    err = float(np.abs(streamed - logp.cpu().numpy()).max())
    final = srec.finalize(sess, rec.frame_lengths(N_UTT, audio.shape[1], lens))
    print("[stream] %d chunks of <=%d frames: launches %d; streamed vs "
          "whole max abs err %.3g (tol %g); finalize == recognize: %s"
          % (-(-T // chunk), chunk, launches, err, TOL_STREAM,
             final == phones))
    if torch.device(dev).type == "cuda" and launches != 2 * T:
        raise AssertionError("streaming did not run the kernel")
    if not err <= TOL_STREAM or final != phones:
        raise AssertionError("streaming disagrees with the whole utterance")
    return launches, err


@contextlib.contextmanager
def plain_twin_on_card():
    """Route the model's recurrence through the plain twin on the same
    tensors (the kernel's comparison, not a path of the port)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    kernel = F.fused_lstm_fwd

    def plain(gates, U, drop, h0=None, c0=None, act="tanh", qbits=0,
              bf16=False):
        return F.fused_lstm_fwd_plain(gates, U, drop, h0, c0, act, qbits, bf16)

    F.fused_lstm_fwd = plain
    try:
        yield
    finally:
        F.fused_lstm_fwd = kernel


def phase_entry(dev, T=200, B=8, F_in=143):
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    stack = build_stack(dev, feat_dim=F_in)
    x = torch.tensor(np.random.RandomState(0).randn(T, B, F_in)
                     .astype(np.float32), device=dev)
    with torch.inference_mode():
        before = F.fused_lstm_fwd.launches
        y = stack(x)
        launched = F.fused_lstm_fwd.launches - before
        with plain_twin_on_card():
            y_plain = stack(x)
    sync(dev)
    err = float((y - y_plain).abs().max())
    print("[entry] T=%d B=%d F=%d -> %s: kernel launches %d, kernel vs plain "
          "max abs err %.3g (tol %g)" % (T, B, F_in, tuple(y.shape), launched,
                                         err, TOL_F32_SERVE))
    if torch.device(dev).type == "cuda" and launched != 2 * T:
        raise AssertionError("the entry-shape forward did not run the kernel")
    if tuple(y.shape) != (T, B, PHONES * SPP) or not bool(
            torch.isfinite(y).all()) or not err <= TOL_F32_SERVE:
        raise AssertionError("entry-shape forward failed")
    return err


def shifted(hs, cs, h0, c0):
    """The carries entering each step: (h_prev, c_prev)."""
    z = torch.zeros_like(hs[:1])
    return (torch.cat([z if h0 is None else h0[None], hs[:-1]]),
            torch.cat([z if c0 is None else c0[None], cs[:-1]]))


def rel_err(got, ref):
    """(max abs error, that error over the reference's largest |value|)
    over matching tuples of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    return err, err / max(scale, 1e-30)


def phase_train_kernels(dev, shapes=(SMALL_TBH, TRAIN_TBH)):
    """The stash forward and both BPTT kernels against their twins, on
    the same tensors, in every variant; returns the checks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    checks = []
    for (T, B, H) in shapes:
        small = (T, B, H) == SMALL_TBH
        cases = [(bf16, seeded, qbits, "tanh")
                 for bf16 in (False, True) for seeded in (False, True)
                 for qbits in (0, 16)]
        if small:
            cases += [(False, True, 16, a) for a in ("relu", "htanh", "linear")]
        for k, (bf16, seeded, qbits, act) in enumerate(cases):
            g, U, drop, h0, c0 = lstm_inputs(T, B, H, 40 + k, dev, drop_bh=True)
            rng = np.random.RandomState(60 + k)
            t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
            dhs = t(rng.randn(T, B, H) * 0.1)
            carry = (h0, c0) if seeded else (None, None)
            seeds = ((t(rng.randn(B, H) * 0.1), t(rng.randn(B, H) * 0.1))
                     if seeded else (None, None))
            with torch.no_grad():
                hs, cs, acts = F.fused_lstm_fwd(g, U, drop, *carry, act=act,
                                                qbits=qbits, bf16=bf16,
                                                stash=True)
                errs = {"fused_lstm_fwd/stash": rel_err(
                    (hs, cs, acts), F.fused_lstm_fwd_plain(
                        g, U, drop, *carry, act, qbits, bf16, True))}
                h_prev, c_prev = shifted(hs, cs, *carry)
                errs["fused_lstm_bwd_stash"] = rel_err(
                    F.fused_lstm_bwd_stash(acts, U, drop, cs, c_prev, dhs,
                                           *seeds, act=act, bf16=bf16),
                    F.fused_lstm_bwd_stash_plain(acts, U, drop, cs, c_prev,
                                                 dhs, *seeds, act=act,
                                                 bf16=bf16))
                errs["fused_lstm_bwd"] = rel_err(
                    F.fused_lstm_bwd(g, U, drop, h_prev, c_prev, dhs, *seeds,
                                     act=act, qbits=qbits, bf16=bf16),
                    F.fused_lstm_bwd_plain(g, U, drop, h_prev, c_prev, dhs,
                                           *seeds, act=act, qbits=qbits,
                                           bf16=bf16))
            sync(dev)
            tol = TOL_BF16 if bf16 else (TOL_F32_SMALL if small
                                         else TOL_F32_SERVE)
            for name, (err, rel) in errs.items():
                # the forward's bar is absolute (as at the serving
                # shape), the backward's relative to the gradients' scale
                ok = (err if name.startswith("fused_lstm_fwd") else rel) <= tol
                c = {"kernel": name, "T": T, "B": B, "H": H,
                     "dtype": "bf16" if bf16 else "f32",
                     "carry": "seeded" if seeded else "zero", "qbits": qbits,
                     "act": act, "max_abs_err": err, "rel_err": rel,
                     "tol": tol, "ok": bool(np.isfinite(err) and ok)}
                checks.append(c)
                print("[kernels] %s" % json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a training kernel disagrees with its plain "
                             "twin: %s" % bad)
    return checks


TRAIN_CFG = """[exp]
to_do = train
seed = 0

[batches]
batch_size_train = {B}

[data_chunk]
fea = fea_name=fea
\tfea_lst=none
\tfea_opts=none
\tcw_left=0
\tcw_right=0
lab = lab_name=lab_cd
\tlab_folder=none
\tlab_opts=ali-to-pdf

[architecture1]
{lstm}

[architecture2]
{mlp}

[model]
model_proto = proto/model.proto
model = out_rnn=compute(LSTM_layers,fea)
\tout_dnn1=compute(MLP_out,out_rnn)
\tloss_final=cost_nll(out_dnn1,lab_cd)
\terr_final=cost_err(out_dnn1,lab_cd)
"""


def train_setup(compute_dtype=""):
    """bench.py's flagship train step as a chunk config + chunk: the
    flagship options with to_do=train, RMSprop lr 0.0016 alpha 0.95 eps
    1e-8, inputs x ~ N(0, 1) (T, B, 143) and labels in [0, 1944) from
    RandomState(0), as bench.py draws them; 16 sentences of 300 frames.
    -> (config, chunk, (inp, mask) of the one batch)."""
    import configparser
    from pytorch_kaldi_cgs_tpu_torch.data.dataset import (ChunkData,
                                                          FeaStream,
                                                          LabStream)
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import make_seq_batches
    T, B, _ = TRAIN_TBH
    lo, mo = flagship_options("train", compute_dtype)
    opt = {"arch_lr": "0.0016", "arch_opt": "rmsprop", "opt_momentum": "0.0",
           "opt_alpha": "0.95", "opt_eps": "1e-8", "opt_centered": "False",
           "opt_weight_decay": "0.0", "arch_freeze": "False",
           "arch_library": "pytorch_kaldi_cgs_tpu_torch.models"}
    lo = dict(lo, arch_class="LSTM", arch_seq_model="True", **opt)
    mo = dict(mo, arch_class="MLP", arch_seq_model="False", **opt)
    fmt = lambda d: "\n".join("%s = %s" % kv for kv in d.items())
    config = configparser.ConfigParser()
    config.read_string(TRAIN_CFG.format(B=B, lstm=fmt(lo), mlp=fmt(mo)))
    rng = np.random.RandomState(0)
    x = rng.randn(T, B, FEAT).astype(np.float32)
    labels = rng.randint(0, PHONES * SPP, (T, B))
    data = np.concatenate([np.concatenate([x[:, b], labels[:, b, None]], 1)
                           for b in range(B)]).astype(np.float32)
    chunk = ChunkData(["utt%02d" % b for b in range(B)], data,
                      np.cumsum([T] * B),
                      {"fea": FeaStream("fea", "none", col_start=0,
                                        col_end=FEAT)},
                      {"lab_cd": LabStream("lab_cd", "none", col=FEAT)})
    inp, mask, _, _ = next(make_seq_batches(chunk, B, True,
                                            np.random.RandomState(0),
                                            bucket=T))
    assert inp.shape == (T, B, FEAT + 1) and mask.all()
    np.testing.assert_array_equal(inp[..., :FEAT], x)
    return config, chunk, (inp, mask)


def train_runner(dev, compute_dtype=""):
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = train_setup(compute_dtype)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    return ChunkRunner(graph, config), batch


def counted(fn):
    """Run fn with every kernel's launch counter set to 0 just before and
    read just after. -> (fn's result, {kernel: launches})."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    wrappers = {"fused_lstm_fwd": F.fused_lstm_fwd,
                "fused_lstm_bwd_stash": F.fused_lstm_bwd_stash,
                "fused_lstm_bwd": F.fused_lstm_bwd}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: w.launches for n, w in wrappers.items()}


@contextlib.contextmanager
def recompute_backward(on):
    """PKC_LSTM_BWD_RECOMPUTE, the JAX package's knob for the backward."""
    old = os.environ.get("PKC_LSTM_BWD_RECOMPUTE")
    os.environ["PKC_LSTM_BWD_RECOMPUTE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PKC_LSTM_BWD_RECOMPUTE"]
        else:
            os.environ["PKC_LSTM_BWD_RECOMPUTE"] = old


def grads_of(runner):
    return {"%s/%s" % (a, k): p.grad for a, net in runner.graph.nets.items()
            for k, p in net.params.items()}


def phase_train(dev):
    """The main training path: ChunkRunner.train_step on the card. One
    step against the CPU, launches per step (stash and recompute), then
    TRAIN_STEPS steps on the one batch in f32 and bf16."""
    T, B, H = TRAIN_TBH
    out = {}
    runner, (inp, mask) = train_runner(dev)
    with recompute_backward(False):
        (loss, err), launches = counted(lambda: runner.train_step(inp, mask))
    out["launches_stash"] = launches
    print("[train] step (stash backward): loss %.6f err %.4f, launches %s"
          % (float(loss), float(err), launches))
    expect = {"fused_lstm_fwd": 2 * T, "fused_lstm_bwd_stash": 2 * T,
              "fused_lstm_bwd": 0}
    if launches != expect:
        raise AssertionError("train step launches %s, expected %s"
                             % (launches, expect))
    cpu, _ = train_runner("cpu")
    with recompute_backward(False):
        loss_c, err_c = cpu.train_step(inp, mask)
    g_dev, g_cpu = grads_of(runner), grads_of(cpu)
    grad_errs = {k: float((g_dev[k].cpu() - g_cpu[k]).abs().max())
                 / max(float(g_cpu[k].abs().max()), 1e-30) for k in g_cpu}
    loss_rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    worst = max(grad_errs, key=grad_errs.get)
    out.update(loss_card=float(loss), loss_cpu=float(loss_c),
               err_card=float(err), err_cpu=float(err_c),
               loss_rel_err=loss_rel, grads_compared=len(grad_errs),
               grad_rel_err_max=grad_errs[worst], grad_rel_err_worst=worst)
    print("[train] card vs CPU: loss %.7f vs %.7f (rel %.3g, tol %g); %d "
          "gradients, worst rel err %.3g at %s (tol %g)"
          % (float(loss), float(loss_c), loss_rel, TOL_LOSS_REL,
             len(grad_errs), grad_errs[worst], worst, TOL_GRAD_REL))
    if not (loss_rel <= TOL_LOSS_REL and grad_errs[worst] <= TOL_GRAD_REL
            and abs(float(err) - float(err_c)) <= 1.0 / (T * B) + 1e-7):
        raise AssertionError("train step on the card disagrees with the CPU")
    with recompute_backward(True):
        (loss_r, _), launches = counted(lambda: runner.train_step(inp, mask))
    out["launches_recompute"] = launches
    print("[train] step (recompute backward): loss %.6f, launches %s"
          % (float(loss_r), launches))
    expect = {"fused_lstm_fwd": 2 * T, "fused_lstm_bwd_stash": 0,
              "fused_lstm_bwd": 2 * T}
    if launches != expect:
        raise AssertionError("recompute train step launches %s, expected %s"
                             % (launches, expect))
    for cdt in ("", "bf16"):
        r, (inp, mask) = train_runner(dev, cdt)
        losses = [float(r.train_step(inp, mask)[0])
                  for _ in range(TRAIN_STEPS)]
        name = "bf16" if cdt else "f32"
        out["losses_" + name] = losses
        print("[train] %s: %d steps on one batch, loss %s"
              % (name, TRAIN_STEPS, ["%.4f" % v for v in losses]))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError("%s training loss did not fall" % name)
    return out


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lstm_bound_ms(T, B, H, dtype="f32", kind="fwd"):
    """Least time for one layer call: each input read once, each output
    written once, over the HBM rate; the FMAs over the peak of their
    type. kind: "fwd" (gates, drop, U in; hs, cs out), "fwd_stash" (and
    the (T, B, 4H) activations out), "bwd_stash" (activations, cs,
    c_prev, dhs, drop, U in; dg out; one (B, 4H) x (4H, H) product per
    step), "bwd" (gates, h_prev, c_prev, dhs, drop, U in; dg out; that
    product and the forward's). -> (ms, "bytes"|"operations")."""
    u_bytes = 2 if dtype == "bf16" else 4
    gates, seq, bh = T * B * 4 * H * 4, T * B * H * 4, B * H * 4
    nbytes = {"fwd": gates + bh + 2 * seq,
              "fwd_stash": 2 * gates + bh + 2 * seq,
              "bwd_stash": 2 * gates + bh + 3 * seq,
              "bwd": 2 * gates + bh + 3 * seq}[kind] + 4 * H * H * u_bytes
    flops = 2 * T * B * H * 4 * H * (2 if kind == "bwd" else 1)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(dev, rec, audio, lens):
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = SERVE_TBH
    g, U, drop, _, _ = lstm_inputs(T, B, H, 99, dev, drop_bh=False)
    times = {}
    with torch.no_grad():
        times["ms"] = cuda_ms(lambda: F.fused_lstm_fwd(g, U, drop), reps=20)
        times["plain_ms"] = cuda_ms(
            lambda: F.fused_lstm_fwd_plain(g, U, drop, None, None, "tanh", 0,
                                           False), reps=3, warmup=1)
        cudnn = torch.nn.LSTM(H, H).to(dev).eval()
        xin = torch.randn(T, B, H, device=dev)
        times["library_ms"] = cuda_ms(lambda: cudnn(xin), reps=20)
        times["ms_bf16"] = cuda_ms(
            lambda: F.fused_lstm_fwd(g, U, drop, bf16=True), reps=20)
    times["bound_ms"], times["bound_by"] = lstm_bound_ms(T, B, H)
    print("[times] fused_lstm_fwd at T=%d B=%d H=%d: kernel %.3f ms "
          "(bf16 dots %.3f ms), plain twin %.3f ms, cuDNN nn.LSTM %.3f ms, "
          "bound %.4f ms (%s)" % (T, B, H, times["ms"], times["ms_bf16"],
                                  times["plain_ms"], times["library_ms"],
                                  times["bound_ms"], times["bound_by"]))

    def wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    from pytorch_kaldi_cgs_tpu_torch.decode.viterbi import \
        batched_viterbi_decode
    rec_ms = wall(lambda: rec.recognize(audio, lens))
    post_ms = wall(lambda: rec.posteriors(audio))
    feat_ms = wall(lambda: rec.features(audio))
    logp = rec.posteriors(audio)
    frames = rec.frame_lengths(N_UTT, audio.shape[1], lens)
    dec_ms = wall(lambda: batched_viterbi_decode(logp, frames, rec.hmm,
                                                 acwt=rec.acwt))
    med = float(np.median(rec_ms))
    padded_s = N_UTT * SECONDS
    speech_s = float(np.sum(lens)) / SR
    serve = {"recognize_ms_runs": rec_ms, "recognize_ms_median": med,
             "features_ms_median": float(np.median(feat_ms)),
             "posteriors_ms_median": float(np.median(post_ms)),
             "decode_ms_median": float(np.median(dec_ms)),
             "audio_s_per_s_padded": padded_s / (med / 1e3),
             "audio_s_per_s_speech": speech_s / (med / 1e3)}
    serve.update(device_busy(lambda: rec.recognize(audio, lens)))
    serve.pop("by_name")
    print("[times] recognizer (8 x 4 s batch): %s" % json.dumps(serve))
    return times, serve


def phase_train_times(dev):
    """CUDA-event times at the training shape: each kernel per layer call
    (f32 and bf16), its twin, its bound, cuDNN's nn.LSTM as a yardstick;
    the flagship train step in f32 and bf16 with its device busy share
    and where its time goes."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = TRAIN_TBH
    g, U, drop, _, _ = lstm_inputs(T, B, H, 98, dev, drop_bh=True)
    dhs = torch.randn(T, B, H, device=dev) * 0.01
    times = {}
    with torch.no_grad():
        for bf16 in (False, True):
            sfx = "_bf16" if bf16 else ""
            hs, cs, acts = F.fused_lstm_fwd(g, U, drop, bf16=bf16, stash=True)
            h_prev, c_prev = shifted(hs, cs, None, None)
            calls = {
                "fused_lstm_fwd": lambda: F.fused_lstm_fwd(
                    g, U, drop, bf16=bf16, stash=True),
                "fused_lstm_bwd_stash": lambda: F.fused_lstm_bwd_stash(
                    acts, U, drop, cs, c_prev, dhs, bf16=bf16),
                "fused_lstm_bwd": lambda: F.fused_lstm_bwd(
                    g, U, drop, h_prev, c_prev, dhs, bf16=bf16)}
            plain = {
                "fused_lstm_fwd": lambda: F.fused_lstm_fwd_plain(
                    g, U, drop, None, None, "tanh", 0, bf16, True),
                "fused_lstm_bwd_stash": lambda: F.fused_lstm_bwd_stash_plain(
                    acts, U, drop, cs, c_prev, dhs, bf16=bf16),
                "fused_lstm_bwd": lambda: F.fused_lstm_bwd_plain(
                    g, U, drop, h_prev, c_prev, dhs, bf16=bf16)}
            kinds = {"fused_lstm_fwd": "fwd_stash",
                     "fused_lstm_bwd_stash": "bwd_stash",
                     "fused_lstm_bwd": "bwd"}
            for name, fn in calls.items():
                times[name + "_ms" + sfx] = cuda_ms(fn, reps=10)
                times[name + "_plain_ms" + sfx] = cuda_ms(plain[name], reps=2,
                                                          warmup=1)
                bound, by = lstm_bound_ms(T, B, H, "bf16" if bf16 else "f32",
                                          kinds[name])
                times[name + "_bound_ms" + sfx] = bound
                times[name + "_bound_by" + sfx] = by
    cudnn = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev, requires_grad=True)
    dy = torch.randn(T, B, H, device=dev)
    fwd_ms = cuda_ms(lambda: cudnn(x)[0], reps=10)
    fb_ms = cuda_ms(lambda: cudnn(x)[0].backward(dy), reps=10)
    times.update(cudnn_fwd_ms=fwd_ms, cudnn_fwd_bwd_ms=fb_ms,
                 cudnn_bwd_ms=fb_ms - fwd_ms)
    # the dU product outside the BPTT kernel: (4H, T*B) @ (T*B, H)
    dg = torch.randn(T * B, 4 * H, device=dev)
    hq = torch.randn(T * B, H, device=dev)
    times["dU_matmul_ms"] = cuda_ms(lambda: dg.T @ hq, reps=20)
    print("[times] kernels at T=%d B=%d H=%d: %s" % (T, B, H,
                                                    json.dumps(times)))
    step = {}
    for cdt in ("", "bf16"):
        name = "bf16" if cdt else "f32"
        runner, (inp, mask) = train_runner(dev, cdt)
        inp = torch.as_tensor(inp, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        ms = cuda_ms(lambda: runner.train_step(inp, mask), reps=10)
        step[name] = {"step_ms": ms, "frames_per_s": T * B / (ms / 1e3)}
        step[name].update(step_parts(runner, inp, mask))
        busy = device_busy(lambda: runner.train_step(inp, mask), top=10)
        busy["device_ms_by_class"] = kernel_classes(busy.pop("by_name"))
        step[name].update(busy)
        print("[times] train step %s: %s" % (name, json.dumps(step[name])))
    return times, step


def step_parts(runner, inp, mask, reps=5):
    """ChunkRunner.train_step's three parts timed apart with CUDA events
    (median ms of reps): graph forward, backward, optimizer steps."""
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for opt in runner.optimizers.values():
            opt.zero_grad(set_to_none=True)
        ev[0].record()
        outs = runner.graph.forward(inp, train=True, frame_mask=mask)
        ev[1].record()
        outs["loss_final"].backward()
        ev[2].record()
        for opt in runner.optimizers.values():
            opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, zip(ev, ev[1:])):
            parts[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in parts.items()}


def kernel_classes(by_name):
    """Device ms per class of kernel, from the profile's kernel names."""
    classes = {"lstm_fwd_kernel": ("lstm_step",),
               "lstm_bptt_kernel": ("lstm_bwd",),
               "matmul": ("gemm", "cutlass", "sm90_", "ampere_", "cublas"),
               }
    out = {k: 0.0 for k in classes}
    out["other"] = 0.0
    for name, (_, us) in by_name.items():
        low = name.lower()
        cls = next((k for k, subs in classes.items()
                    if any(sub in low for sub in subs)), "other")
        out[cls] += us / 1e3
    return out


def device_busy(fn, top=6):
    """One call under torch.profiler: the share of its wall time the
    card spent in kernels (one stream, so kernels do not overlap) and
    the kernels that took most of it. None where the trace shows no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        # kernels and copies only: a user annotation (the optimizer's
        # record_function range) spans kernels already counted
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_us = sum(t for _, t in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_name else None,
            "device_busy_share": busy_us / wall_us if by_name else None,
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "top_kernels_ms": [[name[:60], n, t / 1e3]
                               for name, (n, t) in ranked[:top]],
            "by_name": by_name}


def kernels_line(fwd_checks, train_checks, serve_times, times, launches):
    """The kernels JSON: every kernel of the port with its numbers from
    this run. ``ms``/``plain_ms``/``bound_ms``/``library_ms`` are per layer
    call at the training shape (f32); ``launches`` counts the main path
    that runs the kernel: one train step (stash backward; the recompute
    backward for fused_lstm_bwd); ``launches_by_path`` all paths."""
    T, B, H = TRAIN_TBH

    def err_at(kernel):
        return [c for c in train_checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == TRAIN_TBH
                and c["dtype"] == "f32" and c["carry"] == "zero"
                and c["qbits"] == 0][0]["max_abs_err"]

    def row(name, replaces, library_ms, **extra):
        checks = [c for c in train_checks if c["kernel"].startswith(name)]
        r = {"name": name, "route": "cuda",
             "source": "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"
             % ("fused_lstm_fwd" if name == "fused_lstm_fwd"
                else "fused_lstm_bwd"),
             "replaces": "pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:%d" % replaces,
             "launches": launches[name]["train"],
             "launches_by_path": launches[name],
             "max_abs_err": err_at(name if name != "fused_lstm_fwd"
                                   else "fused_lstm_fwd/stash"),
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "ms_bf16": times[name + "_ms_bf16"],
             "bound_ms_bf16": times[name + "_bound_ms_bf16"],
             "shape": {"T": T, "B": B, "H": H},
             "checks": len(checks), "checks_ok": all(c["ok"] for c in checks)}
        r.update(extra)
        return r

    main_fwd = [c for c in fwd_checks if (c["T"], c["B"], c["H"]) == SERVE_TBH
                and c["dtype"] == "f32" and c["carry"] == "zero"
                and c["qbits"] == 0][0]
    fwd = row("fused_lstm_fwd", 92, times["cudnn_fwd_ms"],
              variant="stash (training forward)",
              serve={"T": SERVE_TBH[0], "B": SERVE_TBH[1], "H": SERVE_TBH[2],
                     "ms": serve_times["ms"],
                     "ms_bf16": serve_times["ms_bf16"],
                     "plain_ms": serve_times["plain_ms"],
                     "bound_ms": serve_times["bound_ms"],
                     "bound_by": serve_times["bound_by"],
                     "library_ms": serve_times["library_ms"],
                     "max_abs_err": main_fwd["max_abs_err"],
                     "checks": len(fwd_checks),
                     "checks_ok": all(c["ok"] for c in fwd_checks)})
    return {"kernels": [
        fwd,
        row("fused_lstm_bwd_stash", 339, times["cudnn_bwd_ms"],
            library_note="cuDNN nn.LSTM backward (fwd+bwd minus fwd)"),
        row("fused_lstm_bwd", 218, times["cudnn_bwd_ms"],
            library_note="cuDNN nn.LSTM backward (fwd+bwd minus fwd)")]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = "cuda"
    print("[env] python %s, torch %s, CUDA %s, %s x%d" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    smi = phase_build()
    fwd_checks = phase_kernels(dev)
    train_checks = phase_train_kernels(dev)
    audio, lens = make_audio()
    rec, phones, logp, serve_launches, post_err = phase_serve(dev, audio, lens)
    stream_launches, _ = phase_stream(dev, rec, audio, lens, phones, logp)
    phase_entry(dev)
    train = phase_train(dev)
    serve_times, serve = phase_times(dev, rec, audio, lens)
    serve["posteriors_vs_cpu_max_abs_err"] = post_err
    times, step = phase_train_times(dev)
    launches = {
        "fused_lstm_fwd": {"train": train["launches_stash"]["fused_lstm_fwd"],
                           "train_recompute":
                               train["launches_recompute"]["fused_lstm_fwd"],
                           "serve": serve_launches, "stream": stream_launches},
        "fused_lstm_bwd_stash": {
            "train": train["launches_stash"]["fused_lstm_bwd_stash"]},
        "fused_lstm_bwd": {
            "train": train["launches_recompute"]["fused_lstm_bwd"]}}
    for name, paths in launches.items():
        if not paths["train"]:
            raise AssertionError("%s was not launched on its path" % name)
    print("[summary] %s" % json.dumps({
        "serve": serve, "train": train, "train_step": step,
        "cudnn_yardstick": {k: times[k] for k in (
            "cudnn_fwd_ms", "cudnn_fwd_bwd_ms", "cudnn_bwd_ms")},
        "dU_matmul_ms": times["dU_matmul_ms"]}))
    print(json.dumps(kernels_line(fwd_checks, train_checks, serve_times,
                                  times, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
