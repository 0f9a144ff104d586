#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   — nvcc builds every kernel from ``pytorch_kaldi_cgs_tpu_torch/
             ops/csrc`` into ``build/torch_kernels/``; prints the card.
2. kernels — each kernel against its plain PyTorch twin on the card, in
             every variant, at a small shape and at the serving shape.
3. serve   — ``Recognizer.recognize`` on 8 ragged 4 s utterances through
             the flagship 2x512 HCGS LSTM -> 1944-way MLP head (weights
             from ``init(0)``/``init(1)``), the launch counters read just
             before and after; the same recognizer on the CPU must agree.
4. stream  — ``StreamingRecognizer`` over the same features in chunks of
             100 frames: same posteriors, same phones.
5. entry   — the model forward at ``__graft_entry__.entry()``'s shape
             (T=200, B=8, F=143), kernel against the plain twin.
6. times   — CUDA-event times of the kernel, its twin and cuDNN's LSTM,
             and the recognizer's ms per batch and audio-s/s.

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

KERNELS = ["fused_lstm_fwd"]
SERVE_TBH = (398, 8, 512)        # 4 s at 16 kHz -> 398 frames, B=8, H=512
SMALL_TBH = (13, 5, 18)          # ragged: B not a multiple of 8, H of 4
SR, SECONDS, N_UTT = 16000, 4.0, 8
PHONES, SPP = 648, 3             # S = 1944 = the head's width

# Tolerances of kernel vs plain twin. float32: the recurrent dot sums in
# another order, compounded over the steps; with the 16-bit quantizer a
# one-ulp difference at a ceil step becomes one step (max|h|/2^15).
# bf16: the JAX package's bf16 bar (a one-ulp difference can round h to
# a neighbouring bf16 value).
TOL_F32_SMALL, TOL_F32_SERVE, TOL_BF16 = 1e-5, 1e-4, 2e-2
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


def flagship_options(feat_dim=40):
    """``__graft_entry__._flagship`` under to_do=forward: 2x512 LSTM, BN
    on the gate projections, HCGS 128/4 at 25/62.5% on x and h, 8-bit
    weights, tanh, drop 0, feeding the 1944-way log-softmax MLP head."""
    lstm = {
        "to_do": "forward", "arch_name": "LSTM_layers",
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
        "to_do": "forward", "arch_name": "MLP_out",
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
    lo, mo = flagship_options(feat_dim)
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


def lstm_bound_ms(T, B, H, dtype="f32"):
    """Least time for one layer call: each input read once, each output
    written once, over the HBM rate; the FMAs over the peak of their
    type. -> (ms, "bytes"|"operations")."""
    u_bytes = 2 if dtype == "bf16" else 4
    nbytes = (T * B * 4 * H + B * H + 2 * T * B * H) * 4 + 4 * H * H * u_bytes
    flops = 2 * T * B * H * 4 * H
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
    print("[times] recognizer (8 x 4 s batch): %s" % json.dumps(serve))
    return times, serve


def device_busy(fn):
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
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_name else None,
            "device_busy_share": busy_us / wall_us if by_name else None,
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "top_kernels_ms": [[name[:60], n, t / 1e3]
                               for name, (n, t) in top]}


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
    checks = phase_kernels(dev)
    audio, lens = make_audio()
    rec, phones, logp, launches, post_err = phase_serve(dev, audio, lens)
    stream_launches, _ = phase_stream(dev, rec, audio, lens, phones, logp)
    phase_entry(dev)
    times, serve = phase_times(dev, rec, audio, lens)
    main_variant = [c for c in checks if (c["T"], c["B"], c["H"]) == SERVE_TBH
                    and c["dtype"] == "f32" and c["carry"] == "zero"
                    and c["qbits"] == 0][0]
    print(json.dumps({"kernels": [{
        "name": "fused_lstm_fwd", "route": "cuda",
        "source": "pytorch_kaldi_cgs_tpu_torch/ops/csrc/fused_lstm_fwd.cu",
        "replaces": "pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:92",
        "launches": launches, "max_abs_err": main_variant["max_abs_err"],
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"], "ms_bf16": times["ms_bf16"],
        "stream_launches": stream_launches,
        "checks": len(checks), "checks_ok": all(c["ok"] for c in checks),
        "variants": sorted({"%s/%s/q%d/%s" % (c["dtype"], c["carry"],
                                              c["qbits"], c["act"])
                            for c in checks}),
        "serve": serve, "posteriors_vs_cpu_max_abs_err": post_err}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
