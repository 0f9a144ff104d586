"""Where a step of the dense persistent GRU forward (``gru_dense_fwd_persist``
in ``pytorch_kaldi_cgs_tpu_torch/ops/csrc/fused_gru.cu``, TPU rows 19 and
24, over the dots and the quantizer's pass of ``csrc/persist.cuh``)
spends its time, on one CUDA card: variants of those sources are
written into a temporary directory (the checkout's files do not change),
each built into a library of its own and timed at the TIMIT GRU's
training shape (row 19: T=300, B=8, H=550, tanh) and the minimalGRU's
(row 24: T=300, B=8, H=1024, relu), with and without the 16-bit
quantizer (ms a call, CUDA events, mean of 10 after a warm-up), beside
whether its stash forward gives the step route's bits.

- ``base``: the sources as they are.
- ``no_quant_pass``: q() not applied to the staged values (timing only;
  its bits differ with the quantizer).
- ``no_dots``: no dot products (timing only).
- ``quant_in_dots_2x4`` / ``_4x2`` / ``_8x1``: q() on each value as the
  dots load it, the warps split 2, 4 or 8 ways over the staged rows (and
  4, 2 or 1 over the weight rows) instead of a pass over the staged rows.
- ``unroll2``: the dots' loop unrolled by 2 instead of 4.
- ``chunks4`` / ``chunks16``: 4 or 16 chunks a thread in flight in the
  quantizer's pass instead of 8.

    python3 gru_fwd_variants.py [OUT.json]

from the root of the checkout. Prints the card and one line a variant,
then the whole result as one JSON line (also written to OUT.json when
given); exits 1 without a card.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import _build
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R

SHAPES = (("row19", 3, 300, 8, 550, "tanh"),
          ("row24", 2, 300, 8, 1024, "relu"))


def sub(text, old, new):
    """``text`` with ``old`` replaced by ``new``; ``old`` must be there."""
    if old not in text:
        raise ValueError("the source no longer holds %r" % old[:60])
    return text.replace(old, new)


#: the sources a variant may change: the kernel's and its header's
FILES = ("fused_gru.cu", "persist.cuh")


def quant_in_dots(src, groups):
    """q() applied in resident_dots to each staged value it loads (its
    resident_fma part; the identity for the callers that pass none, as
    rows_dots), the warps split ``groups`` ways over the staged rows
    (``src``: FILES' texts by name)."""
    h = sub(src["persist.cuh"], """template <int BT, int NR>
__device__ __forceinline__ void resident_fma(const float* ws, int WK,
                                             const float* xs, int SK, int k0,
                                             int n, int nb,
                                             float (&acc)[BT / 2][NR / 4]) {""",
            """template <int BT, int NR, typename XF = bf16_or_ident<false>>
__device__ __forceinline__ void resident_fma(const float* ws, int WK,
                                             const float* xs, int SK, int k0,
                                             int n, int nb,
                                             float (&acc)[BT / 2][NR / 4],
                                             XF xf = XF()) {""")
    h = sub(h, """template <int BT, int NR, int LD>
__device__ __forceinline__ void resident_dots(const float* ws,
                                              const float* xs, int SK,
                                              int K, int nb,
                                              float (*usm)[LD]) {
  float acc[BT / 2][NR / 4];
  resident_zero<BT, NR>(acc);
  resident_fma<BT, NR>(ws, K, xs, SK, 0, K, nb, acc);""",
            """template <int BT, int NR, int LD,
          typename XF = bf16_or_ident<false>>
__device__ __forceinline__ void resident_dots(const float* ws,
                                              const float* xs, int SK,
                                              int K, int nb,
                                              float (*usm)[LD],
                                              XF xf = XF()) {
  float acc[BT / 2][NR / 4];
  resident_zero<BT, NR>(acc);
  resident_fma<BT, NR>(ws, K, xs, SK, 0, K, nb, acc, xf);""")
    # the split of the warps, in resident_dots' parts (and lane_dots', which
    # the GRU does not instantiate)
    h = sub(h, "BT / 2", "BT / %d" % groups)
    h = sub(h, "NR / 4", "NR / (WARPS / %d)" % groups)
    h = sub(h, "  const int bq = (warp & 1) * BQ, rq = (warp >> 1) * RQ;",
            "  const int bq = (warp %% %d) * BQ, rq = (warp / %d) * RQ;"
            % (groups, groups))
    h = sub(h, "        const float xv = x[(size_t)p * SK + k];",
            "        const float xv = xf(x[(size_t)p * SK + k]);")
    h = sub(h, "  if (var == 0.f && !RND) return;", "  return;")
    k = sub(src["fused_gru.cu"], """  auto block_max = [&](unsigned m, unsigned* out) {
    P::block_max(m, out, wmax);
  };
""", """  auto block_max = [&](unsigned m, unsigned* out) {
    P::block_max(m, out, wmax);
  };
  auto qf = [&](float var) {
    const float inv = var != 0.f ? 1.f / var : 0.f, sc = qscale,
                isc = iscale;
    return [var, inv, sc, isc](float x) {
      return quant_rcp(x, var, inv, sc, isc);
    };
  };
""")
    for x, w, nr in (("xh, hmax", "wzr", "ZC"), ("xs, smax", "wh", "UN")):
        k = sub(k, """      stage(%s);
      P::resident_dots<BT, %s, ZC>(%s, xsm, SK, H, nb, usm);""" % (x, nr, w),
                """      const float var = stage(%s);
      P::resident_dots<BT, %s, ZC>(%s, xsm, SK, H, nb, usm, qf(var));"""
                % (x, nr, w))
    return {"fused_gru.cu": k, "persist.cuh": h}


def variants(src):
    """Each variant's FILES texts by name, from ``src``, the checkout's."""
    k, h = src["fused_gru.cu"], src["persist.cuh"]
    loop = "#pragma unroll 4\n  for (int k = lane; k < n; k += 32)"
    chunks = "constexpr int STAGE_CHUNKS = 8;"
    no_dots = k
    for call in (
            "      P::resident_dots<BT, ZC, ZC>(wzr, xsm, SK, H, nb, usm);",
            "      P::resident_dots<BT, UN, ZC>(wh, xsm, SK, H, nb, usm);"):
        no_dots = sub(no_dots, call, "")

    def header(text):
        return {"fused_gru.cu": k, "persist.cuh": text}
    return {
        "base": dict(src),
        "no_quant_pass": header(sub(h, "  if (var == 0.f && !RND) return;",
                                    "  return;")),
        "no_dots": {"fused_gru.cu": no_dots, "persist.cuh": h},
        "quant_in_dots_2x4": quant_in_dots(src, 2),
        "quant_in_dots_4x2": quant_in_dots(src, 4),
        "quant_in_dots_8x1": quant_in_dots(src, 8),
        "unroll2": header(sub(h, loop, loop.replace("4", "2", 1))),
        "chunks4": header(sub(h, chunks, chunks.replace("8", "4"))),
        "chunks16": header(sub(h, chunks, chunks.replace("8", "16"))),
    }


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        print("gru_fwd_variants: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    rng = np.random.RandomState(5)

    def dev(a):
        return torch.tensor(a.astype(np.float32), device="cuda")
    inputs = [(tag, G, act, dev(rng.randn(T, B, G * H) * 0.5),
               dev(rng.randn(G * H, H) / np.sqrt(H)),
               dev(rng.rand(B, H) > 0.2))
              for tag, G, T, B, H, act in SHAPES]
    csrc0 = _build.CSRC
    out = {"card": card, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src = {f: (csrc0 / f).read_text() for f in FILES}
        for name, texts in variants(src).items():
            csrc = Path(tmp) / name / "csrc"
            csrc.mkdir(parents=True)
            for p in csrc0.glob("*.cuh"):
                shutil.copy(p, csrc)
            for f, text in texts.items():
                (csrc / f).write_text(text)
            _build.CSRC, _build.BUILD_DIR = csrc, Path(tmp) / name / "build"
            _build._LIBS.clear()
            BS._lib_fn.cache_clear()
            R._persist_occupancy.cache_clear()
            _build.build(["fused_gru"])
            res = {}
            with torch.no_grad():
                for tag, G, act, g, U, drop in inputs:
                    w = R.fused_gru_fwd if G == 3 else R.fused_mgru_fwd
                    for q in (0, 16):
                        key = "%s_q%d" % (tag, q)
                        res[key + "_ms"] = cuda_ms(
                            lambda: w(g, U, drop, act=act, qbits=q))
                        got = w(g, U, drop, act=act, qbits=q, stash=True)
                        step = R._gru_fwd_step(w, g, U, drop, None, act, q,
                                               True)
                        res[key + "_step_bits"] = all(
                            torch.equal(a, b) for a, b in zip(got, step))
            out["variants"][name] = res
            print(name, json.dumps(res), flush=True)
    _build.CSRC = csrc0
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
