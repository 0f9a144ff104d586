"""The device time of one block-sparse dw call with M forced into 1-16
parts, on one CUDA card: the data behind ``block_sparse.PARTIAL_ROUND``
and the split plans of ``block_sparse.dw_plan``.

Shapes: row 15's (``block_sparse_dw``, the float32 tile of
``ops/csrc/bs_gemm.cuh``) at every model shape of
``chip_smoke.dw_shapes()``, and the legacy dw's (``bsl_dw`` /
``bsl_dw_multi``) timed shapes of ``chip_smoke.legacy_dw_shapes()`` in
float32 (the same tile) and bf16 (the tensor-core tile of
``ops/csrc/bs_mma.cuh``). Per shape and split: the microseconds of each
device kernel of one call (``torch.profiler``, 20 calls after a warm-up),
beside the split the plan picks. Then, per tile, a lone block's time over
a pair's: the legacy G=1 shape (32 tiles) at 4 splits (128 blocks, one an
SM, 1600 rows each) against 8 (256 blocks, two an SM, 800 rows each).

    python3 dw_split_sweep.py [OUT.json]

from the root of the checkout. Prints one line a shape and the whole
result as one JSON line (also written to OUT.json when given); exits 1
without a card.
"""

import json
import sys

import torch

import chip_smoke

SPLITS = (1, 2, 4, 6, 8, 12, 16)


def kernel_us(fn, calls=20):
    """Device microseconds per call of ``fn`` by kernel short name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            k = chip_smoke.kernel_short_name(e.name)
            out[k] = out.get(k, 0.0) + e.time_range.elapsed_us() / calls
    return out


def cases(dev):
    """(name, layout, M, G, tile, call) of every swept dw call."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    gen = torch.Generator(device=dev).manual_seed(237)
    out = []
    for tag, layout, M, G, sub in chip_smoke.dw_shapes():
        dg = torch.randn(M, layout.Nb * G * layout.bs, device=dev,
                         generator=gen)
        x = torch.randn(M, layout.K, device=dev, generator=gen)
        sub3 = None if sub is None else torch.tensor(sub, device=dev)
        out.append(("dw_" + tag, layout, M, G, "bs_gemm",
                    lambda dg=dg, x=x, l=layout, G=G, s3=sub3:
                    BS.block_sparse_dw(dg, x, l, G, s3)))
    for tag, layout, M, G in chip_smoke.legacy_dw_shapes():
        for dt, tile in (("f32", "bs_gemm"), ("bf16", "bs_mma")):
            x, _, gy = chip_smoke.legacy_operands(layout, G, M, 238, dev, dt,
                                                  dt)
            out.append((
                "bsl_dw_%s_%s" % (tag, dt), layout, M, G, tile,
                (lambda gy=gy, x=x, l=layout: BS.bsl_dw(gy, x, l)) if G == 1
                else (lambda gy=gy, x=x, l=layout, G=G:
                      BS.bsl_dw_multi(gy, x, l, G))))
    return out


def main(path=None):
    if not torch.cuda.is_available():
        print("dw_split_sweep: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    _build.build(["block_sparse_dw", "block_sparse_legacy"])
    dev = "cuda"
    plan = BS.dw_plan
    out = {"card": chip_smoke.smi_card()}
    for name, layout, M, G, tile, call in cases(dev):
        grid = BS.gemm_grid(dev, tile)
        tiles, picked, _ = plan(M, layout.Nb, G, layout.R, layout.bs, grid)
        r = {"plan_splits": picked}
        for want in SPLITS:
            rows = -(-(-(-M // want)) // grid.bk) * grid.bk
            forced = (tiles, -(-M // rows), rows)
            # the wrapper asks dw_plan for its split: force this one
            BS.dw_plan = lambda *a, forced=forced: forced
            try:
                r["S%d_us" % forced[1]] = {
                    k: round(v, 2) for k, v in kernel_us(call).items()}
            finally:
                BS.dw_plan = plan
        out[name] = r
        print("[dw_split_sweep] %s %s" % (name, json.dumps(r)), flush=True)
    for dt in ("f32", "bf16"):
        r = out["bsl_dw_libri_G1_%s" % dt]
        lone, pair = (sum(v for k, v in r[s].items() if k != "dw_reduce")
                      for s in ("S4_us", "S8_us"))
        out["lone_over_pair_" + dt] = (lone / 1600) / (pair / 800)
    line = json.dumps(out)
    print(line)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
