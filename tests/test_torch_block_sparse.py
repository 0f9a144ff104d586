"""The port's legacy v1/v2 block-sparse matmul (pytorch_kaldi_cgs_tpu_torch:
ops/block_sparse.py ``block_sparse_matmul``, ``block_sparse_matmul_multi``,
``block_sparse_matmul_xla``, ``pack_submasks``, ``pack_blocks_multi``, the
twins of the three kernels of ops/csrc/block_sparse_legacy.cu) against the
JAX package on the same numpy inputs, its Pallas kernels run in interpret
mode at bs=8.

- Every legacy case of tests/test_block_sparse.py, mirrored: the plain
  reference, the forward, the gradients, the two-level submask, the
  multi-gate form and a K-padded layout, each against the JAX function
  and the dense masked product.
- Each twin against its own JAX kernel call (``_make_fwd``, ``_make_dx``,
  ``_make_dw`` at G=1; the ``_multi`` ones at G=3 and 4), on an HCGS
  layout and on a layout whose columns hold uneven numbers of blocks (C >
  R, pad entries, a column no row keeps).
- The autograd Functions' dx and dw against ``jax.vjp`` of the JAX custom
  VJPs in the three dtype rows (bf16/bf16, bf16 x with f32 w, f32 x with
  bf16 w) and in f32, with the output dtypes checked.

Tolerances: float32 1e-5 of the reference's largest |value| (the sums run
in another order than XLA's); bfloat16 outputs one bf16 ulp of that
value, 2^(floor(log2 scale) - 7), between 2^-8 and 2^-7 of it: both
sides sum in float32 and round once, so a sum that lands near a
rounding boundary can round to the neighbouring bf16 value.

JAX comes in through fixtures, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_block_sparse.py``).
"""
import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import ops as tops
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

BS = 8              # small blocks for the CPU; the models use 128
REL_F32 = 1e-5
tt = torch.from_numpy

DTYPES = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, None)}


@pytest.fixture
def jbs():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.block_sparse")


def _assert_close(got, ref, dtype, name=""):
    """got within REL_F32 of ref's largest |value| (float32), or one bf16
    ulp of it (bfloat16)."""
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-30)
    atol = 2.0 ** (np.floor(np.log2(scale)) - 7) \
        if dtype == torch.bfloat16 else REL_F32 * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)


def _hcgs_layout():
    """tests/test_block_sparse.py's fixture: 32 x 48, keep 3 of 6 a row."""
    mask = hcgs_mask(32, 48, [BS], [50], seed=0)
    return mask, tbs.pack_layout(mask, BS)


def _uneven_layout():
    """Nb=4, Kb=6, R=2; column 1 holds all four rows' blocks (C=4), column
    5 none: pads in every other column, a zero column block of dx."""
    occ = np.zeros((4, 6), np.float32)
    for j, cs in enumerate(((0, 1), (1, 2), (1, 3), (1, 4))):
        occ[j, list(cs)] = 1
    mask = np.kron(occ, np.ones((BS, BS), np.float32))
    layout = tbs.pack_layout(mask, BS)
    assert (layout.R, layout.C) == (2, 4)
    assert int((layout.t_perm == layout.nnz).sum()) > 0
    return mask, layout


LAYOUTS = {"hcgs": _hcgs_layout, "uneven": _uneven_layout}


def _bf16_np(a):
    """numpy float32 values that bf16 holds exactly (as the JAX side
    gets them)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _jnp(a, dt):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _t(a, dt):
    return tt(np.asarray(a, np.float32)).to(DTYPES[dt][0])


def _operands(layout, G, M, seed, xdt="f32", wdt="f32"):
    """x (M, K), stacked w (nnz, G*bs, bs) and a flat cotangent (M,
    Nb*G*bs), rounded to bf16 where that dtype is asked for."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, layout.K).astype(np.float32)
    w = rng.randn(layout.nnz, G * BS, BS).astype(np.float32)
    gy = rng.randn(M, layout.Nb * G * BS).astype(np.float32)
    if xdt == "bf16":
        x, gy = _bf16_np(x), _bf16_np(gy)
    if wdt == "bf16":
        w = _bf16_np(w)
    return x, w, gy


# ---------------------------------------------------------------------------
# tests/test_block_sparse.py's legacy cases, mirrored
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layout_and_w():
    mask, layout = _hcgs_layout()
    w = np.random.RandomState(0).randn(32, 48).astype(np.float32) * mask
    return mask, layout, w, tbs.pack_blocks(w, layout)


def test_xla_reference_matches_dense(jbs, layout_and_w):
    """The plain reference against the dense masked product and the JAX
    ``block_sparse_matmul_xla``; gradients flow through it."""
    import jax.numpy as jnp
    mask, layout, w, wp = layout_and_w
    x = np.random.RandomState(1).randn(16, 48).astype(np.float32)
    xt = tt(x).requires_grad_()
    y = tbs.block_sparse_matmul_xla(xt, tt(wp), layout)
    _assert_close(y.detach(), x @ w.T, torch.float32)
    jlay = jbs.pack_layout(mask, BS)
    _assert_close(y.detach(), jbs.block_sparse_matmul_xla(
        jnp.asarray(x), jnp.asarray(wp), jlay), torch.float32)
    y.sum().backward()
    _assert_close(xt.grad, np.ones((16, 32), np.float32) @ w, torch.float32)


def test_pallas_forward_interpret(jbs, layout_and_w):
    import jax.numpy as jnp
    mask, layout, w, wp = layout_and_w
    x = np.random.RandomState(2).randn(16, 48).astype(np.float32)
    y = tbs.block_sparse_matmul(tt(x), tt(wp), layout, tile_m=8)
    y_ref = jbs.block_sparse_matmul(jnp.asarray(x), jnp.asarray(wp),
                                    jbs.pack_layout(mask, BS), tile_m=8,
                                    interpret=True)
    assert y.shape == (16, 32) and y.dtype == torch.float32
    _assert_close(y.detach(), y_ref, torch.float32)
    _assert_close(y.detach(), x @ w.T, torch.float32)


def test_pallas_grads_interpret(jbs, layout_and_w):
    """dx and the packed dw against jax.grad of the JAX custom VJP and
    the dense reference (dw on the kept blocks only)."""
    import jax
    import jax.numpy as jnp
    mask, layout, w, wp = layout_and_w
    x = np.random.RandomState(3).randn(16, 48).astype(np.float32)
    g_out = np.random.RandomState(4).randn(16, 32).astype(np.float32)
    jlay = jbs.pack_layout(mask, BS)

    def f(x, wp):
        y = jbs.block_sparse_matmul(x, wp, jlay, tile_m=8, interpret=True)
        return jnp.sum(y * jnp.asarray(g_out))
    dx_ref, dw_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(wp))
    xt, wt = tt(x).requires_grad_(), tt(wp).requires_grad_()
    (tbs.block_sparse_matmul(xt, wt, layout, tile_m=8) * tt(g_out)).sum() \
        .backward()
    _assert_close(xt.grad, dx_ref, torch.float32, "dx")
    _assert_close(wt.grad, dw_ref, torch.float32, "dw")
    _assert_close(xt.grad, g_out @ w, torch.float32, "dx dense")
    _assert_close(tbs.unpack_blocks(wt.grad.numpy(), layout),
                  (g_out.T @ x) * mask, torch.float32, "dw dense")


def test_two_level_submask(jbs, layout_and_w):
    """The level-2 fine mask, packed like the weights (equal to the JAX
    ``pack_submasks``), multiplied into the blocks before the call."""
    import jax.numpy as jnp
    mask1, layout, w, wp = layout_and_w
    fine = hcgs_mask(32, 48, [BS, 2], [50, 50], seed=0)
    sub = tbs.pack_submasks(fine, layout)
    jlay = jbs.pack_layout(mask1, BS)
    np.testing.assert_array_equal(sub, jbs.pack_submasks(fine, jlay))
    assert sub.dtype == np.float32
    x = np.random.RandomState(5).randn(8, 48).astype(np.float32)
    wpm = wp * sub
    y = tbs.block_sparse_matmul(tt(x), tt(wpm), layout, tile_m=8)
    _assert_close(y.detach(), x @ tbs.unpack_blocks(wpm, layout).T,
                  torch.float32)
    _assert_close(y.detach(), jbs.block_sparse_matmul(
        jnp.asarray(x), jnp.asarray(wp) * jnp.asarray(sub), jlay, tile_m=8,
        interpret=True), torch.float32)


def test_multi_gate_forward_and_grads(jbs, layout_and_w):
    """The fused 4-gate form against the per-gate dense products and
    jax.grad of the JAX ``block_sparse_matmul_multi``."""
    import jax
    import jax.numpy as jnp
    mask, layout, _, _ = layout_and_w
    G = 4
    rng = np.random.RandomState(9)
    ws = [rng.randn(32, 48).astype(np.float32) * mask for _ in range(G)]
    w_st = tbs.pack_blocks_multi(ws, layout)
    jlay = jbs.pack_layout(mask, BS)
    np.testing.assert_array_equal(w_st, jbs.pack_blocks_multi(ws, jlay))
    x = rng.randn(16, 48).astype(np.float32)
    g_out = rng.randn(G, 16, 32).astype(np.float32)
    xt, wt = tt(x).requires_grad_(), tt(w_st).requires_grad_()
    ys = tbs.block_sparse_matmul_multi(xt, wt, layout, G, tile_m=8)
    assert ys.shape == (G, 16, 32)
    for g in range(G):
        _assert_close(ys[g].detach(), x @ ws[g].T, torch.float32)
    (ys * tt(g_out)).sum().backward()

    def f(x, w):
        ys = jbs.block_sparse_matmul_multi(x, w, jlay, G, tile_m=8,
                                           interpret=True)
        return jnp.sum(ys * jnp.asarray(g_out))
    dx_ref, dw_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w_st))
    _assert_close(xt.grad, dx_ref, torch.float32, "dx")
    _assert_close(wt.grad, dw_ref, torch.float32, "dw")
    dense = np.einsum("gmn,gnk->mk", g_out, np.stack(ws))
    _assert_close(xt.grad, dense, torch.float32, "dx dense")
    for g in range(G):
        got = tbs.unpack_blocks(wt.grad.numpy()[:, g * BS:(g + 1) * BS],
                                layout)
        _assert_close(got, (g_out[g].T @ x) * mask, torch.float32, "dw %d" % g)


def test_pad_k_layout_matmul_matches_dense(jbs):
    """pack_layout(pad_k=True) on K=42: x at the padded width 48, against
    the dense masked product at the true width and the JAX kernel."""
    import jax.numpy as jnp
    N, K = 32, 42
    rng = np.random.RandomState(5)
    m = np.zeros((N, 48), np.float32)
    for j in range(N // BS):
        for c in rng.choice(6, 3, replace=False):
            m[j * BS:(j + 1) * BS, c * BS:(c + 1) * BS] = 1
    mask = m[:, :K]
    layout = tbs.pack_layout(mask, BS, pad_k=True)
    assert layout.K == 48 and layout.k_true == 42
    rng = np.random.RandomState(6)
    w = (rng.randn(N, K) * mask).astype(np.float32)
    wp = tbs.pack_blocks(w, layout)
    x = rng.randn(16, K).astype(np.float32)
    xp = np.concatenate([x, np.zeros((16, layout.K - K), np.float32)], 1)
    y = tbs.block_sparse_matmul(tt(xp), tt(wp), layout, tile_m=8)
    _assert_close(y.detach(), x @ w.T, torch.float32)
    _assert_close(y.detach(), jbs.block_sparse_matmul(
        jnp.asarray(xp), jnp.asarray(wp), jbs.pack_layout(mask, BS,
                                                          pad_k=True),
        tile_m=8, interpret=True), torch.float32)
    with pytest.raises(ValueError, match="x must be"):
        tbs.block_sparse_matmul(tt(x), tt(wp), layout, tile_m=8)


# ---------------------------------------------------------------------------
# each twin against its own JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

def _jax_kernels(jbs, mask, G, tile):
    """The JAX kernel calls of one layout: (fwd, dx, dw), v1 at G=1."""
    jlay = jbs.pack_layout(mask, BS)
    if G == 1:
        return jlay, jbs._build_ops(jlay, tile, True)
    return jlay, jbs._build_multi_ops(jlay, G, tile, True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("lay", ["hcgs", "uneven"])
def test_twins_match_pallas_kernels(jbs, lay, G, dt):
    """bsl_fwd_plain / bsl_dx_plain / bsl_dw_plain against the JAX
    ``_make_fwd``/``_make_dx``/``_make_dw`` (G=1) and their ``_multi``
    forms (G=3, 4: the cotangent in the kernels' grouped layout, the dx
    weight with the zero pad block appended, as the JAX VJP builds them);
    operands float32 or bfloat16, outputs in the JAX dtypes."""
    import jax.numpy as jnp
    mask, layout = LAYOUTS[lay]()
    M, tile = 16, 8
    x, w, gy = _operands(layout, G, M, 20 + G, dt, dt)
    jlay, (fwd, dxk, dwk) = _jax_kernels(jbs, mask, G, tile)
    jx, jw, jg = _jnp(x, dt), _jnp(w, dt), _jnp(gy, dt)
    w_pad = jnp.concatenate([jw, jnp.zeros((1,) + jw.shape[1:], jw.dtype)])
    if G > 1:
        jg = jg.reshape(M // tile, tile, -1)
    ref_y, ref_dx, ref_dw = fwd(jx, jw), dxk(jg, w_pad), dwk(jg, jx)
    if G == 1:
        ref_y = ref_y[None]
    tdt = DTYPES[dt][0]
    y = tbs.bsl_fwd_plain(_t(x, dt), _t(w, dt), layout, G)
    dx = tbs.bsl_dx_plain(_t(gy, dt), _t(w, dt), layout, G)
    dw = tbs.bsl_dw_plain(_t(gy, dt), _t(x, dt), layout, G)
    for name, got, ref in (("fwd", y, ref_y), ("dx", dx, ref_dx),
                           ("dw", dw, ref_dw)):
        assert got.dtype == tdt and str(ref.dtype) == {
            "f32": "float32", "bf16": "bfloat16"}[dt], name
        _assert_close(got, np.asarray(ref, np.float32), tdt, name)
    if lay == "uneven":         # column block 5 is kept by no row
        assert float(dx[:, 5 * BS:].abs().max()) == 0.0


def test_twins_at_g1_equal_v1_wrappers():
    """The v1 wrappers are the G=1 twins on the CPU, and the v2 API at
    G=1 equals the v1 API, forward and gradients."""
    mask, layout = _uneven_layout()
    x, w, gy = _operands(layout, 1, 16, 7)
    assert torch.equal(tbs.bsl_fwd(tt(x), tt(w), layout),
                       tbs.bsl_fwd_plain(tt(x), tt(w), layout, 1)[0])
    assert torch.equal(tbs.bsl_dx(tt(gy), tt(w), layout),
                       tbs.bsl_dx_plain(tt(gy), tt(w), layout, 1))
    assert torch.equal(tbs.bsl_dw(tt(gy), tt(x), layout),
                       tbs.bsl_dw_plain(tt(gy), tt(x), layout, 1))
    outs = []
    for multi in (False, True):
        xt, wt = tt(x).requires_grad_(), tt(w).requires_grad_()
        y = tbs.block_sparse_matmul_multi(xt, wt, layout, 1, tile_m=8)[0] \
            if multi else tbs.block_sparse_matmul(xt, wt, layout, tile_m=8)
        (y * tt(gy)).sum().backward()
        outs.append((y.detach(), xt.grad, wt.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the autograd Functions against jax.vjp, in every dtype row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,wdt", [("bf16", "bf16"), ("bf16", "f32"),
                                     ("f32", "bf16"), ("f32", "f32")])
@pytest.mark.parametrize("G", [1, 3])
def test_functions_match_jax_vjp(jbs, G, xdt, wdt):
    """y, dx and dw of ``block_sparse_matmul`` (G=1) and
    ``block_sparse_matmul_multi`` (G=3) against ``jax.vjp`` of the JAX
    custom VJPs on the uneven layout. The JAX dtypes: y, dx and dw in x's
    dtype (the cotangent's), whatever w's. Torch's autograd casts a
    returned gradient to its input's dtype, so for bf16 x and f32 w the
    port's dw arrives as float32 holding the bf16-rounded values, and for
    f32 x and bf16 w as JAX's float32 dw rounded to bf16."""
    import jax
    mask, layout = _uneven_layout()
    jlay = jbs.pack_layout(mask, BS)
    M = 16
    x, w, gy = _operands(layout, G, M, 40 + G, xdt, wdt)
    if G == 1:
        w = w.reshape(layout.nnz, BS, BS)
    cot = gy.reshape(M, layout.Nb, G, BS).transpose(2, 0, 1, 3) \
        .reshape(G, M, layout.N)
    if G == 1:
        cot = cot[0]

    def jf(x, w):
        if G == 1:
            return jbs.block_sparse_matmul(x, w, jlay, tile_m=8,
                                           interpret=True)
        return jbs.block_sparse_matmul_multi(x, w, jlay, G, tile_m=8,
                                             interpret=True)
    y_ref, vjp = jax.vjp(jf, _jnp(x, xdt), _jnp(w, wdt))
    dx_ref, dw_ref = vjp(_jnp(cot, xdt))
    xt = _t(x, xdt).requires_grad_()
    wt = _t(w, wdt).requires_grad_()
    y = tbs.block_sparse_matmul(xt, wt, layout, tile_m=8) if G == 1 else \
        tbs.block_sparse_matmul_multi(xt, wt, layout, G, tile_m=8)
    y.backward(_t(cot, xdt))
    jname = {"f32": "float32", "bf16": "bfloat16"}
    assert (str(y_ref.dtype), str(dx_ref.dtype), str(dw_ref.dtype)) == \
        (jname[xdt],) * 3
    xd, wd = DTYPES[xdt][0], DTYPES[wdt][0]
    assert (y.dtype, xt.grad.dtype, wt.grad.dtype) == (xd, xd, wd)
    _assert_close(y.detach(), np.asarray(y_ref, np.float32), xd, "y")
    _assert_close(xt.grad, np.asarray(dx_ref, np.float32), xd, "dx")
    # dw in the cotangent's dtype, then cast by autograd to w's: bf16 if
    # either is (for f32 x and bf16 w, JAX's float32 dw rounded to bf16)
    dwd = torch.bfloat16 if torch.bfloat16 in (xd, wd) else torch.float32
    _assert_close(wt.grad, np.asarray(dw_ref, np.float32), dwd, "dw")
    if xdt == "bf16" and wdt == "f32":      # bf16 values held in float32
        assert torch.equal(wt.grad, wt.grad.bfloat16().float())


def test_tile_rule_and_width_raise():
    """The JAX rule: tile_m clamped to M, M a multiple of it; x must be
    the layout's (padded) width; the wrappers refuse other dtypes and
    shapes."""
    mask, layout = _hcgs_layout()
    x, w, gy = _operands(layout, 1, 12, 1)
    w = tt(w.reshape(layout.nnz, BS, BS))
    with pytest.raises(ValueError, match="M=12 not divisible by tile_m=8"):
        tbs.block_sparse_matmul(tt(x), w, layout, tile_m=8)
    with pytest.raises(ValueError, match="M=12 not divisible by tile_m=8"):
        tbs.block_sparse_matmul_multi(tt(x), w, layout, 1, tile_m=8)
    assert tbs.block_sparse_matmul(tt(x), w, layout).shape == (12, 32)
    with pytest.raises(ValueError, match="x must be"):
        tbs.block_sparse_matmul(tt(x[:, :40]), w, layout, tile_m=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tbs.bsl_fwd(tt(x).double(), w, layout)
    with pytest.raises(ValueError, match="w must be"):
        tbs.bsl_fwd_multi(tt(x), w, layout, 2)
    with pytest.raises(ValueError, match="gy must be"):
        tbs.bsl_dx(tt(gy[:, :8]), w, layout)


def test_ops_exports_the_jax_names(jbs):
    """The port's ``ops`` exports the JAX package's names it has; the
    frontend's counterparts under the port's names."""
    from pytorch_kaldi_cgs_tpu_torch.ops import frontend
    import pytorch_kaldi_cgs_tpu.ops as jops
    for name in ("BlockLayout", "pack_layout", "pack_blocks",
                 "unpack_blocks", "block_sparse_matmul",
                 "block_sparse_matmul_xla", "Frontend"):
        assert hasattr(jops, name) and hasattr(tops, name), name
    assert tops.block_sparse_matmul is tbs.block_sparse_matmul
    assert tops.Frontend is frontend.Frontend
    assert (tops.add_deltas, tops.cmvn) == (frontend.add_deltas,
                                           frontend.cmvn)
    assert hasattr(jops, "add_deltas_jax") and hasattr(jops, "cmvn_jax")


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
@pytest.mark.parametrize("xdt,wdt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("lay", ["hcgs", "uneven"])
def test_cuda_kernels_match_plain_twins(cuda_device, lay, G, xdt, wdt):
    """The three kernels (through the v1 wrappers at G=1, the v2 ones at
    G=3) against their twins on the card, on the same tensors; one
    launch each."""
    mask, layout = LAYOUTS[lay]()
    x, w, gy = _operands(layout, G, 40, 60 + G, xdt, wdt)
    x, gy = (_t(a, xdt).to(cuda_device) for a in (x, gy))
    w = _t(w, wdt).to(cuda_device)
    if G == 1:
        w = w.reshape(layout.nnz, BS, BS)
        calls = ((tbs.bsl_fwd, lambda: tbs.bsl_fwd(x, w, layout)[None],
                  lambda: tbs.bsl_fwd_plain(x, w, layout, 1)),
                 (tbs.bsl_dx, lambda: tbs.bsl_dx(gy, w, layout),
                  lambda: tbs.bsl_dx_plain(gy, w, layout, 1)),
                 (tbs.bsl_dw, lambda: tbs.bsl_dw(gy, x, layout),
                  lambda: tbs.bsl_dw_plain(gy, x, layout, 1)))
    else:
        calls = ((tbs.bsl_fwd_multi,
                  lambda: tbs.bsl_fwd_multi(x, w, layout, G),
                  lambda: tbs.bsl_fwd_plain(x, w, layout, G)),
                 (tbs.bsl_dx_multi,
                  lambda: tbs.bsl_dx_multi(gy, w, layout, G),
                  lambda: tbs.bsl_dx_plain(gy, w, layout, G)),
                 (tbs.bsl_dw_multi,
                  lambda: tbs.bsl_dw_multi(gy, x, layout, G),
                  lambda: tbs.bsl_dw_plain(gy, x, layout, G)))
    for wrapper, kernel, plain in calls:
        before = wrapper.launches
        got = kernel()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = plain()
        assert got.dtype == ref.dtype
        _assert_close(got.cpu(), ref.float().cpu().numpy(), got.dtype,
                      wrapper.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
def test_cuda_functions_match_cpu(cuda_device, G):
    """Both autograd Functions on the card (kernels) against the same
    call on the CPU (twins): y, dx, dw."""
    mask, layout = _uneven_layout()
    x, w, gy = _operands(layout, G, 64, 80 + G)
    if G == 1:
        w = w.reshape(layout.nnz, BS, BS)
    outs = []
    for dev in ("cpu", cuda_device):
        xt = tt(x).to(dev).requires_grad_()
        wt = tt(w).to(dev).requires_grad_()
        y = tbs.block_sparse_matmul(xt, wt, layout) if G == 1 else \
            tbs.block_sparse_matmul_multi(xt, wt, layout, G)
        cot = torch.ones_like(y) * 0.5
        y.backward(cot)
        outs.append([t.detach().cpu() for t in (y, xt.grad, wt.grad)])
    for name, a, b in zip(("y", "dx", "dw"), *outs):
        _assert_close(b, a.numpy(), torch.float32, name)
