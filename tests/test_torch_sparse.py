"""The port's block-sparse HCGS recurrence (pytorch_kaldi_cgs_tpu_torch:
ops/block_sparse, the sparse part of ops/fused_lstm, the LSTM's and the
MLP's ``prepare_block_sparse``) against the JAX package on the same numpy
inputs, the Pallas kernels run in interpret mode.

- ``BlockLayout`` and the w3 packing: field for field, array for array.
- The block-sparse dw twin against ``_make_dw_v3`` (with and without the
  level-2 submask epilogue): atol 1e-5.
- The sparse recurrence: the forward twins (plain and stash, w3g in f32
  and in bf16) and both BPTT twins against their TPU kernels, and the
  autograd Function's gradients against ``jax.vjp`` of
  ``lstm_scan_fused_sparse`` (stash and recompute, qbits 0 and 16, tanh
  and relu). Forward atol 1e-5, gradients atol 1e-4 (dU sums over T*B,
  and with the 16-bit quantizer an ulp at a ceil step is one level).
- The LSTM under ``lstm_block_sparse=auto`` against its own ``False``
  path, and against the JAX LSTM (``lstm_fused_scan=True``) in float32
  and under ``compute_dtype=bf16``: the JAX package runs an eligible
  layer's sparse recurrence in float32 even under bf16, and so does the
  port.
- Three ``ChunkRunner.train_step``s of a narrow CGS-16x-shaped two-head
  net (2x256 LSTM, 128 blocks at 75% level-1 drop, cd and mono heads)
  against the JAX runner: loss and err within 1e-5 relative.

JAX comes in through fixtures, so that the ``cuda`` cases also run where
JAX is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_sparse.py``).
There the kernels are held against their twins: float32 atol 1e-5 at
these sizes (the kernels sum the kept blocks, and the backward's carry
gathers a column's blocks, in another order than the twins' bmm and
index_add_), bf16 w3g atol 2e-2.
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as tbs
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask

T, B, H, BS = 10, 4, 32, 8      # the recurrence: Kb=4, R=2 at 50% drop
ACTS = ["tanh", "relu"]


@pytest.fixture
def jbs():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.block_sparse")


@pytest.fixture
def jfl():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_lstm")


# ---------------------------------------------------------------------------
# layouts and packing
# ---------------------------------------------------------------------------

MASKS = {
    # name: (rows, cols, blocks, drops, bs, pad_k)
    "cgs16x_rec_1024": (1024, 1024, [128, 8], [75, 75], 128, False),
    "cgs16x_x_143_padk": (1024, 143, [128, 8], [75, 75], 128, True),
    "rec_256_50": (256, 256, [128], [50], 128, False),
    "small_32_50": (32, 32, [8], [50], 8, False),
    "wide_512x1000_padk": (512, 1000, [128, 4], [50, 50], 128, True),
}


def _mask(name, seed=0):
    rows, cols, blocks, drops, bs, pad_k = MASKS[name]
    return hcgs_mask(rows, cols, blocks, drops,
                     rng=np.random.RandomState(seed)), bs, pad_k


@pytest.mark.parametrize("name", sorted(MASKS))
def test_layout_and_packing_equal_jax(jbs, name):
    mask, bs, pad_k = _mask(name)
    jl, tl = jbs.pack_layout(mask, bs, pad_k), tbs.pack_layout(mask, bs, pad_k)
    for f in ("N", "K", "bs", "R", "C", "nnz", "K_orig", "Nb", "Kb",
              "k_true"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.density() == jl.density()
    for f in ("col_idx", "t_row_idx", "t_perm", "rows", "cols"):
        a, b = getattr(tl, f), getattr(jl, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    w = np.random.RandomState(1).randn(*mask.shape).astype(np.float32) * mask
    w3 = tbs.pack_w3(w, tl)
    np.testing.assert_array_equal(w3, jbs.pack_w3(w, jl))
    np.testing.assert_array_equal(tbs.unpack_w3(w3, tl), jbs.unpack_w3(w3, jl))
    np.testing.assert_array_equal(tbs.unpack_w3(w3, tl), w)
    np.testing.assert_array_equal(
        tbs.stack_w3_gates([w3, 2 * w3]),
        np.asarray(jbs.stack_w3_gates([w3, 2 * w3])))


def test_masks_cross_convert_unchanged(jbs):
    """Both packages derive the same col_idx from a model's masks after
    they cross ``convert`` (float32 0/1 both ways)."""
    mask, bs, _ = _mask("cgs16x_rec_1024", seed=4)
    tree = {"params": {}, "state": {}, "masks": {"hcgs_ufh0": mask}}
    ported = convert.from_jax_variables(tree)["masks"]["hcgs_ufh0"]
    back = convert.to_jax_variables({"masks": {"hcgs_ufh0": ported}})
    np.testing.assert_array_equal(back["masks"]["hcgs_ufh0"], mask)
    np.testing.assert_array_equal(
        tbs.pack_layout(ported.numpy(), bs).col_idx,
        jbs.pack_layout(mask, bs).col_idx)


def test_gather_v3_matches_jax(jbs):
    """gather_blocks_multi + v3_from_blocks, values and gradient (the
    cotangent scatters back into the dense weights)."""
    import jax
    import jax.numpy as jnp
    mask, bs, _ = _mask("small_32_50", seed=2)
    jl, tl = jbs.pack_layout(mask, bs), tbs.pack_layout(mask, bs)
    rng = np.random.RandomState(3)
    ws = [rng.randn(*mask.shape).astype(np.float32) for _ in range(4)]
    ct = rng.randn(tl.Nb, 4 * bs, tl.R * bs).astype(np.float32)
    w3_j, vjp = jax.vjp(lambda *w: jbs.v3_from_blocks(
        jbs.gather_blocks_multi(list(w), jl), jl, 4)[0],
        *[jnp.asarray(w) for w in ws])
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    w3_t = tbs.v3_from_blocks(tbs.gather_blocks_multi(tw, tl), tl, 4)
    np.testing.assert_array_equal(w3_t.detach().numpy(), np.asarray(w3_j))
    w3_t.backward(torch.from_numpy(ct))
    for a, b in zip(tw, vjp(jnp.asarray(ct))):
        np.testing.assert_array_equal(a.grad.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the block-sparse dw kernel (_make_dw_v3)
# ---------------------------------------------------------------------------

def _dw_inputs(seed=5, M=24, G=4):
    mask = hcgs_mask(32, 48, [8, 2], [50, 50], rng=np.random.RandomState(seed))
    rng = np.random.RandomState(seed + 1)
    layout = tbs.pack_layout(mask, 8)
    dg = rng.randn(M, layout.Nb * G * 8).astype(np.float32)
    x = rng.randn(M, 48).astype(np.float32)
    sub3 = np.concatenate([tbs.pack_w3(mask, layout)] * G, axis=1)
    return mask, dg, x, sub3


@pytest.mark.parametrize("with_sub", [False, True], ids=["plain", "fuse_sub"])
def test_dw_twin_matches_v3_kernel(jbs, with_sub):
    import jax.numpy as jnp
    mask, dg, x, sub3 = _dw_inputs()
    jl, tl = jbs.pack_layout(mask, 8), tbs.pack_layout(mask, 8)
    dwk = jbs._build_v3_ops(jl, 4, 8, True, with_sub)[2]
    ref = dwk(jnp.asarray(dg), jnp.asarray(x), jnp.float32,
              jnp.asarray(sub3) if with_sub else None)
    tt = torch.from_numpy
    got = tbs.block_sparse_dw(tt(dg), tt(x), tl, 4,
                              tt(sub3) if with_sub else None)
    assert tuple(got.shape) == (tl.Nb, 4 * 8, tl.R * 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_dw_wrapper_rejects_bad_inputs():
    mask, dg, x, sub3 = _dw_inputs()
    tl = tbs.pack_layout(mask, 8)
    tt = torch.from_numpy
    with pytest.raises(ValueError, match="dg_flat must be"):
        tbs.block_sparse_dw(tt(dg[:, :-1]), tt(x), tl, 4)
    with pytest.raises(ValueError, match="float32"):
        tbs.block_sparse_dw(tt(dg).double(), tt(x), tl, 4)
    with pytest.raises(ValueError, match="sub3 must be"):
        tbs.block_sparse_dw(tt(dg), tt(x), tl, 4, tt(sub3[:1]))


# ---------------------------------------------------------------------------
# the sparse recurrence
# ---------------------------------------------------------------------------

def _rec_inputs(seed):
    """Gates, an HCGS (H, H) mask shared by the four gates, the masked
    stacked U, its w3g, a (B, H) dropout mask and upstream cotangents."""
    rng = np.random.RandomState(seed)
    mask = hcgs_mask(H, H, [BS], [50.0], rng=rng)
    U = (rng.randn(4 * H, H) * 0.2).astype(np.float32) * np.tile(mask, (4, 1))
    layout = tbs.pack_layout(mask, BS)
    w3g = tbs.stack_w3_gates([tbs.pack_w3(U[g * H:(g + 1) * H], layout)
                              for g in range(4)])
    g = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    drop = (rng.rand(B, H) > 0.2).astype(np.float32)
    dhs = rng.randn(T, B, H).astype(np.float32)
    return mask, U, w3g, g, drop, dhs


def _j_layout(jbs, mask):
    return jbs.pack_layout(np.asarray(mask), BS)


def _j_fwd(jfl, jl, act, qbits, stash):
    return jfl._build_fwd_sparse(T, B, H, act, qbits, jl.Nb, jl.R, BS, 4,
                                 tuple(int(v) for v in jl.col_idx), True,
                                 stash=stash)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ACTS)
def test_forward_twins_match_pallas(jbs, jfl, act, qbits, bf16):
    """The stash forward twin (and the plain one, its first two outputs)
    against _build_fwd_sparse, w3g in f32 or cast to bf16 as the JAX op
    casts it."""
    import jax.numpy as jnp
    mask, _, w3g, g, drop, _ = _rec_inputs(7)
    jl, tl = _j_layout(jbs, mask), tbs.pack_layout(mask, BS)
    wj = jnp.asarray(w3g).astype(jnp.bfloat16 if bf16 else jnp.float32)
    ref = _j_fwd(jfl, jl, act, qbits, True)(jnp.asarray(g), wj,
                                            jnp.asarray(drop))
    tt = torch.from_numpy
    got = tfl.fused_lstm_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act, qbits,
                                    bf16, stash=True)
    plain = tfl.fused_lstm_fwd_sparse(tt(g), tt(w3g), tt(drop), tl, act,
                                      qbits, bf16)
    atol = 2e-2 if bf16 else 1e-5
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    for a, b in zip(plain, got[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_bwd_twins_match_pallas(jbs, jfl, stash, act, bf16):
    """Each sparse BPTT twin against its TPU kernel on the same forward
    residuals (from the JAX stash forward) and cotangents."""
    import jax.numpy as jnp
    mask, _, w3g, g, drop, dhs = _rec_inputs(11)
    jl, tl = _j_layout(jbs, mask), tbs.pack_layout(mask, BS)
    qbits = 0 if stash else 16
    j = jnp.asarray
    wj = j(w3g).astype(jnp.bfloat16 if bf16 else jnp.float32)
    hs, cs, acts = (np.array(a) for a in _j_fwd(jfl, jl, act, qbits, True)(
        j(g), wj, j(drop)))
    z = np.zeros((1, B, H), np.float32)
    h_prev, c_prev = np.concatenate([z, hs[:-1]]), np.concatenate([z, cs[:-1]])
    col = tuple(int(v) for v in jl.col_idx)
    tt = torch.from_numpy
    if stash:
        ref = jfl._build_bwd_sparse_stash(T, B, H, act, jl.Nb, jl.R, BS, 4,
                                          col, True)(
            j(acts), wj, j(drop), j(cs), j(c_prev), j(dhs))
        got = tfl.fused_lstm_bwd_sparse_stash(tt(acts), tt(w3g), tt(drop),
                                              tt(cs), tt(c_prev), tt(dhs), tl,
                                              act, bf16)
    else:
        ref = jfl._build_bwd_sparse(T, B, H, act, qbits, jl.Nb, jl.R, BS, 4,
                                    col, True)(
            j(g), wj, j(drop), j(h_prev), j(c_prev), j(dhs))
        got = tfl.fused_lstm_bwd_sparse(tt(g), tt(w3g), tt(drop), tt(h_prev),
                                        tt(c_prev), tt(dhs), tl, act, qbits,
                                        bf16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=2e-2 if bf16 else 1e-5)


def _torch_sparse(g, w3g, drop, dhs, layout, act, qbits, dev="cpu"):
    tt = lambda a: torch.from_numpy(a).to(dev)
    leaves = [tt(g).requires_grad_(), tt(w3g).requires_grad_()]
    hs = tfl.lstm_scan_fused_sparse(leaves[0], leaves[1], layout, tt(drop),
                                    act=act, quant_bits=qbits)
    hs.backward(tt(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_match_jax_vjp(jbs, jfl, monkeypatch, stash, qbits,
                                      act):
    """hs and the gradients of gates and w3g of the port's
    lstm_scan_fused_sparse against jax.vjp of the JAX one, both packages
    on the same stash/recompute choice."""
    import jax
    import jax.numpy as jnp
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)
    assert tfl.bwd_stash_enabled("lstm") == jfl._bwd_stash_enabled("lstm")
    mask, _, w3g, g, drop, dhs = _rec_inputs(13)
    jl, tl = _j_layout(jbs, mask), tbs.pack_layout(mask, BS)
    hs, vjp = jax.vjp(lambda g_, w_: jfl.lstm_scan_fused_sparse(
        g_, w_, jl, jnp.asarray(drop), act=act, quant_bits=qbits,
        interpret=True), jnp.asarray(g), jnp.asarray(w3g))
    ref = [np.asarray(a) for a in (hs,) + vjp(jnp.asarray(dhs))]
    got = _torch_sparse(g, w3g, drop, dhs, tl, act, qbits)
    for name, a, b, atol in zip(["hs", "dgates", "dw3g"], got, ref,
                                (1e-5, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_function_grads_equal_dense_autograd(monkeypatch, stash):
    """Independent of JAX: the sparse Function's gates gradient and its
    dw3g equal torch.autograd through the dense plain loop over the
    masked U, dU gathered into the w3g layout."""
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    mask, U, w3g, g, drop, dhs = _rec_inputs(17)
    tl = tbs.pack_layout(mask, BS)
    got = _torch_sparse(g, w3g, drop, dhs, tl, "tanh", 16)
    gl, Ul = (torch.from_numpy(a).requires_grad_() for a in (g, U))
    hs, _ = tfl.fused_lstm_fwd_plain(gl, Ul, torch.from_numpy(drop), None,
                                     None, "tanh", 16, False)
    hs.backward(torch.from_numpy(dhs))
    dU = Ul.grad.numpy()
    dw3g = tbs.stack_w3_gates([tbs.pack_w3(dU[k * H:(k + 1) * H], tl)
                               for k in range(4)])
    np.testing.assert_allclose(got[0], hs.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1], gl.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(got[2], dw3g, atol=1e-4)


@pytest.mark.parametrize("env", [None, "1", "4", "40"])
def test_scan_fits_is_the_jax_rule(jfl, monkeypatch, env):
    if env is None:
        monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    else:
        monkeypatch.setenv("PKC_SPARSE_SCAN_VMEM_MB", env)
    for name in ("cgs16x_rec_1024", "rec_256_50", "small_32_50"):
        mask, bs, _ = _mask(name)
        layout = tbs.pack_layout(mask, bs)
        for b in (4, 8, 16, 64, 256):
            assert tfl.sparse_scan_fits(b, mask.shape[0], layout) == \
                jfl.sparse_scan_fits_vmem(b, mask.shape[0], layout)


def test_sparse_wrappers_reject_bad_inputs():
    mask, _, w3g, g, drop, dhs = (a if not isinstance(a, np.ndarray) else
                                  torch.from_numpy(a)
                                  for a in _rec_inputs(0))
    tl = tbs.pack_layout(mask.numpy(), BS)
    with pytest.raises(ValueError, match="w3g must be"):
        tfl.fused_lstm_fwd_sparse(g, w3g[:, :-1], drop, tl)
    with pytest.raises(ValueError, match="layout"):
        tfl.fused_lstm_fwd_sparse(g[..., :-4], w3g, drop, tl)
    with pytest.raises(ValueError, match="dhs must be"):
        tfl.fused_lstm_bwd_sparse(g, w3g, drop, dhs, dhs, dhs[:-1], tl)
    with pytest.raises(RuntimeError, match="no autograd"):
        tfl.fused_lstm_fwd_sparse(g.requires_grad_(), w3g, drop, tl)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def lstm_opts(mode="auto", cdt="", quant_inp=False, x_drop="75,75",
              x_block="128,8"):
    """One 256-wide layer, 128-blocks: 50% on h (Kb=2, R=1), and by
    default the CGS-16x x-projection (dense under auto: Kb < 16)."""
    return {
        "compute_dtype": cdt, "to_do": "train", "arch_name": "lstm",
        "lstm_lay": "256", "lstm_drop": "0.0", "lstm_use_batchnorm": "True",
        "lstm_use_laynorm": "False", "lstm_use_laynorm_inp": "False",
        "lstm_use_batchnorm_inp": "False", "lstm_act": "tanh",
        "lstm_orthinit": "True", "lstm_bidir": "False", "lstm_hcgs": "True",
        "hcgsx_block": x_block, "hcgsx_sparse": x_drop,
        "hcgsh_block": "128,8", "hcgsh_sparse": "50,75",
        "lstm_quant": "True", "param_quant": "8,8",
        "lstm_quant_inp": str(quant_inp), "inp_quant": "16",
        "lstm_prune": "False", "lstm_prune_perc": "0",
        "skip_regularization": "True", "lstm_block_sparse": mode,
        "lstm_fused_scan": "True", "scan_unroll": "1"}


F_IN = 40


def _lstm_x(T_=8, B_=4):
    return np.random.RandomState(2).randn(T_, B_, F_IN).astype(np.float32)


def _spy_sparse(monkeypatch):
    calls = []
    real = tfl.fused_lstm_fwd_sparse_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tfl, "fused_lstm_fwd_sparse_plain", spy)
    return calls


def test_lstm_auto_matches_its_dense_path(monkeypatch):
    """auto (sparse recurrence) vs False (dense fused) on the same
    variables: forward 1e-5, U gradients 1e-4."""
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM
    calls = _spy_sparse(monkeypatch)
    x = torch.from_numpy(_lstm_x())
    out = {}
    for mode in ("auto", "False"):
        m = LSTM(lstm_opts(mode), F_IN, seed=0, device="cpu")
        assert (0 in m._rec_layouts) == (mode == "auto")
        y = m.run(x, train=True)
        (y * y).sum().backward()
        out[mode] = (y.detach().numpy(),
                     {k: p.grad.numpy() for k, p in m.params.items()})
    assert calls      # the sparse path really ran
    np.testing.assert_allclose(out["auto"][0], out["False"][0], atol=1e-5)
    for k, gr in out["False"][1].items():
        tol = 1e-4 if k.startswith("u") else 1e-5
        np.testing.assert_allclose(out["auto"][1][k], gr, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_lstm_sparse_matches_jax(monkeypatch, cdt):
    """The port's LSTM under auto against the JAX LSTM with
    lstm_fused_scan=True, variables from the JAX init: the same layer
    takes the sparse recurrence in both packages, and under bf16 both run
    it in float32 (before the port took it, its dense bf16 recurrence
    differed from the JAX package's by ~2e-4 here)."""
    import jax
    import pytorch_kaldi_cgs_tpu.models as JM
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM
    calls = _spy_sparse(monkeypatch)
    opts = lstm_opts(cdt=cdt)
    jm = JM.LSTM(opts, F_IN)
    tree = jm.init(0)
    jm.prepare_block_sparse(tree)
    assert 0 in jm._rec_layouts and not jm._bs_layouts
    x = _lstm_x(T_=16)
    y_ref, _ = jm.apply(jm.pack_variables(tree), x, train=True,
                        rng=jax.random.PRNGKey(0))
    port = LSTM(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))
    with torch.no_grad():
        y = port.run(torch.from_numpy(x), train=True)
    assert calls
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)


def test_x_projection_on_v3_raises(monkeypatch):
    """Where the JAX rule puts an x-projection on the v3 kernels (True,
    or auto with Kb >= 16 and R*2 <= Kb) the port takes them too (it
    raised before they were ported) and gives the dense-masked
    projection's output; auto keeps a Kb=8 input dense."""
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP
    calls = []
    real = tbs.block_sparse_v3_fwd_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tbs, "block_sparse_v3_fwd_plain", spy)
    x50 = {"x_drop": "50", "x_block": "128"}
    assert 0 in LSTM(lstm_opts("auto", **x50), 2048, device="cpu")._bs_layouts
    m = LSTM(lstm_opts("auto", **x50), 1024, device="cpu")      # Kb=8
    assert 0 in m._rec_layouts and not m._bs_layouts
    x = torch.from_numpy(np.random.RandomState(3).randn(6, 2, 256)
                         .astype(np.float32))
    ys = {}
    for mode in ("True", "False"):
        m = LSTM(lstm_opts(mode, **x50), 256, seed=1, device="cpu")
        assert (0 in m._bs_layouts) == (mode == "True")
        with torch.no_grad():
            ys[mode] = m.run(x, train=False).numpy()
    assert calls
    np.testing.assert_allclose(ys["True"], ys["False"], atol=1e-5)


@pytest.mark.parametrize("width,mode,raises", [
    (1944, "auto", False), (48, "auto", False), (1944, "True", False),
    (2048, "auto", True), (512, "True", True), (512, "False", False)])
def test_mlp_block_sparse_rule(width, mode, raises):
    """The MLP keeps a layer dense where the JAX rule does (the 1944-way
    and mono heads: not multiples of 128; auto with Kb < 16) and takes
    the v3 kernels where it would (``raises``: it raised before they
    were ported)."""
    opts = {"to_do": "train", "arch_name": "mlp", "dnn_lay": str(width),
            "dnn_drop": "0.0", "dnn_use_batchnorm": "False",
            "dnn_use_laynorm": "False", "dnn_use_laynorm_inp": "False",
            "dnn_use_batchnorm_inp": "False", "dnn_act": "softmax",
            "mlp_hcgs": "True", "hcgs_block": "128,8",
            "hcgs_sparse": "75,75", "mlp_quant": "False", "param_quant": "8",
            "mlp_quant_inp": "False", "inp_quant": "16",
            "mlp_block_sparse": mode}
    from pytorch_kaldi_cgs_tpu_torch.models import MLP
    m = MLP(opts, 2048, device="cpu")
    assert (0 in m._bs_layouts) == raises


# ---------------------------------------------------------------------------
# three train steps of a narrow CGS-16x-shaped net against the JAX runner
# ---------------------------------------------------------------------------

CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg", "TIMIT_CGS",
                   "TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg")
N_CD, N_MONO, FEAT = 40, 12, 143
SEED, STEPS, ST_T, ST_B = 3, 3, 16, 4


def cgs_chunk_config(lay="256,256", n_cd=N_CD, n_mono=N_MONO, batch=ST_B,
                     arch_library=None):
    """The cfg's [architecture1..3] and [model] with the LSTM widths set
    to ``lay`` and lstm_block_sparse=auto, over an in-memory chunk of an
    fMLLR-shaped feature and the cd and mono label streams."""
    src = configparser.ConfigParser()
    src.read(CFG)
    cc = configparser.ConfigParser()
    cc.read_string("[exp]\nto_do = train\nseed = 0\n\n[batches]\n"
                   "batch_size_train = %d\n\n[data_chunk]\n"
                   "fea = fea_name=fmllr\n\tfea_lst=none\n\tfea_opts=none\n"
                   "\tcw_left=0\n\tcw_right=0\n"
                   "lab = lab_name=lab_cd\n\tlab_folder=none\n"
                   "\tlab_opts=ali-to-pdf\n\n\tlab_name=lab_mono\n"
                   "\tlab_folder=none\n\tlab_opts=ali-to-phones\n" % batch)
    for sec in ("architecture1", "architecture2", "architecture3", "model"):
        cc[sec] = dict(src[sec])
    cc["architecture1"]["lstm_lay"] = lay
    cc["architecture1"]["lstm_block_sparse"] = "auto"
    cc["architecture2"]["dnn_lay"] = str(n_cd)
    cc["architecture3"]["dnn_lay"] = str(n_mono)
    if arch_library:
        for sec in ("architecture1", "architecture2", "architecture3"):
            cc[sec]["arch_library"] = arch_library
    return cc


def cgs_data(T_, B_, n_cd=N_CD, n_mono=N_MONO, seed=0):
    """(T_*B_, FEAT + 2) frames of B_ sentences: x ~ N(0, 1), cd labels,
    mono labels, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T_, B_, FEAT).astype(np.float32)
    cd = rng.randint(0, n_cd, (T_, B_))
    mono = rng.randint(0, n_mono, (T_, B_))
    return np.concatenate([np.concatenate(
        [x[:, b], cd[:, b, None], mono[:, b, None]], 1)
        for b in range(B_)]).astype(np.float32)


def test_cgs_train_steps_match_jax(monkeypatch):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.data import dataset as jdata
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    monkeypatch.delenv("PKC_SPARSE_SCAN_VMEM_MB", raising=False)
    calls = _spy_sparse(monkeypatch)
    cc = cgs_chunk_config()
    cc["architecture1"]["lstm_fused_scan"] = "True"   # JAX: sparse on CPU
    data = cgs_data(ST_T, ST_B)
    ends = np.cumsum([ST_T] * ST_B)
    names = ["u%d" % b for b in range(ST_B)]
    jchunk = jdata.ChunkData(
        names, data, ends,
        {"fmllr": jdata.FeaStream("fmllr", "none", col_start=0,
                                  col_end=FEAT)},
        {"lab_cd": jdata.LabStream("lab_cd", "none", col=FEAT),
         "lab_mono": jdata.LabStream("lab_mono", "none", col=FEAT + 1)})
    pchunk = tdata.ChunkData(
        names, data, ends,
        {"fmllr": tdata.FeaStream("fmllr", "none", col_start=0,
                                  col_end=FEAT)},
        {"lab_cd": tdata.LabStream("lab_cd", "none", col=FEAT),
         "lab_mono": tdata.LabStream("lab_mono", "none", col=FEAT + 1)})
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    for arch in jg.net_order:       # as the JAX package's run_nn does
        jg.nets[arch].prepare_block_sparse(jv[arch])
        jv[arch] = jg.nets[arch].pack_variables(jv[arch])
    assert sorted(jg.nets["LSTM_layers"]._rec_layouts) == [0, 1]
    jr = JC.ChunkRunner(jg, cc)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    assert sorted(tg.nets["LSTM_layers"]._rec_layouts) == [0, 1]
    jres, tres = [], []
    batches = tchunk.make_seq_batches(pchunk, ST_B, True,
                                      np.random.RandomState(SEED), bucket=ST_T)
    inp, mask, _, _ = next(batches)
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
    assert len(calls) == 2 * STEPS         # both layers, every step
    np.testing.assert_allclose(tres, jres, rtol=1e-5)
    assert tres[-1][0] < tres[0][0]


# ---------------------------------------------------------------------------
# on the card: each kernel against its twin (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_sub", [False, True], ids=["plain", "fuse_sub"])
def test_cuda_dw_kernel_matches_twin(cuda_device, with_sub):
    mask, dg, x, sub3 = _dw_inputs()
    tl = tbs.pack_layout(mask, 8)
    tt = lambda a: torch.from_numpy(a).to(cuda_device)
    before = tbs.block_sparse_dw.launches
    got = tbs.block_sparse_dw(tt(dg), tt(x), tl, 4,
                              tt(sub3) if with_sub else None)
    assert tbs.block_sparse_dw.launches == before + 1
    ref = tbs.block_sparse_dw_plain(tt(dg), tt(x), tl, 4,
                                    tt(sub3) if with_sub else None)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5)


def _twin_steps(g, w3g, drop, layout, act, qbits, bf16, hs, cs):
    """The forward twin's step t from the kernel's own (h, c) of step
    t-1, for every t: (hs, cs, acts) that differ from the kernel's only
    by the float32 summation order of one step."""
    rec_u, _ = tfl._sparse_fns(w3g, layout, bf16)
    z = torch.zeros_like(hs[0])
    out = [tfl.lstm_cell(g[t], hs[t - 1] if t else z, cs[t - 1] if t else z,
                         rec_u, drop, tfl.ACTS[act], qbits, bf16)
           for t in range(g.shape[0])]
    return tuple(torch.stack(v) for v in zip(*out))


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_sparse_kernels_match_twins(cuda_device, bf16, act, qbits):
    """The sparse forward (plain and stash) and both sparse BPTT kernels
    against their twins on the card, on the same tensors. With w3g in
    bf16 a one-ulp difference in h can round q(h) to the neighbouring
    bf16 value and grow over the steps, so there the forward is held
    step by step: the twin's step from the kernel's previous (h, c)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mask, _, w3g, g, drop, dhs = _rec_inputs(19)
    tl = tbs.pack_layout(mask, BS)
    tt = lambda a: torch.from_numpy(a).to(cuda_device)
    g, w3g, drop, dhs = tt(g), tt(w3g), tt(drop), tt(dhs)
    atol = 2e-2 if bf16 else 1e-5
    with torch.no_grad():
        before = tfl.fused_lstm_fwd_sparse.launches
        hs, cs, acts = tfl.fused_lstm_fwd_sparse(g, w3g, drop, tl, act, qbits,
                                                 bf16, stash=True)
        hs2, cs2 = tfl.fused_lstm_fwd_sparse(g, w3g, drop, tl, act, qbits,
                                             bf16)
        route = tfl.lstm_fwd_sparse_route(B, tl, bf16, cuda_device)[0]
        assert tfl.fused_lstm_fwd_sparse.launches == \
            before + 2 * tfl.lstm_fwd_sparse_launches(route, T)
        if bf16:
            ref = _twin_steps(g, w3g, drop, tl, act, qbits, bf16, hs, cs)
        else:
            ref = tfl.fused_lstm_fwd_sparse_plain(g, w3g, drop, tl, act,
                                                  qbits, bf16, True)
        for a, b in zip((hs, cs, acts, hs2, cs2), ref + ref[:2]):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       atol=1e-5)
        z = torch.zeros_like(hs[:1])
        h_prev, c_prev = torch.cat([z, hs[:-1]]), torch.cat([z, cs[:-1]])
        got = tfl.fused_lstm_bwd_sparse_stash(acts, w3g, drop, cs, c_prev,
                                              dhs, tl, act, bf16)
        ref = tfl.fused_lstm_bwd_sparse_stash_plain(acts, w3g, drop, cs,
                                                    c_prev, dhs, tl, act,
                                                    bf16)
        got_r = tfl.fused_lstm_bwd_sparse(g, w3g, drop, h_prev, c_prev, dhs,
                                          tl, act, qbits, bf16)
        ref_r = tfl.fused_lstm_bwd_sparse_plain(g, w3g, drop, h_prev, c_prev,
                                                dhs, tl, act, qbits, bf16)
    torch.cuda.synchronize()
    for a, b in ((got, ref), (got_r, ref_r)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_sparse_persist_routes_give_the_step_bits(cuda_device, bf16, act,
                                                       qbits):
    """Rows 4 and 5 at every block shape of their tables (persistent,
    forced) give the bits of their step routes (forced): the forward's
    hs, cs and acts, the stash chain's dg, whole rows and one entry a
    slab alike; the routes the wrappers pick at this shape are the
    persistent ones."""
    mask, _, w3g, g, drop, dhs = _rec_inputs(31)
    tl = tbs.pack_layout(mask, BS)
    tt = lambda a: torch.from_numpy(a).to(cuda_device)
    g, w3g, drop, dhs = tt(g), tt(w3g), tt(drop), tt(dhs)
    assert tfl.lstm_fwd_sparse_route(B, tl, bf16, cuda_device)[0] == \
        "persist"
    assert tfl.lstm_bwd_sparse_stash_route(B, tl, bf16, cuda_device)[0] == \
        "persist"
    with torch.no_grad():
        fargs = (g, w3g, drop, tl, act, qbits, bf16, True)
        st = tfl._fwd_sparse_step(*fargs)
        for shape in tfl.LSTM_FWD_SPARSE_SHAPES:
            got = tfl._fwd_sparse_persist(
                tfl.lstm_fwd_sparse_plan(B, tl, shape), *fargs)
            assert all(torch.equal(a, b) for a, b in zip(got, st)), shape
        hs, cs, acts = st
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        bargs = (acts, w3g, drop, cs, c_prev, dhs, tl, act, bf16)
        dg_st = tfl._bwd_sparse_step(tfl.fused_lstm_bwd_sparse_stash, acts,
                                     w3g, drop, None, cs, c_prev, dhs, tl,
                                     act, 0, bf16, True)
        for shape in tfl.LSTM_BWD_SPARSE_SHAPES:
            plan = tfl.lstm_bwd_sparse_stash_plan(B, H, BS, tl.C, shape)
            slabbed = tfl.lstm_bwd_sparse_stash_plan(B, H, BS, tl.C, shape,
                                                     entry_slabs=True)
            for p in (plan, slabbed):
                dg = tfl._bwd_sparse_stash_persist(p, *bargs)
                assert torch.equal(dg, dg_st), (shape, p.slabs)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [97, 421])
@pytest.mark.parametrize("rows", [8, 16])
def test_cuda_sparse_routes_at_the_cgs16x_layout(cuda_device, seed, rows):
    """At the CGS-16x layout (1024 wide, C = 3 at seed 97, C = 5 at 421:
    one entry a slab at 16 rows) both wrappers take the persistent route,
    one launch a call, within 1e-4 of their twins (tanh, qbits 16: an ulp
    at a ceil step of the quantizer moves h by one of its levels) and bit
    for bit their step routes."""
    Hc, Tc = 1024, 12
    mask = hcgs_mask(Hc, Hc, [128, 8], [75, 75],
                     rng=np.random.RandomState(seed))
    tl = tbs.pack_layout(mask, 128)
    rng = np.random.RandomState(seed + 1)
    U = (rng.randn(4 * Hc, Hc) / 8.0).astype(np.float32) * np.tile(mask,
                                                                   (4, 1))
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        cuda_device)
    w3g = tt(tbs.stack_w3_gates([tbs.pack_w3(U[k * Hc:(k + 1) * Hc], tl)
                                 for k in range(4)]))
    g = tt(rng.randn(Tc, rows, 4 * Hc) * 0.5)
    drop = tt(rng.rand(rows, Hc) > 0.2)
    dhs = tt(rng.randn(Tc, rows, Hc) * 0.1)
    fwd, bwd = tfl.fused_lstm_fwd_sparse, tfl.fused_lstm_bwd_sparse_stash
    assert tfl.lstm_fwd_sparse_route(rows, tl, False, cuda_device)[0] == \
        "persist"
    route, plan = tfl.lstm_bwd_sparse_stash_route(rows, tl, False,
                                                  cuda_device)
    assert route == "persist" and plan.slabs == (5 if (seed, rows) == (
        421, 16) else 1)
    with torch.no_grad():
        n0, n1 = fwd.launches, bwd.launches
        hs, cs, acts = fwd(g, w3g, drop, tl, "tanh", 16, stash=True)
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        dg = bwd(acts, w3g, drop, cs, c_prev, dhs, tl)
        assert (fwd.launches - n0, bwd.launches - n1) == (1, 1)
        ref = tfl.fused_lstm_fwd_sparse_plain(g, w3g, drop, tl, "tanh", 16,
                                              False, True)
        for a, b in zip((hs, cs, acts), ref):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       atol=1e-4)
        np.testing.assert_allclose(
            dg.cpu().numpy(), tfl.fused_lstm_bwd_sparse_stash_plain(
                acts, w3g, drop, cs, c_prev, dhs, tl).cpu().numpy(),
            atol=1e-5)
        st = tfl._fwd_sparse_step(g, w3g, drop, tl, "tanh", 16, False, True)
        assert all(torch.equal(a, b) for a, b in zip((hs, cs, acts), st))
        assert torch.equal(dg, tfl._bwd_sparse_step(
            bwd, acts, w3g, drop, None, cs, c_prev, dhs, tl, "tanh", 0,
            False, True))


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_sparse_function_grads_match_cpu(cuda_device, monkeypatch,
                                              stash):
    """lstm_scan_fused_sparse on the card (forward, BPTT and dw kernels)
    against the same call on the CPU (the twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    mask, _, w3g, g, drop, dhs = _rec_inputs(23)
    tl = tbs.pack_layout(mask, BS)
    before = tbs.block_sparse_dw.launches
    got = _torch_sparse(g, w3g, drop, dhs, tl, "tanh", 16, dev=cuda_device)
    assert tbs.block_sparse_dw.launches == before + 1
    ref = _torch_sparse(g, w3g, drop, dhs, tl, "tanh", 16)
    for a, b, atol in zip(got, ref, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(a, b, atol=atol)
