"""The port's fused LSTM (pytorch_kaldi_cgs_tpu_torch/ops/fused_lstm.py)
against the JAX package's Pallas kernels run in interpret mode, on the
same numpy inputs: the forward in every variant (float32/bf16 dots x
zero/seeded carry x no/16-bit recurrent-input quantization x a (B, H)
dropout mask or the (1, 1) eval scalar), the stash forward, both BPTT
twins step by step, and the autograd Function's gradients against
``jax.vjp`` of the JAX custom VJPs (also under stash/recompute).

Tolerances: float32 atol 1e-5 — the dots sum in another order than
XLA's, and 12 steps compound it (the JAX package's own fused-vs-scan bar
is 1e-6); bf16 atol 2e-2 — the JAX package's bf16 bar
(tests/test_fused_lstm.py), since one-ulp input differences can round a
value to a neighbouring bf16 one.

JAX comes in through a fixture, so that the CUDA cases also run where JAX
is not installed
(``python -m pytest --noconftest -m cuda tests/test_torch_fused_lstm.py``).
"""
import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl

T, B, H = 12, 4, 16


def _inputs(seed, drop_bh):
    rng = np.random.RandomState(seed)
    g = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    U = (rng.randn(4 * H, H) * 0.2).astype(np.float32)
    if drop_bh:
        drop = (rng.rand(B, H) > 0.2).astype(np.float32)
    else:
        drop = np.full((1, 1), 0.8, np.float32)
    h0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    return g, U, drop, h0, c0


@pytest.fixture
def jfl():
    return pytest.importorskip("pytorch_kaldi_cgs_tpu.ops.fused_lstm")


def _jax(jfl, g, U, drop, h0, c0, seeded, qbits, bf16):
    import jax.numpy as jnp
    cdt = "bf16" if bf16 else ""
    if not seeded:
        hs = jfl.lstm_scan_fused(jnp.asarray(g), jnp.asarray(U),
                                 jnp.asarray(drop), quant_bits=qbits,
                                 interpret=True, compute_dtype=cdt)
        return np.asarray(hs), None
    if bf16:   # the stream entry has no bf16 dots; the seeded one does
        hs, (_, cT) = jfl.lstm_scan_fused_seeded(
            jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop),
            jnp.asarray(h0), jnp.asarray(c0), quant_bits=qbits,
            interpret=True, compute_dtype=cdt)
    else:
        hs, (_, cT) = jfl.lstm_scan_fused_stream(
            jnp.asarray(g), jnp.asarray(U), jnp.asarray(drop),
            jnp.asarray(h0), jnp.asarray(c0), quant_bits=qbits,
            interpret=True)
    return np.asarray(hs), np.asarray(cT)


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_twin_matches_pallas_interpret(jfl, bf16, seeded, qbits,
                                             drop_bh):
    g, U, drop, h0, c0 = _inputs(3, drop_bh)
    hs_ref, cT_ref = _jax(jfl, g, U, drop, h0, c0, seeded, qbits, bf16)
    tt = torch.from_numpy
    if seeded:
        hs, (_, cT) = tfl.lstm_scan_fused_stream(
            tt(g), tt(U), tt(drop), tt(h0), tt(c0), quant_bits=qbits,
            compute_dtype="bf16" if bf16 else "")
    else:
        hs = tfl.lstm_scan_fused(tt(g), tt(U), tt(drop), quant_bits=qbits,
                                 compute_dtype="bf16" if bf16 else "")
    atol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(hs.numpy(), hs_ref, atol=atol)
    if seeded:
        np.testing.assert_allclose(cT.numpy(), cT_ref, atol=atol)
    if bf16:   # the bf16 dots really ran: the result differs from f32
        hs32, _ = tfl.fused_lstm_fwd(tt(g), tt(U), tt(drop),
                                     *((tt(h0), tt(c0)) if seeded else ()),
                                     qbits=qbits)
        assert float((hs - hs32).abs().max()) > 0


def test_wrapper_rejects_bad_inputs():
    g, U, drop, h0, c0 = (torch.from_numpy(a) for a in _inputs(0, True))
    with pytest.raises(ValueError, match="U must be"):
        tfl.fused_lstm_fwd(g, U[:, :-1], drop)
    with pytest.raises(ValueError, match="go together"):
        tfl.fused_lstm_fwd(g, U, drop, h0=h0)
    with pytest.raises(ValueError, match="float32"):
        tfl.fused_lstm_fwd(g.double(), U, drop)
    with pytest.raises(ValueError, match="activation"):
        tfl.fused_lstm_fwd(g, U, drop, act="sigmoid")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain_twin(cuda_device, bf16):
    g, U, drop, h0, c0 = (torch.from_numpy(a).to(cuda_device)
                          for a in _inputs(5, True))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        before = tfl.fused_lstm_fwd.launches
        hs, cs = tfl.fused_lstm_fwd(g, U, drop, h0, c0, qbits=16, bf16=bf16)
        assert tfl.fused_lstm_fwd.launches == before + T
        hs_p, cs_p = tfl.fused_lstm_fwd_plain(g, U, drop, h0, c0, "tanh", 16,
                                              bf16)
    torch.cuda.synchronize()
    atol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(hs.cpu().numpy(), hs_p.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(cs.cpu().numpy(), cs_p.cpu().numpy(), atol=atol)


# ---------------------------------------------------------------------------
# stash forward and backward
# ---------------------------------------------------------------------------

ACT_NAMES = ["tanh", "relu", "htanh", "linear"]


def _atol(bf16):
    return 2e-2 if bf16 else 1e-5


def _bwd_inputs(seed, drop_bh=True):
    """Forward inputs plus a seeded carry and upstream cotangents."""
    g, U, drop, h0, c0 = _inputs(seed, drop_bh)
    rng = np.random.RandomState(seed + 100)
    dhs = rng.randn(T, B, H).astype(np.float32)
    dhT = rng.randn(B, H).astype(np.float32)
    dcT = rng.randn(B, H).astype(np.float32)
    return g, U, drop, h0, c0, dhs, dhT, dcT


@pytest.mark.parametrize("act", ACT_NAMES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stash_forward_twin_matches_pallas(jfl, bf16, act):
    import jax.numpy as jnp
    g, U, drop, h0, c0 = _inputs(7, True)
    cdt = "bf16" if bf16 else ""
    fwd = jfl._build_fwd(T, B, H, act, 16, True, with_init=True, cdt=cdt,
                         stash=True)
    ref = fwd(jnp.asarray(g), jnp.asarray(U).astype(
        jnp.bfloat16 if bf16 else jnp.float32), jnp.asarray(drop),
        jnp.asarray(h0), jnp.asarray(c0))
    tt = torch.from_numpy
    got = tfl.fused_lstm_fwd(tt(g), tt(U), tt(drop), tt(h0), tt(c0), act=act,
                             qbits=16, bf16=bf16, stash=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=_atol(bf16))


@pytest.mark.parametrize("act", ACT_NAMES)
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_bwd_twins_match_pallas_kernels(jfl, stash, seeded, act):
    """Each BPTT twin against its TPU kernel, fed the same forward
    residuals (from the JAX stash forward) and cotangents."""
    import jax.numpy as jnp
    g, U, drop, h0, c0, dhs, dhT, dcT = _bwd_inputs(11)
    qbits = 0 if stash else 16
    j = jnp.asarray
    if seeded:
        hs, cs, acts = jfl._build_fwd(T, B, H, act, qbits, True, True,
                                      stash=True)(j(g), j(U), j(drop), j(h0),
                                                  j(c0))
    else:
        hs, cs, acts = jfl._build_fwd(T, B, H, act, qbits, True,
                                      stash=True)(j(g), j(U), j(drop))
        h0 = c0 = np.zeros((B, H), np.float32)
    hs, cs, acts = (np.array(a) for a in (hs, cs, acts))
    h_prev = np.concatenate([h0[None], hs[:-1]])
    c_prev = np.concatenate([c0[None], cs[:-1]])
    seeds = (j(dhT), j(dcT)) if seeded else ()
    if stash:
        ref = jfl._build_bwd_stash(T, B, H, act, True, with_init=seeded)(
            j(acts), j(U), j(drop), j(cs), j(c_prev), j(dhs), *seeds)
    else:
        ref = jfl._build_bwd(T, B, H, act, qbits, True, with_init=seeded)(
            j(g), j(U), j(drop), j(h_prev), j(c_prev), j(dhs), *seeds)
    tt = torch.from_numpy
    tseeds = (tt(dhT), tt(dcT)) if seeded else (None, None)
    if stash:
        got = tfl.fused_lstm_bwd_stash_plain(
            tt(acts), tt(U), tt(drop),
            tt(cs), tt(c_prev), tt(dhs), *tseeds, act=act)
    else:
        got = tfl.fused_lstm_bwd_plain(
            tt(g), tt(U), tt(drop), tt(h_prev), tt(c_prev), tt(dhs), *tseeds,
            act=act, qbits=qbits)
    got = got if seeded else (got,)
    ref = ref if seeded else (ref,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _jax_vjp(jfl, g, U, drop, h0, c0, dhs, dhT, dcT, seeded, qbits, bf16):
    import jax
    import jax.numpy as jnp
    cdt = "bf16" if bf16 else ""
    j = jnp.asarray
    if not seeded:
        hs, vjp = jax.vjp(lambda g_, U_: jfl.lstm_scan_fused(
            g_, U_, j(drop), quant_bits=qbits, interpret=True,
            compute_dtype=cdt), j(g), j(U))
        return [np.asarray(a) for a in (hs,) + vjp(j(dhs))]
    out, vjp = jax.vjp(lambda g_, U_, h_, c_: jfl.lstm_scan_fused_seeded(
        g_, U_, j(drop), h_, c_, quant_bits=qbits, interpret=True,
        compute_dtype=cdt), j(g), j(U), j(h0), j(c0))
    return [np.asarray(a) for a in (out[0],) + vjp((j(dhs), (j(dhT),
                                                             j(dcT))))]


def _torch_grads(g, U, drop, h0, c0, dhs, dhT, dcT, seeded, qbits, bf16,
                 dev="cpu"):
    tt = lambda a: torch.from_numpy(a).to(dev)
    leaves = [tt(g).requires_grad_(), tt(U).requires_grad_()]
    cdt = "bf16" if bf16 else ""
    if seeded:
        leaves += [tt(h0).requires_grad_(), tt(c0).requires_grad_()]
        hs, (hT, cT) = tfl.lstm_scan_fused_seeded(
            leaves[0], leaves[1], tt(drop), leaves[2], leaves[3],
            quant_bits=qbits, compute_dtype=cdt)
        torch.autograd.backward([hs, hT, cT], [tt(dhs), tt(dhT), tt(dcT)])
    else:
        hs = tfl.lstm_scan_fused(leaves[0], leaves[1], tt(drop),
                                 quant_bits=qbits, compute_dtype=cdt)
        hs.backward(tt(dhs))
    return [hs.detach().cpu().numpy()] + [x.grad.cpu().numpy()
                                          for x in leaves]


@pytest.mark.parametrize("drop_bh", [True, False], ids=["dropBH", "drop11"])
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize("qbits", [0, 16])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_function_grads_match_jax_vjp(jfl, monkeypatch, bf16, seeded, qbits,
                                      stash, drop_bh):
    """Grads of gates and U (and h0, c0 when seeded) of the autograd
    Function against jax.vjp of the JAX custom VJP, both packages on the
    same stash/recompute choice."""
    if stash:
        monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    else:
        monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "1")
    monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)
    assert tfl.bwd_stash_enabled("lstm") == jfl._bwd_stash_enabled("lstm")
    args = _bwd_inputs(13, drop_bh)
    ref = _jax_vjp(jfl, *args, seeded, qbits, bf16)
    got = _torch_grads(*args, seeded, qbits, bf16)
    assert len(got) == len(ref)
    for name, a, b in zip(["hs", "dgates", "dU", "dh0", "dc0"], got, ref):
        atol = _atol(bf16)
        if name == "dU" and qbits and not bf16:
            # dU sums dg * q(h_prev) over T*B: where the two forwards'
            # h differ by an ulp at a ceil step, q(h) lands one level
            # (max|h| / 2^15 ~ 2.4e-5 here) apart, times |dg| <= ~1
            atol = 5e-5
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
@pytest.mark.parametrize("qbits", [0, 16])
def test_function_grads_equal_autograd_through_plain_loop(monkeypatch, qbits,
                                                          stash):
    """Independent of JAX: the Function's backward (BPTT twin + one dU
    product) equals torch.autograd through the plain forward loop with
    its straight-through recurrent quantizer."""
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    g, U, drop, h0, c0, dhs, dhT, dcT = _bwd_inputs(17)
    got = _torch_grads(g, U, drop, h0, c0, dhs, dhT, dcT, True, qbits, False)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (g, U, h0, c0)]
    hs, cs = tfl.fused_lstm_fwd_plain(leaves[0], leaves[1],
                                      torch.from_numpy(drop), leaves[2],
                                      leaves[3], "tanh", qbits, False)
    torch.autograd.backward([hs, hs[-1], cs[-1]],
                            [torch.from_numpy(a) for a in (dhs, dhT, dcT)])
    ref = [hs.detach().numpy()] + [x.grad.numpy() for x in leaves]
    for name, a, b in zip(["hs", "dgates", "dU", "dh0", "dc0"], got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_bwd_wrappers_reject_bad_inputs():
    g, U, drop, h0, c0, dhs, dhT, dcT = (torch.from_numpy(a)
                                         for a in _bwd_inputs(0))
    cs = torch.zeros(T, B, H)
    with pytest.raises(ValueError, match="go together"):
        tfl.fused_lstm_bwd_stash(g, U, drop, cs, cs, dhs, dhT=dhT)
    with pytest.raises(ValueError, match="dhs must be"):
        tfl.fused_lstm_bwd(g, U, drop, cs, cs, dhs[:-1])
    with pytest.raises(ValueError, match="U must be"):
        tfl.fused_lstm_bwd(g, U.T, drop, cs, cs, dhs)
    with pytest.raises(RuntimeError, match="no autograd"):
        tfl.fused_lstm_fwd(g.requires_grad_(), U, drop)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["tanh", "relu"])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_bwd_kernels_match_plain_twins(cuda_device, bf16, seeded, act):
    """The stash forward and both BPTT kernels against their twins on the
    card, on the same tensors (qbits 16 on the recompute backward)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, c0, dhs, dhT, dcT = (torch.from_numpy(a).to(cuda_device)
                                         for a in _bwd_inputs(19))
    carry = (h0, c0) if seeded else (None, None)
    seeds = (dhT, dcT) if seeded else (None, None)
    atol = _atol(bf16)
    with torch.no_grad():
        before = tfl.fused_lstm_fwd.launches
        hs, cs, acts = tfl.fused_lstm_fwd(g, U, drop, *carry, act=act,
                                          qbits=16, bf16=bf16, stash=True)
        assert tfl.fused_lstm_fwd.launches == before + T
        ref = tfl.fused_lstm_fwd_plain(g, U, drop, *carry, act, 16, bf16,
                                       True)
        for a, b in zip((hs, cs, acts), ref):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       atol=atol)
        z = torch.zeros_like(h0)[None]
        h_prev = torch.cat([h0[None] if seeded else z, hs[:-1]])
        c_prev = torch.cat([c0[None] if seeded else z, cs[:-1]])
        extra = 1 if seeded else 0
        before = tfl.fused_lstm_bwd_stash.launches
        got = tfl.fused_lstm_bwd_stash(acts, U, drop, cs, c_prev, dhs, *seeds,
                                       act=act, bf16=bf16)
        assert tfl.fused_lstm_bwd_stash.launches == before + T + extra
        ref = tfl.fused_lstm_bwd_stash_plain(acts, U, drop.expand(B, H), cs,
                                             c_prev, dhs, *seeds, act=act,
                                             bf16=bf16)
        before = tfl.fused_lstm_bwd.launches
        got_r = tfl.fused_lstm_bwd(g, U, drop, h_prev, c_prev, dhs, *seeds,
                                   act=act, qbits=16, bf16=bf16)
        assert tfl.fused_lstm_bwd.launches == before + T + extra
        ref_r = tfl.fused_lstm_bwd_plain(g, U, drop, h_prev, c_prev, dhs,
                                         *seeds, act=act, qbits=16, bf16=bf16)
    torch.cuda.synchronize()
    for out, exp in ((got, ref), (got_r, ref_r)):
        out = out if seeded else (out,)
        exp = exp if seeded else (exp,)
        for a, b in zip(out, exp):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_function_grads_match_cpu(cuda_device, monkeypatch, stash):
    """The autograd Function on the card (kernels) against the same call
    on the CPU (twins)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    args = _bwd_inputs(23)
    got = _torch_grads(*args, True, 16, False, dev=cuda_device)
    ref = _torch_grads(*args, True, 16, False)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)
