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
    route = tfl.lstm_fwd_route(B, H, bf16, cuda_device)[0]
    with torch.no_grad():
        before = tfl.fused_lstm_fwd.launches
        hs, cs = tfl.fused_lstm_fwd(g, U, drop, h0, c0, qbits=16, bf16=bf16)
        assert tfl.fused_lstm_fwd.launches == before + \
            tfl.lstm_fwd_launches(route, T)
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
    card, on the same tensors (qbits 16 on the recompute backward), each
    on the route its plan names (the forward and the stash BPTT
    persistent here, one launch a call)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g, U, drop, h0, c0, dhs, dhT, dcT = (torch.from_numpy(a).to(cuda_device)
                                         for a in _bwd_inputs(19))
    carry = (h0, c0) if seeded else (None, None)
    seeds = (dhT, dcT) if seeded else (None, None)
    atol = _atol(bf16)
    fwd_route = tfl.lstm_fwd_route(B, H, bf16, cuda_device)[0]
    bwd_route = tfl.lstm_bwd_stash_route(B, H, bf16, cuda_device)[0]
    with torch.no_grad():
        before = tfl.fused_lstm_fwd.launches
        hs, cs, acts = tfl.fused_lstm_fwd(g, U, drop, *carry, act=act,
                                          qbits=16, bf16=bf16, stash=True)
        assert tfl.fused_lstm_fwd.launches == before + \
            tfl.lstm_fwd_launches(fwd_route, T)
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
        assert tfl.fused_lstm_bwd_stash.launches == before + \
            tfl.lstm_bwd_stash_launches(bwd_route, T, seeded)
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


# ---------------------------------------------------------------------------
# the persistent routes of the forward (TPU row 1) and the stash BPTT
# (row 3): every instantiated block shape, both routes (skip without a card)
# ---------------------------------------------------------------------------

def _card_inputs(T_, B_, H_, seed, dev):
    """Forward and backward operands at (T_, B_, H_), U scaled by
    1/sqrt(H_) so that the gates stay in the sigmoid's range at any
    width."""
    rng = np.random.RandomState(seed)

    def d(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    return dict(g=d(rng.randn(T_, B_, 4 * H_) * 0.5),
                U=d(rng.randn(4 * H_, H_) / np.sqrt(H_)),
                drop=d(rng.rand(B_, H_) > 0.2), h0=d(rng.randn(B_, H_) * 0.3),
                c0=d(rng.randn(B_, H_) * 0.3),
                dhs=d(rng.randn(T_, B_, H_) * 0.1),
                dhT=d(rng.randn(B_, H_) * 0.1), dcT=d(rng.randn(B_, H_) * 0.1))


def _co_resident(plan, bwd, bf16, dev):
    """Whether a (forced) plan's grid is co-resident on the card, as the
    route asks (fused_rnn._route over the kernel's occupancy query)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
    lib, entry = (("fused_lstm_bwd", "lstm_bwd_stash_occupancy") if bwd
                  else ("fused_lstm_fwd", "lstm_fwd_occupancy"))
    return tfr._route(plan, lib, entry, (int(bf16), plan.bi, plan.units),
                      dev) == "persist"


def _fwd_variants():
    return [(bf16, seeded, qbits, act) for bf16 in (False, True)
            for seeded in (False, True) for qbits in (0, 16)
            for act in ("tanh", "relu")]


#: (T, B, H) of the bit-for-bit checks: the small ragged shape of
#: chip_smoke.py (B not a multiple of 8, H not of 4), rows not 16-byte
#: aligned at H=550, and a ragged last row group
BITS_TBH = ((13, 5, 18), (5, 8, 550), (6, 19, 45))


@pytest.mark.cuda
@pytest.mark.parametrize("tbh", BITS_TBH, ids=["13x5x18", "5x8x550",
                                               "6x19x45"])
def test_cuda_lstm_fwd_persist_gives_the_step_routes_bits(cuda_device, tbh):
    """Each dot of the persistent forward is one warp's, lanes over k and
    a shuffle reduction, as in lstm_step, and its staging gives quant()'s
    bits (then bf16's): at every instantiated block shape both routes
    give equal bits in f32 and bf16, zero and seeded, with and without
    the quantizer, tanh and relu, the stash included; one launch a
    call."""
    T_, B_, H_ = tbh
    x = _card_inputs(T_, B_, H_, 31 + H_, cuda_device)
    with torch.no_grad():
        for bf16, seeded, qbits, act in _fwd_variants():
            carry = (x["h0"], x["c0"]) if seeded else (None, None)
            want = tfl._fwd_kernel(x["g"], x["U"], x["drop"], *carry, act,
                                   qbits, bf16, True)
            for shape in tfl.LSTM_FWD_SHAPES:
                plan = tfl.lstm_fwd_plan(B_, H_, shape)
                assert _co_resident(plan, False, bf16, cuda_device)
                before = tfl.fused_lstm_fwd.launches
                got = tfl._fwd_persist(plan, x["g"], x["U"], x["drop"],
                                       *carry, act, qbits, bf16, True)
                assert tfl.fused_lstm_fwd.launches == before + 1
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (shape, bf16, seeded, qbits,
                                               act)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_lstm_fwd_routes(cuda_device, bf16):
    """The wrapper on the route its plan names (persistent at 11 rows of
    37 units) against the twin, and the step route forced, each with its
    route's launches; and 2x1024 at 16 rows, the plan's 8 x 16 blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for T_, B_, H_ in ((6, 11, 37), (4, 16, 1024)):
        x = _card_inputs(T_, B_, H_, 41 + B_, cuda_device)
        assert tfl.lstm_fwd_route(B_, H_, bf16, cuda_device)[0] == "persist"
        with torch.no_grad():
            for seeded, qbits in ((False, 0), (True, 16)):
                carry = (x["h0"], x["c0"]) if seeded else (None, None)
                ref = tfl.fused_lstm_fwd_plain(x["g"], x["U"], x["drop"],
                                               *carry, "tanh", qbits, bf16,
                                               True)
                for call, n in (
                        (lambda: tfl.fused_lstm_fwd(
                            x["g"], x["U"], x["drop"], *carry, qbits=qbits,
                            bf16=bf16, stash=True), 1),
                        (lambda: tfl._fwd_kernel(
                            x["g"], x["U"], x["drop"], *carry, "tanh", qbits,
                            bf16, True), T_)):
                    before = tfl.fused_lstm_fwd.launches
                    got = call()
                    assert tfl.fused_lstm_fwd.launches == before + n
                    for a, b in zip(got, ref):
                        np.testing.assert_allclose(
                            a.cpu().numpy(), b.cpu().numpy(),
                            atol=_atol(bf16) * (10 if qbits else 1),
                            err_msg="H=%d seeded=%s" % (H_, seeded))


def _bwd_case(x, seeded, act, bf16):
    """The stash forward's outputs and the stash BPTT's operands."""
    carry = (x["h0"], x["c0"]) if seeded else (None, None)
    hs, cs, acts = tfl.fused_lstm_fwd_plain(x["g"], x["U"], x["drop"],
                                            *carry, act, 0, bf16, True)
    z = torch.zeros_like(x["h0"])[None]
    c_prev = torch.cat([x["c0"][None] if seeded else z, cs[:-1]])
    seeds = (x["dhT"], x["dcT"]) if seeded else (None, None)
    return (acts, x["U"], x["drop"], cs, c_prev, x["dhs"]) + seeds


def _assert_bwd_close(got, ref, bf16, what):
    """Within the stash BPTT's bars: 1e-5 (f32) or 2e-2 (bf16) of each
    output's scale."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        scale = max(float(b.abs().max()), 1.0)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=_atol(bf16) * scale, err_msg=what)


#: (T, B, H) of the stash BPTT checks: the small ragged shape, the 4x550
#: width, and 2x1024 at 16 rows (the plan's 6 slabs of 704 a row)
BWD_TBH = ((13, 5, 18), (5, 8, 550), (4, 16, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("tbh", BWD_TBH, ids=["13x5x18", "5x8x550",
                                              "4x16x1024"])
def test_cuda_lstm_bwd_stash_persist_every_block_shape(cuda_device, tbh):
    """The persistent stash BPTT forced to each instantiated block shape
    (where its grid is co-resident) and so on the plan's own, seeded (dh0,
    dc0) and not, f32
    and bf16, tanh and relu: against the plain twin and the step route
    within the stash BPTT's bars; one launch a call. At 16 rows of 1024
    the plan stages dg_{t+1} in slabs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T_, B_, H_ = tbh
    x = _card_inputs(T_, B_, H_, 61 + H_, cuda_device)
    if H_ == 1024:
        assert tfl.lstm_bwd_stash_plan(B_, H_).slabs == 6
    with torch.no_grad():
        for bf16 in (False, True):
            plans = [tfl.lstm_bwd_stash_plan(B_, H_, s)
                     for s in tfl.LSTM_BWD_SHAPES]
            plans = [p for p in plans
                     if _co_resident(p, True, bf16, cuda_device)]
            assert tfl.lstm_bwd_stash_plan(B_, H_) in plans
            for seeded in (False, True):
                for act in ("tanh", "relu"):
                    args = _bwd_case(x, seeded, act, bf16)
                    ref = tfl.fused_lstm_bwd_stash_plain(*args, act=act,
                                                         bf16=bf16)
                    step = tfl._bwd_kernel(
                        tfl.fused_lstm_bwd_stash, args[0], args[1], args[2],
                        None, args[3], args[4], args[5], args[6], args[7],
                        act, 0, bf16, True)
                    what = "%s bf16=%s seeded=%s %s" % (tbh, bf16, seeded,
                                                        act)
                    _assert_bwd_close(step, ref, bf16, what + " step")
                    for plan in plans:
                        before = tfl.fused_lstm_bwd_stash.launches
                        got = tfl._bwd_stash_persist(plan, *args, act, bf16)
                        assert tfl.fused_lstm_bwd_stash.launches == before + 1
                        _assert_bwd_close(got, ref, bf16, what)
                        _assert_bwd_close(got, step, bf16, what + " vs step")


@pytest.mark.cuda
def test_cuda_lstm_bwd_stash_in_forced_slabs(cuda_device):
    """The chain with dg_{t+1} staged in forced slabs of 32 and 96 values
    (two buffers, the last slab short) at a ragged width gives the
    whole-row chain's results within the bars."""
    import math
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr
    T_, B_, H_ = 7, 11, 37
    x = _card_inputs(T_, B_, H_, 71, cuda_device)
    args = _bwd_case(x, True, "tanh", False)
    with torch.no_grad():
        whole = tfl.fused_lstm_bwd_stash(*args)
        for shape in tfl.LSTM_BWD_SHAPES:
            plan = tfl.lstm_bwd_stash_plan(B_, H_, shape)
            bt, K = 8 * plan.bi, 4 * H_
            for ks in (32, 96):
                forced = plan._replace(
                    slab=ks, slabs=math.ceil(K / ks),
                    smem=4 * K * tfr._w_stride(plan.units)
                    + 4 * 2 * bt * tfr._row_stride(ks)
                    + 4 * tfr.PERSIST_WARPS * bt * plan.units)
                got = tfl._bwd_stash_persist(forced, *args, "tanh", False)
                _assert_bwd_close(got, whole, False, "%s %d" % (shape, ks))
