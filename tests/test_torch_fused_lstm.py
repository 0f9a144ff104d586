"""The port's fused LSTM forward (pytorch_kaldi_cgs_tpu_torch/ops/
fused_lstm.py) against the JAX package's Pallas kernel run in interpret
mode, on the same numpy inputs, in every forward variant: float32/bf16
dots x zero/seeded carry x no/16-bit recurrent-input quantization x a
(B, H) dropout mask or the (1, 1) eval scalar.

Tolerances: float32 atol 1e-5 — the recurrent dot sums in another order
than XLA's, and 12 steps compound it (the JAX package's own fused-vs-scan
bar is 1e-6); bf16 atol 2e-2 — the JAX package's bf16 bar
(tests/test_fused_lstm.py), since one-ulp input differences can round h
to a neighbouring bf16 value.

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
