"""Fused LSTM forward recurrence: the whole layer's time loop.

Port of ``pytorch_kaldi_cgs_tpu/ops/fused_lstm.py`` (forward only): the
TPU kernel ``_build_fwd`` becomes the CUDA kernel in
``csrc/fused_lstm_fwd.cu`` (one step kernel per time step, see its
header for the design and what bounds it on the H100), and
:func:`fused_lstm_fwd_plain` is its plain PyTorch twin with the same
casts and the same per-step quantizer.

:func:`fused_lstm_fwd` is the wrapper: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs the twin. Its attribute
``launches`` counts kernel launches (one per time step).

Per step t, gate order (f, i, o, c):

    u = q(h) @ U.T
    f, i, o = sigmoid(g_t + u)
    c = i * act(g_c + u_c) * drop + f * c
    h = o * act(c)
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from ..sparsity.quantize import bf16_round, quantize_input

ACTS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "htanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "linear": lambda x: x,
}
_ACT_CODE = {"tanh": 0, "relu": 1, "htanh": 2, "linear": 3}


def lstm_cell(g_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              U: torch.Tensor, drop: torch.Tensor, actf: Callable, qbits: int,
              bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: ``U`` is float32 (already bf16-rounded when ``bf16``);
    ``q(h)`` is the per-step quantizer, scale max|h| over (B, H)."""
    H = h.shape[-1]
    hin = quantize_input(h, qbits) if qbits > 0 else h
    if bf16:
        hin = bf16_round(hin)
    g = g_t + hin @ U.T
    f = torch.sigmoid(g[:, :H])
    i = torch.sigmoid(g[:, H:2 * H])
    o = torch.sigmoid(g[:, 2 * H:3 * H])
    c = i * actf(g[:, 3 * H:]) * drop + f * c
    return o * actf(c), c


def fused_lstm_fwd_plain(gates: torch.Tensor, U: torch.Tensor,
                         drop: torch.Tensor, h0: Optional[torch.Tensor],
                         c0: Optional[torch.Tensor], act: str, qbits: int,
                         bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin: a Python loop over t. -> (hs, cs)."""
    T, B, G4 = gates.shape
    H = G4 // 4
    Uc = bf16_round(U) if bf16 else U.to(torch.float32)
    z = gates.new_zeros((B, H))
    h = z if h0 is None else h0
    c = z if c0 is None else c0
    hs, cs = [], []
    for t in range(T):
        h, c = lstm_cell(gates[t], h, c, Uc, drop, ACTS[act], qbits, bf16)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def _kernel(gates, U, drop, h0, c0, act, qbits, bf16):
    from . import _build
    lib = _build.load("fused_lstm_fwd")
    fn = lib.fused_lstm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, G4 = gates.shape
    H = G4 // 4
    Uk = U.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    hs = torch.empty((T, B, H), dtype=torch.float32, device=gates.device)
    cs = torch.empty_like(hs)
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=gates.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream(gates.device).cuda_stream
        rc = fn(gates.data_ptr(), Uk.data_ptr(), drop.data_ptr(), ptr(h0),
                ptr(c0), hs.data_ptr(), cs.data_ptr(), qslots.data_ptr(),
                T, B, H, _ACT_CODE[act], qbits, int(bf16), stream)
    _build.check(lib, rc, "fused_lstm_fwd")
    fused_lstm_fwd.launches += T
    return hs, cs


def fused_lstm_fwd(gates: torch.Tensor, U: torch.Tensor,
                   drop: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None, act: str = "tanh",
                   qbits: int = 0, bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-layer LSTM forward. ``gates`` (T, B, 4H) float32, ``U``
    (4H, H), ``drop`` broadcastable to (B, H), optional seed carry
    ``h0``/``c0`` (B, H) float32 (both or neither). -> ``(hs, cs)``,
    each (T, B, H) float32.

    CUDA tensors run the kernel, CPU tensors the plain twin; the CUDA
    path has no backward yet and refuses inputs that need a gradient."""
    if act not in ACTS:
        raise ValueError("fused LSTM activation %r not in %s"
                         % (act, sorted(ACTS)))
    if gates.ndim != 3 or gates.shape[2] % 4:
        raise ValueError("gates must be (T, B, 4H), got %s"
                         % (tuple(gates.shape),))
    T, B, G4 = gates.shape
    H = G4 // 4
    if tuple(U.shape) != (G4, H):
        raise ValueError("U must be (%d, %d), got %s" % (G4, H,
                                                          tuple(U.shape)))
    if (h0 is None) != (c0 is None):
        raise ValueError("h0 and c0 go together")
    dev = gates.device
    for name, t in (("U", U), ("drop", drop), ("h0", h0), ("c0", c0)):
        if t is not None and t.device != dev:
            raise ValueError("%s on %s, gates on %s" % (name, t.device, dev))
    drop = torch.broadcast_to(drop.to(torch.float32), (B, H)).contiguous()
    for name, t in (("gates", gates), ("h0", h0), ("c0", c0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" % (name, t.dtype))
    if h0 is not None and (tuple(h0.shape) != (B, H)
                           or tuple(c0.shape) != (B, H)):
        raise ValueError("h0/c0 must be (%d, %d)" % (B, H))
    if dev.type == "cpu":
        return fused_lstm_fwd_plain(gates, U, drop, h0, c0, act, qbits, bf16)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (gates, U, h0, c0)):
        raise RuntimeError("the CUDA fused LSTM has a forward only: run it "
                           "under torch.no_grad() / inference_mode()")
    for name, t in (("gates", gates), ("h0", h0), ("c0", c0)):
        if t is not None and not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    return _kernel(gates, U, drop, h0, c0, act, qbits, bf16)


fused_lstm_fwd.launches = 0


def lstm_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                    drop_mask: torch.Tensor, act: str = "tanh",
                    quant_bits: int = 0, compute_dtype: str = ""
                    ) -> torch.Tensor:
    """hs (T, B, H) from zero initial state (the JAX package's
    ``lstm_scan_fused``, forward only)."""
    bf16 = compute_dtype in ("bf16", "bfloat16")
    return fused_lstm_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits,
                          bf16=bf16)[0]


def lstm_scan_fused_stream(gates_t: torch.Tensor, U: torch.Tensor,
                           drop_mask: torch.Tensor, h0: torch.Tensor,
                           c0: torch.Tensor, act: str = "tanh",
                           quant_bits: int = 0, compute_dtype: str = ""):
    """Seeded-carry variant for streaming: -> ``(hs, (h_T, c_T))``."""
    bf16 = compute_dtype in ("bf16", "bfloat16")
    hs, cs = fused_lstm_fwd(gates_t, U, drop_mask, h0, c0, act=act,
                            qbits=quant_bits, bf16=bf16)
    return hs, (hs[-1], cs[-1])
