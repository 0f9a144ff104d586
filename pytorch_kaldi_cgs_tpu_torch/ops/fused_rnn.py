"""Fused liGRU recurrence: the whole layer's time loop, forward and BPTT.

Port of the liGRU part of ``pytorch_kaldi_cgs_tpu/ops/fused_rnn.py``.
Three TPU kernels become CUDA kernels for ``sm_90a`` in
``csrc/fused_ligru.cu``, each with a plain PyTorch twin that repeats its
arithmetic and is what the CPU runs:

- ``_build_ligru_fwd`` (``stash`` and the seeded ``with_init`` included):
  :func:`fused_ligru_fwd` / :func:`fused_ligru_fwd_plain`;
- ``_build_ligru_bwd_stash``: :func:`fused_ligru_bwd_stash` /
  :func:`fused_ligru_bwd_stash_plain`;
- ``_build_ligru_bwd``: :func:`fused_ligru_bwd` /
  :func:`fused_ligru_bwd_plain`.

A wrapper launches its kernel on a CUDA tensor (or raises) and runs its
twin on a CPU tensor; its attribute ``launches`` counts kernel launches
(one per time step).

:func:`ligru_scan_fused` (zero initial state) is the differentiable
entry point: a ``torch.autograd.Function`` whose forward runs the
forward kernel and whose backward runs one of the two BPTT kernels, then
``dU`` as ONE matmul over the unrolled (T*B) batch, as the JAX package's
custom VJP does. The backward is the recompute one unless
``PKC_BWD_STASH_CELLS`` lists ``ligru`` (the JAX package's knob and
default). :func:`ligru_scan_fused_stream` is the seeded forward for
streaming, not differentiable.

Per step t, gates ordered [h | z] (candidate first), U = [Uh; Uz]:

    u  = q(h) @ U.T
    a  = act(g_h + u_h),  z = sigmoid(g_z + u_z)
    h  = z * h + (1 - z) * a * drop

``q`` is the per-step recurrent-input quantizer (scale max|h| over the
step's (B, H) block) with a straight-through gradient. Everything is
float32: as in the JAX package, the fused liGRU has no bf16 variant.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..sparsity.quantize import (bf16_round, quantize_input,
                                 quantize_input_per_step, ste_quantize_input)
from .fused_lstm import (_ACT_CODE, ACTS, DACTS_OUT, _check_common,
                         _check_shapes, _needs_grad, _ptr, _stream,
                         bwd_stash_enabled, dact_pre, dense_u)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def ligru_cell(g_t: torch.Tensor, h: torch.Tensor, rec_u: Callable,
               drop: torch.Tensor, actf: Callable, qbits: int,
               bf16: bool = False):
    """One step: ``rec_u(q(h))`` gives the recurrent pre-activations
    (B, 2H), ``q`` the per-step quantizer with a straight-through
    gradient, ``q(h)`` rounded to bf16 first when ``bf16``. -> (h, the
    stash [act(a_h), z] as (B, 2H))."""
    H = h.shape[-1]
    hin = ste_quantize_input(h, qbits) if qbits > 0 else h
    if bf16:
        hin = bf16_round(hin)
    g = g_t + rec_u(hin)
    a = actf(g[:, :H])
    z = torch.sigmoid(g[:, H:])
    return z * h + (1.0 - z) * (a * drop), torch.cat([a, z], dim=1)


def fused_ligru_fwd_plain(gates: torch.Tensor, U: torch.Tensor,
                          drop: torch.Tensor, h0: Optional[torch.Tensor],
                          act: str, qbits: int, stash: bool = False):
    """The forward kernel's plain twin: a Python loop over t. -> hs
    (T, B, H), and ``(hs, acts)`` with the stash (T, B, 2H) when
    ``stash``."""
    T, B, G2 = gates.shape
    rec_u, actf = dense_u(U, False), ACTS[act]
    h = gates.new_zeros((B, G2 // 2)) if h0 is None else h0
    hs, acts = [], []
    for t in range(T):
        h, a = ligru_cell(gates[t], h, rec_u, drop, actf, qbits)
        hs.append(h)
        acts.append(a)
    return (torch.stack(hs), torch.stack(acts)) if stash else torch.stack(hs)


def _bwd_loop(step, U, dhs, like):
    """Reverse-time loop shared by the BPTT twins: ``step(t, dh)`` gives
    (dg_t, z_t); dh entering step t-1 is ``dh * z + dg_t @ U``."""
    T, B, H = dhs.shape
    Uf = U.to(torch.float32)
    dh_carry = like.new_zeros((B, H))
    dg = like.new_empty((T, B, 2 * H))
    for t in range(T - 1, -1, -1):
        dh = dh_carry + dhs[t]
        d, z = step(t, dh)
        dg[t] = d
        dh_carry = dh * z + d @ Uf
    return dg


def _dgates(dh, a, z, h_prev, drop, dact):
    """The elementwise cotangent chain of one step (JAX
    ``_build_ligru_bwd_stash`` :133-139 / ``_build_ligru_bwd``
    :187-195). ``h_prev`` is the unquantized carry. -> dg (B, 2H)."""
    hc = a * drop
    dz = dh * (h_prev - hc)
    daz = dz * z * (1.0 - z)
    dac = dh * (1.0 - z) * drop * dact
    return torch.cat([dac, daz], dim=1)


def fused_ligru_bwd_stash_plain(acts: torch.Tensor, U: torch.Tensor,
                                drop: torch.Tensor, h_prev: torch.Tensor,
                                dhs: torch.Tensor, act: str = "relu"
                                ) -> torch.Tensor:
    """Twin of the stash BPTT kernel: reverse loop over the forward's
    stash [act(a_h), z]; ``act'`` from the activation's output. ->
    dg (T, B, 2H)."""
    H = h_prev.shape[2]
    dactf = DACTS_OUT[act]

    def step(t, dh):
        a, z = acts[t, :, :H], acts[t, :, H:]
        return _dgates(dh, a, z, h_prev[t], drop, dactf(a)), z
    return _bwd_loop(step, U, dhs, acts)


def fused_ligru_bwd_plain(gates: torch.Tensor, U: torch.Tensor,
                          drop: torch.Tensor, h_prev: torch.Tensor,
                          dhs: torch.Tensor, act: str = "relu",
                          qbits: int = 0) -> torch.Tensor:
    """Twin of the recompute BPTT kernel: per step it rebuilds
    u = q(h_{t-1}) @ U.T and the gates, ``act'`` from the
    pre-activation. -> dg (T, B, 2H)."""
    H = h_prev.shape[2]
    rec_u, actf = dense_u(U, False), ACTS[act]

    def step(t, dh):
        hq = quantize_input(h_prev[t], qbits) if qbits > 0 else h_prev[t]
        g = gates[t] + rec_u(hq)
        ac = g[:, :H]
        z = torch.sigmoid(g[:, H:])
        return _dgates(dh, actf(ac), z, h_prev[t], drop, dact_pre(act, ac)), z
    return _bwd_loop(step, U, dhs, gates)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, lead, U, drop, act, others):
    """(T, B, 2H) float32 ``lead``, U (2H, H) float32, one device,
    contiguous float32 sequences. -> (T, B, H, drop as (B, H))."""
    return _check_common(name, lead, U, drop, act, (("U", U),) + others,
                         gates=2)


def fused_ligru_fwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, act: str = "relu",
                    qbits: int = 0, stash: bool = False):
    """Whole-layer liGRU forward (TPU kernel ``_build_ligru_fwd``):
    ``gates`` (T, B, 2H) float32 ordered [h | z], ``U`` (2H, H) float32
    stacked [Uh; Uz], ``drop`` broadcastable to (B, H), optional seed
    carry ``h0`` (B, H). -> hs (T, B, H) float32, and ``(hs, acts)``
    with the stash [act(a_h), z] (T, B, 2H) when ``stash``.

    CUDA tensors run the kernel, CPU tensors the plain twin. This is the
    raw kernel call, with no autograd: differentiable callers use
    :func:`ligru_scan_fused`."""
    T, B, H, drop = _check("gates", gates, U, drop, act, (("h0", h0),))
    _check_shapes((("h0", h0, (B, H)),))
    if _needs_grad(gates, U, h0):
        raise RuntimeError("fused_ligru_fwd has no autograd of its own: "
                           "call ligru_scan_fused")
    if gates.device.type == "cpu":
        return fused_ligru_fwd_plain(gates, U, drop, h0, act, qbits, stash)
    from . import _build
    lib = _build.load("fused_ligru")
    fn = lib.fused_ligru_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    acts = torch.empty_like(gates) if stash else None
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), qslots.data_ptr(), T, B, H,
                _ACT_CODE[act], qbits, _stream(dev))
    _build.check(lib, rc, "fused_ligru_fwd")
    fused_ligru_fwd.launches += T
    return (hs, acts) if stash else hs


fused_ligru_fwd.launches = 0


def _bwd(wrapper, lead, U, drop, h_prev, dhs, act, qbits, stash):
    T, B, H, drop = _check("acts" if stash else "gates", lead, U, drop, act,
                           (("h_prev", h_prev), ("dhs", dhs)))
    _check_shapes((("h_prev", h_prev, (T, B, H)), ("dhs", dhs, (T, B, H))))
    if lead.device.type == "cpu":
        if stash:
            return fused_ligru_bwd_stash_plain(lead, U, drop, h_prev, dhs, act)
        return fused_ligru_bwd_plain(lead, U, drop, h_prev, dhs, act, qbits)
    from . import _build
    lib = _build.load("fused_ligru")
    fn = lib.fused_ligru_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = lead.device
    Ut = U.t().contiguous()                  # (H, 2H): rows for dg @ U
    dg = torch.empty_like(lead)
    carry = torch.zeros((B, H), dtype=torch.float32, device=dev)
    qslots = torch.empty(T if (qbits > 0 and not stash) else 1,
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(lead.data_ptr(), U.data_ptr(), Ut.data_ptr(), drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), carry.data_ptr(),
                dg.data_ptr(), qslots.data_ptr(), T, B, H, _ACT_CODE[act],
                qbits, int(stash), _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += T
    return dg


def fused_ligru_bwd_stash(acts: torch.Tensor, U: torch.Tensor,
                          drop: torch.Tensor, h_prev: torch.Tensor,
                          dhs: torch.Tensor, act: str = "relu"
                          ) -> torch.Tensor:
    """BPTT over the stash (TPU kernel ``_build_ligru_bwd_stash``):
    ``acts`` (T, B, 2H) from the stash forward, ``h_prev`` (T, B, H) the
    carries entering each step, upstream ``dhs`` (T, B, H). -> dg
    (T, B, 2H). CUDA tensors run the kernel, CPU tensors the twin."""
    return _bwd(fused_ligru_bwd_stash, acts, U, drop, h_prev, dhs, act, 0,
                True)


fused_ligru_bwd_stash.launches = 0


def fused_ligru_bwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                    h_prev: torch.Tensor, dhs: torch.Tensor,
                    act: str = "relu", qbits: int = 0) -> torch.Tensor:
    """BPTT with recompute (TPU kernel ``_build_ligru_bwd``): ``gates``
    are the forward's inputs, ``h_prev`` (T, B, H) the carries entering
    each step, re-quantized per step for the recompute dot. -> as
    :func:`fused_ligru_bwd_stash`."""
    return _bwd(fused_ligru_bwd, gates, U, drop, h_prev, dhs, act, qbits,
                False)


fused_ligru_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedLiGRU(torch.autograd.Function):
    """The JAX package's ``ligru_scan_fused`` custom VJP over (gates, U):
    forward kernel (stash or not), BPTT kernel, then dU as one matmul
    over the (T*B) batch with h quantized per step."""

    @staticmethod
    def forward(ctx, gates, U, drop, act, qbits):
        stash = bwd_stash_enabled("ligru")
        out = fused_ligru_fwd(gates, U, drop, act=act, qbits=qbits,
                              stash=stash)
        hs, acts = out if stash else (out, None)
        ctx.meta = (act, qbits, stash)
        ctx.save_for_backward(None if stash else gates, U, drop, hs, acts)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        act, qbits, stash = ctx.meta
        gates, U, drop, hs, acts = ctx.saved_tensors
        T, B, H = hs.shape
        dhs = dhs.contiguous()
        h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
        if stash:
            dg = fused_ligru_bwd_stash(acts, U, drop, h_prev, dhs, act)
        else:
            dg = fused_ligru_bwd(gates, U, drop, h_prev, dhs, act, qbits)
        dU = None
        if ctx.needs_input_grad[1]:
            # one K=T*B product over the unrolled batch, h quantized per step
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dU = dg.reshape(T * B, 2 * H).T @ hq.reshape(T * B, H)
        return dg, dU, None, None, None


def ligru_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                     drop_mask: torch.Tensor, act: str = "relu",
                     quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from zero initial state, differentiable in
    ``gates_t`` (T, B, 2H) and ``U`` (2H, H) (``drop_mask`` is a
    constant). As in the JAX package it takes no compute dtype: the
    recurrence runs in float32."""
    gates_t, U = gates_t.to(torch.float32), U.to(torch.float32)
    if _needs_grad(gates_t, U):
        return _FusedLiGRU.apply(gates_t, U, drop_mask, act, quant_bits)
    return fused_ligru_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits)


def ligru_scan_fused_stream(gates_t: torch.Tensor, U: torch.Tensor,
                            drop_mask: torch.Tensor, h0: torch.Tensor,
                            act: str = "relu", quant_bits: int = 0):
    """Streaming (inference-only) liGRU forward seeded with the carry
    ``h0`` (B, H): -> ``(hs, hs[-1])``. Not differentiable."""
    with torch.no_grad():
        hs = fused_ligru_fwd(gates_t.to(torch.float32), U.to(torch.float32),
                             drop_mask, h0.to(torch.float32), act=act,
                             qbits=quant_bits)
    return hs, hs[-1]
