"""Fused liGRU, GRU, minimalGRU and vanilla-RNN recurrences (dense and
block-sparse) and the torch-semantics GRU's: the whole layer's time
loop, forward and BPTT.

Port of the liGRU, GRU, minimalGRU, torch-GRU and RNN parts of
``pytorch_kaldi_cgs_tpu/ops/fused_rnn.py``. The GRU's and the
minimalGRU's (which share their code), the block-sparse liGRU's, the
RNN's (dense and block-sparse) and the torch-semantics GRU's (below,
after the dense liGRU's) have their own notes. Three liGRU TPU
kernels become CUDA kernels for ``sm_90a`` in ``csrc/fused_ligru.cu``,
each with a plain PyTorch twin that repeats its arithmetic and is what
the CPU runs:

- ``_build_ligru_fwd`` (``stash`` and the seeded ``with_init`` included):
  :func:`fused_ligru_fwd` / :func:`fused_ligru_fwd_plain`;
- ``_build_ligru_bwd_stash``: :func:`fused_ligru_bwd_stash` /
  :func:`fused_ligru_bwd_stash_plain`;
- ``_build_ligru_bwd``: :func:`fused_ligru_bwd` /
  :func:`fused_ligru_bwd_plain`.

A wrapper launches its kernel on a CUDA tensor (or raises) and runs its
twin on a CPU tensor; its attribute ``launches`` counts kernel launches
(one per time step, or a few a call on a persistent route: the recompute
BPTT's, below).

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

The forward and the recompute BPTT pick their routes before the launch
(:func:`ligru_fwd_route` over :func:`ligru_fwd_plan`,
:func:`ligru_bwd_route` over :func:`ligru_bwd_plan`): the forward's
"persist" runs every step in one cooperative launch (``csrc/persist.cuh``)
with the step kernel's bits; the BPTT's rebuilds every step's
pre-activations as one GEMM and runs the reverse chain as one cooperative
launch; "step", where the blocks do not fit or are not co-resident,
launches one kernel per step. The sparse GRU's forward and BPTT, the
dense GRU's and minimalGRU's forward, the minimalGRU's recompute BPTT,
the RNN's forward and recompute BPTT (dense and block-sparse) and the
torch-semantics GRU's BPTT route the same way (their notes below).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..sparsity.quantize import (bf16_round, quantize_input,
                                 quantize_input_per_step, ste_quantize_input)
from .fused_lstm import (_ACT_CODE, _SMEM_MAX, ACTS, DACTS_OUT,
                         _check_common, _check_shapes, _check_sparse,
                         _needs_grad, _ptr, _sparse_w, _stream,
                         bwd_stash_enabled, check_dense_width, dact_pre,
                         dense_u, sparse_dh, sparse_dU, sparse_recurrent_u,
                         sparse_scan_fits)


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


def _bwd_loop(step, dot, dhs, like):
    """Reverse-time loop shared by the liGRU's BPTT twins: ``step(t, dh)``
    gives (dg_t, z_t); dh entering step t-1 is ``dh * z + dot(dg_t)``, the
    product with U (dense, or over its kept blocks)."""
    T, B, H = dhs.shape
    dh_carry = like.new_zeros((B, H))
    dg = like.new_empty((T, B, 2 * H))
    for t in range(T - 1, -1, -1):
        dh = dh_carry + dhs[t]
        d, z = step(t, dh)
        dg[t] = d
        dh_carry = dh * z + dot(d)
    return dg


def _dense_dot(U):
    """``d -> d @ U`` in float32: the dense twins' carry product."""
    Uf = U.to(torch.float32)
    return lambda d: d @ Uf


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
    return _bwd_loop(step, _dense_dot(U), dhs, acts)


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
    return _bwd_loop(step, _dense_dot(U), dhs, gates)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, lead, U, drop, act, others, backward=None):
    """(T, B, 2H) float32 ``lead``, U (2H, H) float32, one device,
    contiguous float32 sequences; on the card a width the forward (and
    ``backward``) kernel takes. -> (T, B, H, drop as (B, H))."""
    out = _check_common(name, lead, U, drop, act, (("U", U),) + others,
                        gates=2)
    check_dense_width("ligru", out[2], backward, lead.device)
    return out


def fused_ligru_fwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, act: str = "relu",
                    qbits: int = 0, stash: bool = False):
    """Whole-layer liGRU forward (TPU kernel ``_build_ligru_fwd``):
    ``gates`` (T, B, 2H) float32 ordered [h | z], ``U`` (2H, H) float32
    stacked [Uh; Uz], ``drop`` broadcastable to (B, H), optional seed
    carry ``h0`` (B, H). -> hs (T, B, H) float32, and ``(hs, acts)``
    with the stash [act(a_h), z] (T, B, 2H) when ``stash``.

    CUDA tensors run the kernels on the route :func:`ligru_fwd_route`
    picks before the launch: "persist" (all steps in one cooperative
    launch, seeded or not) where the blocks fit and are co-resident, else
    "step" (a launch per step); both give the same bits. CPU tensors run
    the plain twin. This is the raw kernel call, with no autograd:
    differentiable callers use :func:`ligru_scan_fused`."""
    T, B, H, drop = _check("gates", gates, U, drop, act, (("h0", h0),))
    _check_shapes((("h0", h0, (B, H)),))
    if _needs_grad(gates, U, h0):
        raise RuntimeError("fused_ligru_fwd has no autograd of its own: "
                           "call ligru_scan_fused")
    if gates.device.type == "cpu":
        return fused_ligru_fwd_plain(gates, U, drop, h0, act, qbits, stash)
    route, plan = ligru_fwd_route(B, H, gates.device)
    if route == "persist":
        return _ligru_fwd_persist(plan, gates, U, drop, h0, act, qbits, stash)
    return _ligru_fwd_step(gates, U, drop, h0, act, qbits, stash)


def _ligru_fwd_step(gates, U, drop, h0, act, qbits, stash):
    """The forward on the step route: a kernel a step, after the
    reduction of max|h0| with a seed and the quantizer; ``launches``
    counts the step kernels."""
    T, B, G2 = gates.shape
    H = G2 // 2
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
    fused_ligru_fwd.launches += ligru_fwd_launches("step", T)
    return (hs, acts) if stash else hs


def _ligru_fwd_persist(plan, gates, U, drop, h0, act, qbits, stash):
    """The forward on the persistent route (``plan``: its PersistPlan,
    :func:`ligru_fwd_plan`): all T steps in one cooperative launch, h_t
    exchanged through two (B, HP) buffers picked by the step's parity
    (rows padded to a multiple of 4 floats for the 16-byte copies)."""
    from . import block_sparse as BS
    T, B, G2 = gates.shape
    H, dev = G2 // 2, gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((T, B, H), **f32)
    acts = torch.empty_like(gates) if stash else None
    xh = torch.empty((2, B, gru_fwd_exchange_stride(H)), **f32)
    # each block's max|h| of the last two steps, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    BS._launch("fused_ligru", "ligru_fwd_persist_run", dev,
               (gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), xh.data_ptr(), bmax.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, plan.grid, plan.bi,
                plan.units, plan.smem))
    fused_ligru_fwd.launches += ligru_fwd_launches("persist", T)
    return (hs, acts) if stash else hs


fused_ligru_fwd.launches = 0


def _bwd(wrapper, lead, U, drop, h_prev, dhs, act, qbits, stash):
    T, B, H, drop = _check("acts" if stash else "gates", lead, U, drop, act,
                           (("h_prev", h_prev), ("dhs", dhs)),
                           "stash" if stash else "recompute")
    _check_shapes((("h_prev", h_prev, (T, B, H)), ("dhs", dhs, (T, B, H))))
    if lead.device.type == "cpu":
        if stash:
            return fused_ligru_bwd_stash_plain(lead, U, drop, h_prev, dhs, act)
        return fused_ligru_bwd_plain(lead, U, drop, h_prev, dhs, act, qbits)
    dev = lead.device
    if not stash:
        route, plan = ligru_bwd_route(B, H, dev)
        if route == "persist":
            return _ligru_bwd_persist(plan, lead, U, drop, h_prev, dhs, act,
                                      qbits)
    from . import _build
    lib = _build.load("fused_ligru")
    fn = lib.fused_ligru_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
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


def _ligru_bwd_persist(plan, gates, U, drop, h_prev, dhs, act, qbits):
    """The recompute BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`ligru_bwd_plan`): with qbits > 0 the per-step
    scales and q(h_prev), then pre = gates + q(h_prev) @ U^T as one GEMM
    (the pre-activations of every step), then the chain in one cooperative
    launch. -> dg (T, B, 2H)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    Ut = U.t().contiguous()                  # (H, 2H): the GEMM's B
    q = qbits > 0
    qh = torch.empty((T, B, H), **f32) if q else None
    pre = torch.empty_like(gates)
    xbuf = torch.empty((2, B, -(-2 * H // 8) * 8), **f32)
    dg = torch.empty_like(gates)
    qslots = torch.empty(T if q else 1, dtype=torch.int32, device=dev)
    BS._launch("fused_ligru", "ligru_bwd_persist_run", dev,
               (gates.data_ptr(), U.data_ptr(), Ut.data_ptr(),
                drop.data_ptr(), h_prev.data_ptr(), dhs.data_ptr(), _ptr(qh),
                pre.data_ptr(), xbuf.data_ptr(), dg.data_ptr(),
                qslots.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, plan.grid, plan.bi,
                plan.units, plan.slab, plan.smem))
    fused_ligru_bwd.launches += ligru_bwd_launches("persist", T, qbits)
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
    :func:`fused_ligru_bwd_stash`. CUDA tensors run the kernels on the
    route :func:`ligru_bwd_route` picks before the launch: "persist" (the
    pre-activations of all steps rebuilt as one GEMM, then the reverse
    chain in one cooperative launch: :func:`ligru_bwd_launches`) where the
    chain's blocks fit and are co-resident, else "step" (a launch per
    reverse step); CPU tensors the twin."""
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


# ---------------------------------------------------------------------------
# the GRU and the minimalGRU, dense and block-sparse. Per step t, gates
# ordered [h | z | r] (candidate first), U stacked [Uh; Uz; Ur]:
#
#     z, r = sigmoid(g_zr + q(h) @ [Uz; Ur].T)
#     s    = r * h
#     a    = act(g_h + q(s) @ Uh.T)
#     h    = z * h + (1 - z) * a * drop
#
# The minimalGRU (the Minimal Gated Unit, the reference's
# neural_networks.py:1602-1777) is the same step with two gates [h | z],
# U = [Uh; Uz] and z in the reset gate's place: s = z * h.
# ``q`` is the per-step input quantizer (its scale max|v| over the step's
# (B, H) block) with a straight-through gradient. Each step has two
# grid-wide dependencies (s needs r or z of every unit, q(s) needs
# max|s|): the forward runs all steps in one cooperative launch with a
# grid barrier after each (:func:`gru_fwd_route`), or, where its blocks do
# not fit or are not co-resident, two launches per step. In reverse, from
# dh_carry = 0 at t = T-1 (the minimalGRU's recompute BPTT as one
# cooperative chain after a rebuild of all steps at once,
# :func:`mgru_bwd_route`; the others two launches a step):
#
#     dh   = dh_carry + dhs[t]
#     dg_h = dh * (1 - z) * drop * act'
#     ds   = dg_h @ Uh
#     GRU:        dg_z = dh * (h_{t-1} - a * drop) * z (1 - z)
#                 dg_r = ds * h_{t-1} * r (1 - r)
#                 dh_carry = dh * z + ds * r + [dg_z | dg_r] @ [Uz; Ur]
#     minimalGRU: dg_z = (dh * (h_{t-1} - a * drop) + ds * h_{t-1}) z (1 - z)
#                 dh_carry = dh * z + ds * z + dg_z @ Uz
#
# dU is two products over the unrolled (T*B) batch: Uh's rows from q(s),
# the others' from q(h_{t-1}). The plain twins, the wrappers' bodies and
# the autograd rules serve both cells, which they tell apart by the gate
# count; the CUDA kernels are one template over it.
# ---------------------------------------------------------------------------

def gru_cell(g_t: torch.Tensor, h: torch.Tensor, rec_zr: Callable,
             rec_h: Callable, drop: torch.Tensor, actf: Callable, qbits: int,
             bf16: bool = False):
    """One GRU step (the JAX package's GRU scan step): ``rec_zr(q(h))``
    gives the z and r pre-activations (B, 2H), ``rec_h(q(r * h))`` the
    candidate's (B, H); ``q`` the per-step quantizer with a
    straight-through gradient, its output rounded to bf16 when ``bf16``.
    -> (h, the stash [act(a_h), z, r] as (B, 3H)). Given gates [h | z]
    and a ``rec_zr`` that gives z's pre-activations alone (B, H), it is
    the minimalGRU's step (:data:`mgru_cell`): s = z * h, the stash
    [act(a_h), z]."""
    H = h.shape[-1]
    hin = ste_quantize_input(h, qbits) if qbits > 0 else h
    if bf16:
        hin = bf16_round(hin)
    zr = torch.sigmoid(g_t[:, H:] + rec_zr(hin))
    s = zr[:, -H:] * h            # r * h, the minimalGRU's z * h
    sin = ste_quantize_input(s, qbits) if qbits > 0 else s
    if bf16:
        sin = bf16_round(sin)
    a = actf(g_t[:, :H] + rec_h(sin))
    z = zr[:, :H]
    return z * h + (1.0 - z) * (a * drop), torch.cat([a, zr], dim=1)


def _gru_bwd_loop(step, h_prev, dhs, drop, dot_h, dot_zr, like):
    """Reverse-time loop shared by the GRU's and the minimalGRU's BPTT
    twins: ``step(t)`` gives step t's (act(a_h), [z | r] or z, act'),
    ``dot_h(dg_h)`` is ds and ``dot_zr`` the carry's product (JAX
    ``_build_gru_bwd_stash`` :411-425, ``_build_mgru_bwd_stash``
    :871-881). -> dg shaped like ``like`` (T, B, G*H)."""
    T, B, H = h_prev.shape
    dg = like.new_empty(like.shape)
    dh_carry = like.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        hp = h_prev[t]
        a, zr, dact = step(t)
        z, r = zr[:, :H], zr[:, -H:]          # the minimalGRU's r is z
        dh = dh_carry + dhs[t]
        dz = dh * (hp - a * drop)
        dah = dh * (1.0 - z) * drop * dact
        ds = dot_h(dah)
        if zr.shape[1] == H:      # minimalGRU: z also gates s = z * h
            dzr = (dz + ds * hp) * z * (1.0 - z)
        else:
            dzr = torch.cat([dz * z * (1.0 - z), ds * hp * r * (1.0 - r)],
                            dim=1)
        dh_carry = dh * z + ds * r + dot_zr(dzr)
        dg[t] = torch.cat([dah, dzr], dim=1)
    return dg


def _gru_recompute_step(gates, h_prev, rec_zr, rec_h, act, qbits, bf16,
                        s_seq=None):
    """``step`` of :func:`_gru_bwd_loop` rebuilding z (and r), s and the
    candidate from ``h_prev`` (q per step, bf16-rounded dot inputs when
    ``bf16``; act' from the pre-activation); s into ``s_seq`` when
    given."""
    H = h_prev.shape[2]
    actf = ACTS[act]

    def dot_in(v):
        v = quantize_input(v, qbits) if qbits > 0 else v
        return bf16_round(v) if bf16 else v

    def step(t):
        hp, g = h_prev[t], gates[t]
        zr = torch.sigmoid(g[:, H:] + rec_zr(dot_in(hp)))
        s = zr[:, -H:] * hp
        if s_seq is not None:
            s_seq[t] = s
        a_pre = g[:, :H] + rec_h(dot_in(s))
        return actf(a_pre), zr, dact_pre(act, a_pre)
    return step


# -- the dense GRU and minimalGRU: TPU kernels _build_gru_fwd,
# _build_gru_bwd_stash, _build_gru_bwd and _build_mgru_fwd,
# _build_mgru_bwd_stash, _build_mgru_bwd become csrc/fused_gru.cu.
# Everything is float32 (the JAX package casts U to float32 for them
# whatever the compute dtype).

def _gru_dense_fns(U):
    """(rec_zr, rec_h, dot_h, dot_zr) of the dense twins over U (G*H, H)."""
    H = U.shape[1]
    Uf = U.to(torch.float32)
    Uh, Uzr = Uf[:H], Uf[H:]
    return (lambda x: x @ Uzr.T, lambda x: x @ Uh.T, lambda d: d @ Uh,
            lambda d: d @ Uzr)


def fused_gru_fwd_plain(gates: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, h0: Optional[torch.Tensor],
                        act: str, qbits: int, stash: bool = False):
    """The forward kernel's plain twin: a Python loop over
    :func:`gru_cell`. -> hs (T, B, H), and ``(hs, acts)`` with the stash
    [act(a_h), z, r] (T, B, 3H) when ``stash``. Over gates [h | z] and
    U (2H, H) it is the minimalGRU's (stash [act(a_h), z])."""
    T, B, _ = gates.shape
    rec_zr, rec_h, _, _ = _gru_dense_fns(U)
    h = gates.new_zeros((B, U.shape[1])) if h0 is None else h0
    hs, acts = [], []
    for t in range(T):
        h, a = gru_cell(gates[t], h, rec_zr, rec_h, drop, ACTS[act], qbits)
        hs.append(h)
        acts.append(a)
    return (torch.stack(hs), torch.stack(acts)) if stash else torch.stack(hs)


def fused_gru_bwd_stash_plain(acts: torch.Tensor, U: torch.Tensor,
                              drop: torch.Tensor, h_prev: torch.Tensor,
                              dhs: torch.Tensor, act: str = "tanh"
                              ) -> torch.Tensor:
    """Twin of the stash BPTT kernel: reverse loop over the forward's
    stash [act(a_h), z, r] (the minimalGRU's [act(a_h), z]); act' from
    the activation's output. -> dg shaped like ``acts``."""
    H = h_prev.shape[2]
    _, _, dot_h, dot_zr = _gru_dense_fns(U)
    dactf = DACTS_OUT[act]

    def step(t):
        a = acts[t, :, :H]
        return a, acts[t, :, H:], dactf(a)
    return _gru_bwd_loop(step, h_prev, dhs, drop, dot_h, dot_zr, acts)


def fused_gru_bwd_plain(gates: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, h_prev: torch.Tensor,
                        dhs: torch.Tensor, act: str = "tanh", qbits: int = 0
                        ) -> torch.Tensor:
    """Twin of the recompute BPTT kernel: per reverse step it rebuilds z
    (and r), s and the candidate from ``h_prev`` (q per step), act' from
    the pre-activation. -> dg shaped like ``gates``."""
    rec_zr, rec_h, dot_h, dot_zr = _gru_dense_fns(U)
    step = _gru_recompute_step(gates, h_prev, rec_zr, rec_h, act, qbits,
                               False)
    return _gru_bwd_loop(step, h_prev, dhs, drop, dot_h, dot_zr, gates)


#: The minimalGRU's step and dense plain twins: the GRU's over gates
#: [h | z] and U = [Uh; Uz] (the twins of the TPU kernels
#: ``_build_mgru_fwd``, ``_build_mgru_bwd_stash`` and ``_build_mgru_bwd``).
mgru_cell = gru_cell
fused_mgru_fwd_plain = fused_gru_fwd_plain
fused_mgru_bwd_stash_plain = fused_gru_bwd_stash_plain
fused_mgru_bwd_plain = fused_gru_bwd_plain


def _gru_check(name, lead, U, drop, act, others, G, backward=None):
    """(T, B, G*H) float32 ``lead``, U (G*H, H) float32, one device,
    contiguous float32 sequences; on the card a width the forward (and
    ``backward``) kernels take. -> (T, B, H, drop as (B, H))."""
    out = _check_common(name, lead, U, drop, act, (("U", U),) + others,
                        gates=G)
    check_dense_width("gru" if G == 3 else "mgru", out[2], backward,
                      lead.device)
    return out


def _gru_fwd(wrapper, G, scan, gates, U, drop, h0, act, qbits, stash):
    """The body of :func:`fused_gru_fwd` (G=3) and :func:`fused_mgru_fwd`
    (G=2): ``wrapper`` the public function (its name the step route's C
    entry point), ``scan`` the differentiable caller. On the card the
    route is picked before the launch (:func:`gru_fwd_route`)."""
    T, B, H, drop = _gru_check("gates", gates, U, drop, act, (("h0", h0),),
                               G)
    _check_shapes((("h0", h0, (B, H)),))
    if _needs_grad(gates, U, h0):
        raise RuntimeError("%s has no autograd of its own: call %s"
                           % (wrapper.__name__, scan))
    if gates.device.type == "cpu":
        return fused_gru_fwd_plain(gates, U, drop, h0, act, qbits, stash)
    route, plan = gru_fwd_route(B, H, G, gates.device)
    if route == "persist":
        return _gru_fwd_persist(wrapper, plan, gates, U, drop, h0, act,
                                qbits, stash)
    return _gru_fwd_step(wrapper, gates, U, drop, h0, act, qbits, stash)


def _gru_fwd_step(wrapper, gates, U, drop, h0, act, qbits, stash):
    """The dense forward on the step route: two kernels a step (and the
    reduction of max|h0| first with a seed and the quantizer)."""
    T, B, GH = gates.shape
    H = U.shape[1]
    from . import _build
    lib = _build.load("fused_gru")
    fn = getattr(lib, wrapper.__name__)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((T, B, H), **f32)
    acts = torch.empty_like(gates) if stash else None
    fw = None if stash else torch.empty((B, GH), **f32)
    s = torch.empty((B, H), **f32)
    qslots = torch.empty(2 * T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), _ptr(fw), s.data_ptr(),
                qslots.data_ptr(), T, B, H, _ACT_CODE[act], qbits,
                _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += gru_fwd_launches("step", T, h0 is not None, qbits)
    return (hs, acts) if stash else hs


def _gru_fwd_persist(wrapper, plan, gates, U, drop, h0, act, qbits, stash):
    """The dense forward on the persistent route (``plan``: its
    PersistPlan, :func:`gru_fwd_plan`): all T steps in one cooperative
    launch, h_t and s exchanged through two (B, HP) buffers (rows padded
    to a multiple of 4 floats for the 16-byte copies)."""
    from . import block_sparse as BS
    T, B, GH = gates.shape
    H, dev = U.shape[1], gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((T, B, H), **f32)
    acts = torch.empty_like(gates) if stash else None
    xch = torch.empty((2, B, gru_fwd_exchange_stride(H)), **f32)
    # each block's max|h| and max|s| of the step, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    BS._launch("fused_gru", "gru_fwd_dense_persist", dev,
               (gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), xch[0].data_ptr(),
                xch[1].data_ptr(), bmax.data_ptr()),
               (GH // H, T, B, H, _ACT_CODE[act], qbits, plan.grid, plan.bi,
                plan.units, plan.smem))
    wrapper.launches += gru_fwd_launches("persist", T, h0 is not None,
                                         qbits)
    return (hs, acts) if stash else hs


def fused_gru_fwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, act: str = "tanh",
                  qbits: int = 0, stash: bool = False):
    """Whole-layer GRU forward (TPU kernel ``_build_gru_fwd``): ``gates``
    (T, B, 3H) float32 ordered [h | z | r], ``U`` (3H, H) float32 stacked
    [Uh; Uz; Ur], ``drop`` broadcastable to (B, H), optional seed carry
    ``h0`` (B, H). -> hs (T, B, H) float32, and ``(hs, acts)`` with the
    stash [act(a_h), z, r] (T, B, 3H) when ``stash``.

    CUDA tensors run the kernels on the route :func:`gru_fwd_route` picks
    before the launch: "persist" (all steps in one cooperative launch)
    where the blocks fit and are co-resident, else "step" (two launches
    per step); CPU tensors the plain twin. This is the raw kernel call,
    with no autograd: differentiable callers use :func:`gru_scan_fused`."""
    return _gru_fwd(fused_gru_fwd, 3, "gru_scan_fused", gates, U, drop, h0,
                    act, qbits, stash)


fused_gru_fwd.launches = 0


def fused_mgru_fwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, act: str = "tanh",
                   qbits: int = 0, stash: bool = False):
    """Whole-layer minimalGRU forward (TPU kernel ``_build_mgru_fwd``):
    ``gates`` (T, B, 2H) float32 ordered [h | z], ``U`` (2H, H) float32
    stacked [Uh; Uz], ``drop`` broadcastable to (B, H), optional seed
    carry ``h0`` (B, H). -> hs (T, B, H) float32, and ``(hs, acts)`` with
    the stash [act(a_h), z] (T, B, 2H) when ``stash``. CUDA tensors run
    the kernels on the route :func:`gru_fwd_route` picks (as
    :func:`fused_gru_fwd`), CPU tensors the plain twin; no autograd
    (:func:`mgru_scan_fused`)."""
    return _gru_fwd(fused_mgru_fwd, 2, "mgru_scan_fused", gates, U, drop, h0,
                    act, qbits, stash)


fused_mgru_fwd.launches = 0


def _gru_bwd(wrapper, cname, G, lead, U, drop, h_prev, dhs, act, qbits,
             stash):
    """The body of the dense BPTT wrappers: the C entry point ``cname``
    (``fused_gru_bwd`` or ``fused_mgru_bwd``) over G gates."""
    T, B, H, drop = _gru_check("acts" if stash else "gates", lead, U, drop,
                               act, (("h_prev", h_prev), ("dhs", dhs)), G,
                               "stash" if stash else "recompute")
    _check_shapes((("h_prev", h_prev, (T, B, H)), ("dhs", dhs, (T, B, H))))
    if lead.device.type == "cpu":
        if stash:
            return fused_gru_bwd_stash_plain(lead, U, drop, h_prev, dhs, act)
        return fused_gru_bwd_plain(lead, U, drop, h_prev, dhs, act, qbits)
    if G == 2 and not stash:
        route, plan = mgru_bwd_route(B, H, lead.device)
        if route == "persist":
            return _mgru_bwd_persist(plan, lead, U, drop, h_prev, dhs, act,
                                     qbits)
    if G == 3 and stash:
        route, plan = gru_bwd_stash_route(B, H, lead.device)
        if route == "persist":
            return _gru_bwd_stash_persist(plan, lead, U, drop, h_prev, dhs,
                                          act)
    return _gru_bwd_step(wrapper, cname, G, lead, U, drop, h_prev, dhs, act,
                         qbits, stash)


def _gru_bwd_step(wrapper, cname, G, lead, U, drop, h_prev, dhs, act, qbits,
                  stash):
    """The dense BPTT on the step route: with recompute the two rebuild
    kernels over all T (after the per-step scales with the quantizer),
    then two kernels a reverse step; ``launches`` counts the rebuild
    kernels and the chain's."""
    T, B, H = h_prev.shape
    from . import _build
    lib = _build.load("fused_gru")
    fn = getattr(lib, cname)
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = lead.device
    f32 = dict(dtype=torch.float32, device=dev)
    Ut = U.t().contiguous()                  # (H, G*H): rows for dg @ U
    fw = None if stash else torch.empty((T, B, G * H), **f32)
    s_seq = None if stash else torch.empty((T, B, H), **f32)
    dh, ds = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    dg = torch.empty_like(lead)
    qslots = torch.empty(2 * T if (qbits > 0 and not stash) else 1,
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(lead.data_ptr(), U.data_ptr(), Ut.data_ptr(), drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), _ptr(fw), _ptr(s_seq),
                dh.data_ptr(), ds.data_ptr(), dg.data_ptr(),
                qslots.data_ptr(), T, B, H, _ACT_CODE[act], qbits, int(stash),
                _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 2 * T + (0 if stash else 2)
    return dg


def _mgru_bwd_persist(plan, gates, U, drop, h_prev, dhs, act, qbits):
    """The minimalGRU recompute BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`mgru_bwd_plan`): the forward quantities of all
    M = T*B rows (with qbits > 0 the per-step scales and q(h_prev); z's
    pre-activations as one product, z, s and the scales of q(s) in one
    pass, q(s); a_pre as one product; each dot in the forward's order, so
    they are the forward's bits), then the chain in one cooperative
    launch, dg_h and dg_z exchanged through buffers of rows padded to a
    multiple of 4 floats. -> dg (T, B, 2H)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    q = qbits > 0
    qh = torch.empty((T, B, H), **f32) if q else None
    qs = torch.empty((T, B, H), **f32) if q else None
    fw = torch.empty_like(gates)             # [a_pre | z] of every step
    s_seq = torch.empty((T, B, H), **f32)
    # dg_h's exchange buffer, then dg_z's two (by the step's parity)
    xch = torch.empty((3, B, gru_fwd_exchange_stride(H)), **f32)
    dg = torch.empty_like(gates)
    qslots = torch.empty(2 * T if q else 1, dtype=torch.int32, device=dev)
    BS._launch("fused_gru", "mgru_bwd_persist_run", dev,
               (gates.data_ptr(), U.data_ptr(), drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), _ptr(qh), fw.data_ptr(),
                s_seq.data_ptr(), _ptr(qs), xch[0].data_ptr(),
                xch[1].data_ptr(), dg.data_ptr(), qslots.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, mgru_rebuild_rows(H),
                plan.grid, plan.bi, plan.units, plan.smem))
    fused_mgru_bwd.launches += mgru_bwd_launches("persist", T, qbits)
    return dg


def _gru_bwd_stash_persist(plan, acts, U, drop, h_prev, dhs, act):
    """The GRU stash BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`gru_bwd_stash_plan`): the reverse chain over the
    stash in one cooperative launch, dg_h and [dg_z | dg_r] exchanged
    through buffers of rows padded to a multiple of 4 floats (the latter
    two, by the step's parity). -> dg (T, B, 3H)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    dev = acts.device
    f32 = dict(dtype=torch.float32, device=dev)
    xh = torch.empty((B, gru_fwd_exchange_stride(H)), **f32)
    xzr = torch.empty((2, B, gru_fwd_exchange_stride(2 * H)), **f32)
    dg = torch.empty_like(acts)
    BS._launch("fused_gru", "gru_bwd_stash_persist_run", dev,
               (acts.data_ptr(), U.data_ptr(), drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), xh.data_ptr(),
                xzr.data_ptr(), dg.data_ptr()),
               (T, B, H, _ACT_CODE[act], plan.grid, plan.bi, plan.units,
                plan.smem))
    fused_gru_bwd_stash.launches += gru_bwd_stash_launches("persist", T)
    return dg


def fused_gru_bwd_stash(acts: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, h_prev: torch.Tensor,
                        dhs: torch.Tensor, act: str = "tanh") -> torch.Tensor:
    """BPTT over the stash (TPU kernel ``_build_gru_bwd_stash``, the
    default backward): ``acts`` (T, B, 3H) from the stash forward,
    ``h_prev`` (T, B, H) the carries entering each step, upstream ``dhs``
    (T, B, H). -> dg (T, B, 3H). CUDA tensors run the kernels on the route
    :func:`gru_bwd_stash_route` picks before the launch: "persist" (the
    reverse chain in one cooperative launch) where its blocks fit and are
    co-resident, else "step" (two launches per reverse step); CPU tensors
    the twin."""
    return _gru_bwd(fused_gru_bwd_stash, "fused_gru_bwd", 3, acts, U, drop,
                    h_prev, dhs, act, 0, True)


fused_gru_bwd_stash.launches = 0


def fused_gru_bwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                  h_prev: torch.Tensor, dhs: torch.Tensor, act: str = "tanh",
                  qbits: int = 0) -> torch.Tensor:
    """BPTT with recompute (TPU kernel ``_build_gru_bwd``, under
    ``PKC_LSTM_BWD_RECOMPUTE=1``): ``gates`` are the forward's inputs,
    ``h_prev`` (T, B, H) the carries entering each step, re-quantized per
    step. -> as :func:`fused_gru_bwd_stash`. On the card two launches
    rebuild the forward's quantities for all steps, then two run per
    reverse step."""
    return _gru_bwd(fused_gru_bwd, "fused_gru_bwd", 3, gates, U, drop, h_prev,
                    dhs, act, qbits, False)


fused_gru_bwd.launches = 0


def fused_mgru_bwd_stash(acts: torch.Tensor, U: torch.Tensor,
                         drop: torch.Tensor, h_prev: torch.Tensor,
                         dhs: torch.Tensor, act: str = "tanh"
                         ) -> torch.Tensor:
    """minimalGRU BPTT over the stash (TPU kernel
    ``_build_mgru_bwd_stash``, under ``PKC_BWD_STASH_CELLS=mgru``):
    ``acts`` (T, B, 2H) [act(a_h), z] from the stash forward, ``h_prev``
    and ``dhs`` (T, B, H). -> dg (T, B, 2H). CUDA tensors run the kernel
    (two launches per reverse step), CPU tensors the twin."""
    return _gru_bwd(fused_mgru_bwd_stash, "fused_mgru_bwd", 2, acts, U, drop,
                    h_prev, dhs, act, 0, True)


fused_mgru_bwd_stash.launches = 0


def fused_mgru_bwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                   h_prev: torch.Tensor, dhs: torch.Tensor, act: str = "tanh",
                   qbits: int = 0) -> torch.Tensor:
    """minimalGRU BPTT with recompute (TPU kernel ``_build_mgru_bwd``, the
    default backward): ``gates`` (T, B, 2H) are the forward's inputs,
    ``h_prev`` (T, B, H) the carries entering each step, re-quantized per
    step. -> dg (T, B, 2H). CUDA tensors run the kernels on the route
    :func:`mgru_bwd_route` picks before the launch: "persist" (the forward
    quantities of all steps as two products over the unrolled batch
    around elementwise passes, the forward's bits, then the reverse chain
    in one cooperative launch:
    :func:`mgru_bwd_launches`) where the chain's blocks fit and are
    co-resident, else "step" (two launches rebuild the forward's
    quantities for all steps, then two run per reverse step); CPU tensors
    the twin."""
    return _gru_bwd(fused_mgru_bwd, "fused_mgru_bwd", 2, gates, U, drop,
                    h_prev, dhs, act, qbits, False)


fused_mgru_bwd.launches = 0


def _dense_kernels(cell):
    """A cell's dense (forward, stash BPTT, recompute BPTT) wrappers,
    looked up when called (a swapped module attribute takes effect)."""
    if cell == "gru":
        return fused_gru_fwd, fused_gru_bwd_stash, fused_gru_bwd
    return fused_mgru_fwd, fused_mgru_bwd_stash, fused_mgru_bwd


def _gated_forward(ctx, cell, gates, U, drop, act, qbits):
    """The forward rule of :class:`_FusedGRU` and :class:`_FusedMGRU`:
    the stash forward when the cell's backward is the stash one."""
    fwd = _dense_kernels(cell)[0]
    stash = bwd_stash_enabled(cell)
    out = fwd(gates, U, drop, act=act, qbits=qbits, stash=stash)
    hs, acts = out if stash else (out, None)
    ctx.meta = (cell, act, qbits, stash)
    ctx.save_for_backward(None if stash else gates, U, drop, hs, acts)
    return hs


def _gated_backward(ctx, dhs):
    """The backward rule of :class:`_FusedGRU` and :class:`_FusedMGRU`:
    the BPTT kernel, then dU as two matmuls over the (T*B) batch: Uh's
    rows over q(s), the others' over q(h_prev). s = r * h_prev (the
    minimalGRU's z * h_prev) from the stashed gate or, on the recompute
    path, from the gate recomputed over the unrolled batch, as in JAX."""
    cell, act, qbits, stash = ctx.meta
    _, bwd_stash, bwd = _dense_kernels(cell)
    gates, U, drop, hs, acts = ctx.saved_tensors
    T, B, H = hs.shape
    M = T * B
    dhs = dhs.contiguous()
    h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
    if stash:
        dg = bwd_stash(acts, U, drop, h_prev, dhs, act)
    else:
        dg = bwd(gates, U, drop, h_prev, dhs, act, qbits)
    dU = None
    if ctx.needs_input_grad[1]:
        def q(v):
            return quantize_input_per_step(v, qbits) if qbits > 0 else v
        GH = dg.shape[2]
        hp, hq = h_prev.reshape(M, H), q(h_prev).reshape(M, H)
        if stash:         # the gate that scales s is the stash's last H
            s = acts.reshape(M, GH)[:, -H:] * hp
        else:
            s = torch.sigmoid(gates.reshape(M, GH)[:, -H:]
                              + hq @ U[-H:].T) * hp
        sq = q(s.reshape(T, B, H)).reshape(M, H)
        dgm = dg.reshape(M, GH)
        dU = torch.cat([dgm[:, :H].T @ sq, dgm[:, H:].T @ hq])
    return dg, dU, None, None, None


class _FusedGRU(torch.autograd.Function):
    """The JAX package's ``gru_scan_fused`` custom VJP over (gates, U):
    forward kernel (stash or not), BPTT kernel, then dU as two matmuls
    over the (T*B) batch."""

    @staticmethod
    def forward(ctx, gates, U, drop, act, qbits):
        return _gated_forward(ctx, "gru", gates, U, drop, act, qbits)

    backward = staticmethod(_gated_backward)


class _FusedMGRU(torch.autograd.Function):
    """The JAX package's ``mgru_scan_fused`` custom VJP over (gates, U):
    as :class:`_FusedGRU` on the minimalGRU's kernels (the backward is
    the recompute one unless ``PKC_BWD_STASH_CELLS`` lists ``mgru``)."""

    @staticmethod
    def forward(ctx, gates, U, drop, act, qbits):
        return _gated_forward(ctx, "mgru", gates, U, drop, act, qbits)

    backward = staticmethod(_gated_backward)


def gru_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                   drop_mask: torch.Tensor, act: str = "tanh",
                   quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from zero initial state, differentiable in
    ``gates_t`` (T, B, 3H) [h | z | r] and ``U`` (3H, H) [Uh; Uz; Ur]
    (``drop_mask`` is a constant). As in the JAX package it takes no
    compute dtype: the recurrence runs in float32."""
    gates_t, U = gates_t.to(torch.float32), U.to(torch.float32)
    if _needs_grad(gates_t, U):
        return _FusedGRU.apply(gates_t, U, drop_mask, act, quant_bits)
    return fused_gru_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits)


def gru_scan_fused_stream(gates_t: torch.Tensor, U: torch.Tensor,
                          drop_mask: torch.Tensor, h0: torch.Tensor,
                          act: str = "tanh", quant_bits: int = 0):
    """Streaming (inference-only) GRU forward seeded with the carry
    ``h0`` (B, H): -> ``(hs, hs[-1])``. Not differentiable."""
    with torch.no_grad():
        hs = fused_gru_fwd(gates_t.to(torch.float32), U.to(torch.float32),
                           drop_mask, h0.to(torch.float32), act=act,
                           qbits=quant_bits)
    return hs, hs[-1]


def mgru_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                    drop_mask: torch.Tensor, act: str = "tanh",
                    quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) of the minimalGRU from zero initial state,
    differentiable in ``gates_t`` (T, B, 2H) [h | z] and ``U`` (2H, H)
    [Uh; Uz] (``drop_mask`` is a constant); float32 whatever the compute
    dtype, as in the JAX package."""
    gates_t, U = gates_t.to(torch.float32), U.to(torch.float32)
    if _needs_grad(gates_t, U):
        return _FusedMGRU.apply(gates_t, U, drop_mask, act, quant_bits)
    return fused_mgru_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits)


def mgru_scan_fused_stream(gates_t: torch.Tensor, U: torch.Tensor,
                           drop_mask: torch.Tensor, h0: torch.Tensor,
                           act: str = "tanh", quant_bits: int = 0):
    """Streaming (inference-only) minimalGRU forward seeded with the
    carry ``h0`` (B, H): -> ``(hs, hs[-1])``. Not differentiable."""
    with torch.no_grad():
        hs = fused_mgru_fwd(gates_t.to(torch.float32), U.to(torch.float32),
                            drop_mask, h0.to(torch.float32), act=act,
                            qbits=quant_bits)
    return hs, hs[-1]


# -- the block-sparse GRU and minimalGRU: TPU kernels
# _build_gru_fwd_sparse, _build_gru_bwd_sparse, _build_mgru_fwd_sparse and
# _build_mgru_bwd_sparse become csrc/fused_gru_sparse.cu. The recurrent
# matrices share one HCGS mask; their kept blocks pack into w3g
# (Nb, G*bs, R*bs), each block gate-major [h | z | r] ([h | z]), and both
# products run over the kept blocks only. Either cell's forward runs all
# steps in one cooperative launch where its blocks fit and are co-resident
# (gru_fwd_sparse_route), else two launches per step. The backward
# rebuilds the forward's quantities for all steps at once, then runs the
# reverse chain (in one cooperative launch where it fits and is
# co-resident, gru_bwd_sparse_route / mgru_bwd_sparse_route, or two
# launches per reverse step), and also returns s for the dU: two
# block-sparse dw products.

def _gru_sparse_fns(w3g, layout, bf16):
    """(w3g's U_h and [U_z; U_r] (U_z) parts, rec_zr, rec_h) of the
    sparse twins; w3g bf16-rounded when ``bf16``."""
    wc = bf16_round(w3g) if bf16 else w3g
    w_h, w_zr = wc[:, :layout.bs], wc[:, layout.bs:]
    G_zr = w_zr.shape[1] // layout.bs
    return (w_h, w_zr, lambda x: sparse_recurrent_u(x, w_zr, layout, G_zr),
            lambda x: sparse_recurrent_u(x, w_h, layout, 1))


def fused_gru_fwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                               drop: torch.Tensor, layout, act: str = "tanh",
                               qbits: int = 0, bf16: bool = False
                               ) -> torch.Tensor:
    """Twin of the sparse GRU forward kernel (zero initial state): a
    Python loop over :func:`gru_cell`. -> hs (T, B, H). Over gates
    [h | z] and w3g (Nb, 2*bs, R*bs) it is the minimalGRU's."""
    T, B, _ = gates.shape
    _, _, rec_zr, rec_h = _gru_sparse_fns(w3g, layout, bf16)
    h = gates.new_zeros((B, layout.N))
    hs = []
    for t in range(T):
        h, _ = gru_cell(gates[t], h, rec_zr, rec_h, drop, ACTS[act], qbits,
                        bf16)
        hs.append(h)
    return torch.stack(hs)


def fused_gru_bwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                               drop: torch.Tensor, h_prev: torch.Tensor,
                               dhs: torch.Tensor, layout, act: str = "tanh",
                               qbits: int = 0, bf16: bool = False):
    """Twin of the sparse GRU BPTT kernel: per reverse step it rebuilds
    z (and r), s and the candidate from ``h_prev`` and runs the cotangent
    chain (JAX ``_build_gru_bwd_sparse`` :1523-1538,
    ``_build_mgru_bwd_sparse`` :1690-1701; ``act'`` from the
    pre-activation, dh through the quantizers unchanged, the cotangents
    bf16-rounded before their dots when ``bf16``). -> (dg shaped like
    ``gates``, s (T, B, H))."""
    w_h, w_zr, rec_zr, rec_h = _gru_sparse_fns(w3g, layout, bf16)
    s_seq = torch.empty_like(h_prev)
    step = _gru_recompute_step(gates, h_prev, rec_zr, rec_h, act, qbits, bf16,
                               s_seq)

    def dots(w):
        G = w.shape[1] // layout.bs
        return lambda d: sparse_dh(bf16_round(d) if bf16 else d, w, layout, G)
    dg = _gru_bwd_loop(step, h_prev, dhs, drop, dots(w_h), dots(w_zr), gates)
    return dg, s_seq


#: The minimalGRU's sparse plain twins (of ``_build_mgru_fwd_sparse`` and
#: ``_build_mgru_bwd_sparse``): the GRU's over gates [h | z] and w3g
#: (Nb, 2*bs, R*bs); the backward's s is z * h_prev.
fused_mgru_fwd_sparse_plain = fused_gru_fwd_sparse_plain
fused_mgru_bwd_sparse_plain = fused_gru_bwd_sparse_plain


def _gru_fwd_sparse(wrapper, G, scan, gates, w3g, drop, layout, act, qbits,
                    bf16):
    """The body of :func:`fused_gru_fwd_sparse` (G=3) and
    :func:`fused_mgru_fwd_sparse` (G=2): the C entry point of
    ``wrapper``'s name, ``scan`` the differentiable caller."""
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act, (),
                                  gates=G)
    if _needs_grad(gates, w3g):
        raise RuntimeError("%s has no autograd of its own: call %s"
                           % (wrapper.__name__, scan))
    if gates.device.type == "cpu":
        return fused_gru_fwd_sparse_plain(gates, w3g, drop, layout, act,
                                          qbits, bf16)
    route, plan = gru_fwd_sparse_route(B, layout, bf16, gates.device, G)
    if route == "persist":
        return _gru_fwd_sparse_persist(plan, gates, w3g, drop, layout, act,
                                       qbits, bf16)
    return _gru_fwd_sparse_step(wrapper, gates, w3g, drop, layout, act,
                                qbits, bf16)


def _gru_fwd_sparse_step(wrapper, gates, w3g, drop, layout, act, qbits,
                         bf16):
    """The sparse forward of ``wrapper`` (:func:`fused_gru_fwd_sparse` or
    :func:`fused_mgru_fwd_sparse`, checked operands, ``drop`` (B, H)) on
    the step route: two launches a step. -> hs (T, B, H)."""
    T, B, GH = gates.shape
    H, dev = layout.N, gates.device
    G = GH // H
    from . import _build
    lib = _build.load("fused_gru_sparse")
    fn = getattr(lib, wrapper.__name__)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    fw = torch.empty((B, G * H), dtype=torch.float32, device=dev)
    s = torch.empty((B, H), dtype=torch.float32, device=dev)
    qslots = torch.empty(2 * T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    wk = _sparse_w(w3g, bf16)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), fw.data_ptr(), s.data_ptr(),
                qslots.data_ptr(), T, B, H, layout.R, layout.bs,
                _ACT_CODE[act], qbits, int(bf16), _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 2 * T
    return hs


def _gru_fwd_sparse_persist(plan, gates, w3g, drop, layout, act, qbits,
                            bf16):
    """The sparse GRU or minimalGRU forward (told apart by the gates'
    width) on the persistent route (``plan``: its PersistPlan,
    :func:`gru_fwd_sparse_plan`): all T steps in one cooperative launch.
    -> hs (T, B, H)."""
    from . import block_sparse as BS
    T, B, GH = gates.shape
    H, dev = layout.N, gates.device
    G = GH // H
    wrapper, entry = ((fused_gru_fwd_sparse, "gru_fwd_sparse_persist")
                      if G == 3 else
                      (fused_mgru_fwd_sparse, "mgru_fwd_sparse_persist"))
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    s = torch.empty((B, H), dtype=torch.float32, device=dev)
    # each block's max|h| and max|s| of the step, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    wk = _sparse_w(w3g, bf16)
    BS._launch("fused_gru_sparse", entry, dev,
               (gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), s.data_ptr(),
                bmax.data_ptr()),
               (T, B, H, layout.R, layout.bs, _ACT_CODE[act], qbits,
                int(bf16), plan.grid, plan.bi, plan.units, plan.smem))
    wrapper.launches += gru_fwd_sparse_launches("persist", T)
    return hs


def fused_gru_fwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                         drop: torch.Tensor, layout, act: str = "tanh",
                         qbits: int = 0, bf16: bool = False) -> torch.Tensor:
    """Whole-layer GRU forward from the zero state over the kept blocks of
    U (TPU kernel ``_build_gru_fwd_sparse``): ``gates`` (T, B, 3H) float32
    ordered [h | z | r], ``w3g`` (Nb, 3*bs, R*bs) float32 (cast to bf16
    for the kernel when ``bf16``), ``drop`` broadcastable to (B, H). ->
    hs (T, B, H). CUDA tensors run the kernels on the route
    :func:`gru_fwd_sparse_route` picks before the launch: "persist" (all
    steps in one cooperative launch) where the blocks fit and are
    co-resident, else "step" (two launches per step); CPU tensors the
    twin; no autograd of its own (:func:`gru_scan_fused_sparse` carries
    the BPTT kernel)."""
    return _gru_fwd_sparse(fused_gru_fwd_sparse, 3, "gru_scan_fused_sparse",
                           gates, w3g, drop, layout, act, qbits, bf16)


fused_gru_fwd_sparse.launches = 0


def fused_mgru_fwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                          drop: torch.Tensor, layout, act: str = "tanh",
                          qbits: int = 0, bf16: bool = False
                          ) -> torch.Tensor:
    """Whole-layer minimalGRU forward from the zero state over the kept
    blocks of U (TPU kernel ``_build_mgru_fwd_sparse``): ``gates``
    (T, B, 2H) float32 ordered [h | z], ``w3g`` (Nb, 2*bs, R*bs) float32
    (cast to bf16 for the kernel when ``bf16``), ``drop`` broadcastable to
    (B, H). -> hs (T, B, H). CUDA tensors run the kernels on the route
    :func:`gru_fwd_sparse_route` picks before the launch at G=2: "persist"
    (all steps in one cooperative launch, the step route's bits) where the
    blocks fit and are co-resident, else "step" (two launches per step);
    CPU tensors the twin; no autograd (:func:`mgru_scan_fused_sparse`)."""
    return _gru_fwd_sparse(fused_mgru_fwd_sparse, 2, "mgru_scan_fused_sparse",
                           gates, w3g, drop, layout, act, qbits, bf16)


fused_mgru_fwd_sparse.launches = 0


#: The sparse GRU and liGRU backwards' static shared memory (the per-unit
#: sums and the entry lists).
_GRU_BWD_STATIC = 8 * 8 * 4 + 2 * 64 * 4


# ---------------------------------------------------------------------------
# the GRU BPTTs' persistent reverse chains (csrc/persist.cuh): the plan and
# the route, picked before the launch
# ---------------------------------------------------------------------------

#: persist.cuh's block: the hidden units a block owns and its warps, and
#: the sparse chain's static shared memory (its column's entry lists)
PERSIST_UNITS, PERSIST_WARPS = 8, 8
_PERSIST_SPARSE_STATIC = 2 * 64 * 4


class PersistPlan(NamedTuple):
    """A persistent chain's launch: ``bi`` (a block's batch rows / 8) and
    ``units`` (its hidden units), ``grid`` blocks, ``smem`` bytes of
    dynamic and ``static`` of static shared memory a block, and per block
    its ``resident`` weight bytes and the bytes it ``staged`` per step
    (the heaviest block's), ``slab`` values of the contraction a row at a
    time in ``slabs`` copies (the liGRU's chain; the GRU chains stage
    whole rows and leave 0 and 1)."""
    bi: int
    units: int
    grid: int
    smem: int
    static: int
    resident: int
    staged: int
    slab: int = 0
    slabs: int = 1


def _row_stride(K: int) -> int:
    """persist.cuh's ``row_stride``: floats between two staged rows."""
    return (K + 7) // 8 * 8 + 4


def _w_stride(units: int) -> int:
    """persist.cuh's ``w_stride``: floats between two weight rows of
    ``units`` columns (padded at 16 and 32 against bank conflicts)."""
    return {16: 20, 32: 36}.get(units, units)


#: the block shape (bi, units) of the liGRU's chain and of the sparse GRU
#: forward's above 16 batch rows: 16 units x 16 rows, which stage half the
#: bytes of 8 x 32 (the blocks of one unit group stage the same rows)
WIDE_SHAPE = (2, 16)


def _shape(B: int, wide=WIDE_SHAPE) -> tuple:
    """(bi, units) of a chain at batch B: 8 units and 8 (B <= 8) or 16
    (B <= 16) rows, else ``wide``."""
    return (1, 8) if B <= 8 else ((2, 8) if B <= 16 else wide)


def _slabs(XS: int, bt: int, fixed: int) -> tuple:
    """(slab, buffers) of a chain whose block keeps ``fixed`` bytes of
    shared memory beside ``bt`` staged rows of XS values (a multiple of
    8): whole rows in one buffer where they fit, else the fewest slabs of
    a multiple of 32 values whose two buffers fit (persist::slab_dots)."""
    if fixed + 4 * bt * _row_stride(XS) <= _SMEM_MAX:
        return XS, 1
    avail = (_SMEM_MAX - fixed) // (4 * 2 * bt)
    n = 2
    while True:                     # n slabs of ceil(XS / n), up to 32s
        slab = (-(-XS // n) + 31) // 32 * 32
        if _row_stride(slab) <= avail or slab <= 32:
            return slab, 2
        n += 1


def ligru_bwd_plan(B: int, H: int, shape: Optional[tuple] = None
                   ) -> PersistPlan:
    """The liGRU recompute BPTT's persistent chain at batch B and width H
    (``shape`` (bi, units) forces a block shape; else :func:`_shape`): a
    block owns its units' 2H-long columns of U (rows of 16 units padded to
    20 floats), stages dg_{t+1} (2H floats a row) per step: at once where
    the rows fit beside the weights and the dots' partials, else in the
    fewest slabs of a multiple of 32 values whose two buffers fit."""
    bi, un = shape or _shape(B)
    bt, K = 8 * bi, 2 * H
    ws = 4 * K * _w_stride(un)
    red = 4 * PERSIST_WARPS * bt * un
    slab, bufs = _slabs(-(-K // 8) * 8, bt, ws + red)
    smem = ws + 4 * bufs * bt * _row_stride(slab) + red
    grid = -(-H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, 4 * K * un,
                       4 * min(bt, B) * K, slab, -(-K // slab))


def gru_fwd_sparse_plan(B: int, layout, shape: Optional[tuple] = None,
                        G: int = 3) -> PersistPlan:
    """The sparse GRU (G=3) or minimalGRU (G=2) forward's persistent chain
    at batch B over ``layout`` (``shape`` forces (bi, units), one of
    :data:`GRU_FWD_SPARSE_SHAPES`): a block owns units of one out-block
    (16 only where bs holds them) with their R*bs-long rows of the G gates
    resident, and stages per step q(h_{t-1}) and q(s) at the out-block's R
    kept column blocks. The GRU keeps [z | r] as 2 x units columns and the
    candidate's as units (padded as :func:`_w_stride`) and the dots'
    partials of 8 warps; the minimalGRU, whose dots sum in the step
    kernels' order, keeps its 2 x units weights as rows and one sum a row
    and unit."""
    bs, K3 = layout.bs, layout.R * layout.bs
    bi, un = shape or _shape(B, WIDE_SHAPE if bs % 16 == 0 else (4, 8))
    bt, zc = 8 * bi, (G - 1) * un
    if G == 3:
        ws = 4 * K3 * (_w_stride(zc) + _w_stride(un))
        red = 4 * PERSIST_WARPS * bt * zc
    else:
        ws, red = 4 * K3 * (zc + un), 4 * bt * zc
    smem = ws + 4 * bt * _row_stride(K3) + red
    grid = (layout.N // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, 4 * G * K3 * un,
                       2 * 4 * min(bt, B) * K3)


#: the sparse forward's block shapes (bi, units) that fused_gru_sparse.cu
#: instantiates for both cells (``PK_SPARSE_FWD_SHAPE``): the plan's
GRU_FWD_SPARSE_SHAPES = ((1, 8), (2, 8), (4, 8), (2, 16))


def gru_torch_bwd_plan(B: int, H: int) -> PersistPlan:
    """The torch-semantics GRU's persistent chain at batch B and width H:
    a block owns 8 units (their 3H-long columns of W_hh resident) and 8 or
    32 batch rows, stages du_{t+1} (3H floats a row) per step."""
    bi = 1 if B <= 8 else 4
    bt, K = 8 * bi, 3 * H
    ws = 4 * K * PERSIST_UNITS
    smem = ws + 4 * bt * _row_stride(K) + 4 * PERSIST_WARPS * bt * PERSIST_UNITS
    grid = -(-H // PERSIST_UNITS) * -(-B // bt)
    return PersistPlan(bi, PERSIST_UNITS, grid, smem, 0, ws,
                       4 * min(bt, B) * K)


def _sparse_bwd_plan(B: int, H: int, bs: int, C: int, G: int,
                     shape: Optional[tuple]) -> PersistPlan:
    """The sparse reverse chain (csrc/fused_gru_sparse.cu's
    ``gru_bwd_persist``) of a G-gate cell at batch B, width H, block size
    bs and at most C kept blocks in a block column (``shape`` forces (bi,
    units), one of :data:`GRU_BWD_SPARSE_SHAPES`): a block owns the units
    of one block column and batch rows, 8 and 8 (B <= 8), 16 and 16 (bs a
    multiple of 16) or 8 and 32, with G*bs floats a unit and an entry
    resident (the columns of U_z (and U_r) and U_h; rows of 16 units
    padded to 20 floats), and stages per step [dg_z (| dg_r)] ((G-1)bs
    floats an entry and a row) and dg_h (bs). Of the 256 outputs a block
    forms, 16 units x 16 rows stage half the bytes of 8 x 32: the CTAs of
    one block column stage the same cotangents from L2."""
    un = 16 if B > 8 and bs % 16 == 0 else PERSIST_UNITS
    bi = 1 if B <= 8 else (2 if un == 16 else 4)
    if shape:
        bi, un = shape
    bt = 8 * bi
    smem = (4 * G * C * bs * _w_stride(un)
            + 4 * bt * _row_stride((G - 1) * C * bs)
            + 4 * PERSIST_WARPS * bt * un)
    grid = (H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, _PERSIST_SPARSE_STATIC,
                       4 * G * C * bs * un, 4 * min(bt, B) * G * C * bs)


def gru_bwd_sparse_plan(B: int, H: int, bs: int, C: int) -> PersistPlan:
    """The sparse GRU's persistent chain (:func:`_sparse_bwd_plan` at
    G=3): 3bs floats a unit and an entry resident, [dg_z | dg_r] (2bs
    floats an entry and a row) and dg_h (bs) staged per step."""
    return _sparse_bwd_plan(B, H, bs, C, 3, None)


def mgru_bwd_sparse_plan(B: int, H: int, bs: int, C: int,
                         shape: Optional[tuple] = None) -> PersistPlan:
    """The sparse minimalGRU's persistent chain (:func:`_sparse_bwd_plan`
    at G=2; ``shape`` forces (bi, units)): 2bs floats a unit and an entry
    resident (U_z's and U_h's columns), dg_z and dg_h (bs floats an entry
    and a row each) staged per step."""
    return _sparse_bwd_plan(B, H, bs, C, 2, shape)


#: the sparse chain's block shapes (bi, units) that fused_gru_sparse.cu
#: instantiates for both cells (``PK_SPARSE_BWD_SHAPE``): the plan's
GRU_BWD_SPARSE_SHAPES = ((1, 8), (2, 16), (4, 8))


def persist_route(plan: PersistPlan, blocks_per_sm: int, sms: int,
                  coop: bool = True, smem_max: int = _SMEM_MAX) -> str:
    """"persist" where the plan's block fits ``smem_max`` bytes of shared
    memory and its grid is co-resident (``blocks_per_sm`` on each of
    ``sms`` SMs, cooperative launches taken), else "step" (a launch per
    reverse step)."""
    fits = plan.smem + plan.static <= smem_max
    return ("persist" if coop and fits and 0 < plan.grid
            <= blocks_per_sm * sms else "step")


@functools.lru_cache(maxsize=None)
def _persist_occupancy(lib_name: str, entry: str, args: tuple, index: int):
    """(blocks per SM, SMs, cooperative) of a chain's kernel on device
    ``index``: its library's occupancy entry ``entry`` called with the
    ints ``args`` (the last its dynamic shared memory)."""
    from . import _build
    lib = _build.load(lib_name)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        rc = fn(*args, out)
    _build.check(lib, rc, entry)
    return out[0], out[1], bool(out[2])


def _route(plan: PersistPlan, lib_name: str, entry: str, args: tuple,
           dev: torch.device) -> str:
    """The route on device ``dev``: "step" without asking where the block
    does not fit, else from the occupancy query."""
    if plan.smem + plan.static > _SMEM_MAX:
        return "step"
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return persist_route(plan, *_persist_occupancy(lib_name, entry,
                                                   args + (plan.smem,),
                                                   index))


def gru_torch_bwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_gru_torch_bwd` at batch B and width H
    on the card ``dev``."""
    plan = gru_torch_bwd_plan(B, H)
    return _route(plan, "fused_gru_torch", "fused_gru_torch_bwd_occupancy",
                  (plan.bi,), torch.device(dev)), plan


def gru_bwd_sparse_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_gru_bwd_sparse` at batch B over
    ``layout`` on the card ``dev``."""
    plan = gru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    return _route(plan, "fused_gru_sparse", "gru_bwd_sparse_occupancy",
                  (int(bf16), plan.bi), torch.device(dev)), plan


def ligru_bwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_ligru_bwd` at batch B and width H on
    the card ``dev``."""
    plan = ligru_bwd_plan(B, H)
    return _route(plan, "fused_ligru", "fused_ligru_bwd_occupancy",
                  (plan.bi, plan.units), torch.device(dev)), plan


def ligru_bwd_launches(route: str, T: int, qbits: int) -> int:
    """Kernels one :func:`fused_ligru_bwd` call launches on ``route``:
    "persist" the per-step scales and q(h_prev) (qbits > 0), the rebuild's
    GEMM and the chain; "step" one a reverse step."""
    return 2 + 2 * int(qbits > 0) if route == "persist" else T


def gru_fwd_sparse_route(B: int, layout, bf16: bool, dev, G: int = 3
                         ) -> tuple:
    """(route, plan) of :func:`fused_gru_fwd_sparse` (G=3) and
    :func:`fused_mgru_fwd_sparse` (G=2) at batch B over ``layout`` on the
    card ``dev``: "step" where the block's units do not divide bs."""
    plan = gru_fwd_sparse_plan(B, layout, G=G)
    if layout.bs % plan.units:
        return "step", plan
    entry = "gru_fwd_sparse_occupancy" if G == 3 else \
        "mgru_fwd_sparse_occupancy"
    return _route(plan, "fused_gru_sparse", entry,
                  (int(bf16), plan.bi, plan.units), torch.device(dev)), plan


def gru_fwd_sparse_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_gru_fwd_sparse` or
    :func:`fused_mgru_fwd_sparse` call launches on ``route``: "persist"
    the one cooperative launch, "step" two a step."""
    return 1 if route == "persist" else 2 * T


def gru_fwd_plan(B: int, H: int, G: int, shape: Optional[tuple] = None
                 ) -> PersistPlan:
    """The dense GRU (G=3) or minimalGRU (G=2) forward's persistent chain
    at batch B and width H (``shape`` forces (bi, units), one of
    :data:`GRU_FWD_SHAPES`; else :func:`_shape`): a block owns units (the
    last group masked where they do not divide H) with their H-long rows
    of the G gates resident, stages per step q(h_{t-1}) and q(s): its
    rows of the exchange buffers, H rounded up to 4 floats each
    (``staged``), at a row stride of :func:`_row_stride` (H), and keeps
    one sum a row and gate-unit ((G-1) x units of them)."""
    bi, un = shape or _shape(B)
    bt, zc = 8 * bi, (G - 1) * un
    resident = 4 * G * un * H
    smem = resident + 4 * bt * _row_stride(H) + 4 * bt * zc
    grid = -(-H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, resident,
                       2 * 4 * min(bt, B) * gru_fwd_exchange_stride(H))


#: the dense forward's block shapes (bi, units) that fused_gru.cu
#: instantiates: :func:`_shape`'s three and 4 and 16 units at 8 rows (the
#: forced plans ``chip_smoke.py --rnn-times`` times at the TIMIT shapes)
GRU_FWD_SHAPES = ((1, 4), (1, 8), (2, 8), (1, 16), (2, 16))


def gru_fwd_exchange_stride(H: int) -> int:
    """Floats between two rows of the dense persistent forward's exchange
    buffers (h_t and s): H rounded up to 4, so that every row starts 16
    bytes aligned for ``cp.async``."""
    return -(-H // 4) * 4


def gru_fwd_route(B: int, H: int, G: int, dev) -> tuple:
    """(route, plan) of :func:`fused_gru_fwd` (G=3) and
    :func:`fused_mgru_fwd` (G=2) at batch B and width H on the card
    ``dev``."""
    plan = gru_fwd_plan(B, H, G)
    return _route(plan, "fused_gru", "gru_fwd_dense_occupancy",
                  (G, plan.bi, plan.units), torch.device(dev)), plan


def gru_fwd_launches(route: str, T: int, seeded: bool, qbits: int) -> int:
    """Kernels one :func:`fused_gru_fwd` or :func:`fused_mgru_fwd` call
    launches on ``route``: "persist" the one cooperative launch (a seed's
    scale is taken inside it); "step" two a step, and the reduction of
    max|h0| before them with a seed and the quantizer."""
    if route == "persist":
        return 1
    return 2 * T + int(seeded and qbits > 0)


def ligru_fwd_plan(B: int, H: int, shape: Optional[tuple] = None
                   ) -> PersistPlan:
    """The liGRU forward's persistent chain at batch B and width H
    (``shape`` forces (bi, units), one of :data:`LIGRU_FWD_SHAPES`; else
    :func:`_shape`): a block owns units (the last group masked where they
    do not divide H) with their H-long rows of Uh and Uz resident, stages
    per step q(h_{t-1}): its rows of the exchange buffer, H rounded up to 4
    floats each (``staged``), at a row stride of :func:`_row_stride` (H),
    and keeps one sum a row and gate-unit (2 x units of them). Above 16
    rows a block takes 8 units x 32 rows: at the libri Li-GRU's 32 rows of
    1024 it ran 2.42-2.45 ms a call against 16 x 16's 3.18-3.21
    (``chip_smoke.py --rnn-times`` on an NVIDIA H100 80GB HBM3 at 700 W,
    both forced)."""
    bi, un = shape or _shape(B, (4, 8))
    bt = 8 * bi
    resident = 4 * 2 * un * H
    smem = resident + 4 * bt * _row_stride(H) + 4 * bt * 2 * un
    grid = -(-H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, resident,
                       4 * min(bt, B) * gru_fwd_exchange_stride(H))


#: the liGRU forward's block shapes (bi, units) that fused_ligru.cu
#: instantiates: the plan's three and 16 units x 16 rows (the forced plan
#: ``chip_smoke.py --rnn-times`` times at the libri shape)
LIGRU_FWD_SHAPES = ((1, 8), (2, 8), (4, 8), (2, 16))


def ligru_fwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_ligru_fwd` at batch B and width H on
    the card ``dev``."""
    plan = ligru_fwd_plan(B, H)
    return _route(plan, "fused_ligru", "fused_ligru_fwd_occupancy",
                  (plan.bi, plan.units), torch.device(dev)), plan


def ligru_fwd_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_ligru_fwd` call launches on ``route``
    (as its counter counts them): "persist" the one cooperative launch,
    seeded or not; "step" one a step."""
    return 1 if route == "persist" else T


def _dense_bwd_plan(B: int, H: int, G: int, shape: tuple) -> PersistPlan:
    """The dense GRU-family reverse chain (csrc/fused_gru.cu's
    ``gru_dense_bwd_persist``) of a G-gate cell at batch B and width H on
    blocks of ``shape`` (bi, units): a block owns units (the last group
    masked where they do not divide H) with their columns of U resident,
    (G-1)H rows of [Uz (; Ur)] and H of Uh (rows of 16 units padded to 20
    floats), stages per reverse step [dg_z (| dg_r)] of step t+1 and dg_h
    of step t: its rows of the exchange buffers, (G-1)H and H rounded up
    to 4 floats (``staged``), at a row stride of :func:`_row_stride`
    ((G-1)H), and keeps the dots' partials (8 warps' of each row and
    unit)."""
    bi, un = shape
    bt = 8 * bi
    smem = (4 * G * H * _w_stride(un) + 4 * bt * _row_stride((G - 1) * H)
            + 4 * PERSIST_WARPS * bt * un)
    grid = -(-H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, 4 * G * H * un,
                       4 * min(bt, B) * (gru_fwd_exchange_stride((G - 1) * H)
                                         + gru_fwd_exchange_stride(H)))


def mgru_bwd_plan(B: int, H: int, shape: Optional[tuple] = None
                  ) -> PersistPlan:
    """The minimalGRU recompute BPTT's persistent reverse chain at batch B
    and width H (``shape`` forces (bi, units), one of
    :data:`MGRU_BWD_SHAPES`; else :func:`_shape`; :func:`_dense_bwd_plan`
    at G=2): a block's H-long columns of Uz and Uh resident, dg_z of step
    t+1 and dg_h of step t staged, H floats each. Above 16 rows a block
    takes 8 units x 32 rows: 16 x 16 does not fit at H=1024 (rows of 16
    units padded to 20 floats)."""
    return _dense_bwd_plan(B, H, 2, shape or _shape(B, (4, 8)))


#: the minimalGRU chain's block shapes (bi, units) that fused_gru.cu
#: instantiates: 8 units and 8, 16 or 32 rows
MGRU_BWD_SHAPES = ((1, 8), (2, 8), (4, 8))


def mgru_rebuild_rows(H: int) -> int:
    """Rows of the unrolled batch a block of the minimalGRU rebuild's
    products (``rows_dots`` of csrc/fused_gru.cu) stages at once: the most
    of 32, 16 and 8 that fit beside its 16 resident rows of U (rows of H
    floats at a stride of :func:`_row_stride` (H), and the dots' sums); 0
    where none does."""
    for bt in (32, 16, 8):
        if 4 * (16 * H + bt * _row_stride(H) + bt * 16) <= _SMEM_MAX:
            return bt
    return 0


def mgru_bwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_mgru_bwd` at batch B and width H on
    the card ``dev``: "step" where the rebuild's rows do not fit
    (:func:`mgru_rebuild_rows`)."""
    plan = mgru_bwd_plan(B, H)
    if not mgru_rebuild_rows(H):
        return "step", plan
    return _route(plan, "fused_gru", "gru_bwd_dense_occupancy",
                  (2, plan.bi, plan.units), torch.device(dev)), plan


def gru_bwd_stash_plan(B: int, H: int, shape: Optional[tuple] = None
                       ) -> PersistPlan:
    """The GRU stash BPTT's persistent reverse chain at batch B and width
    H (``shape`` forces (bi, units), one of :data:`GRU_BWD_SHAPES`; else
    :func:`_shape`'s 8 units and 8, 16 or 32 rows): :func:`_dense_bwd_plan`
    at G=3, a block's 2H-long columns of [Uz; Ur] and H-long ones of Uh
    resident, [dg_z | dg_r] (2H floats a row) and dg_h staged. Where the
    staged rows do not fit beside the weights (H=1024 at 16 rows) the
    plan's block exceeds shared memory and the route is "step". At the
    TIMIT GRU's 8 rows of 550, 8 units a block (69 blocks) ran 2.00 ms a
    call against 2.48-2.49 for 4 units (138 blocks, two an SM) and
    2.24-2.25 for 8 x 16 (``chip_smoke.py --rnn-times``, NVIDIA H100 80GB
    HBM3 at 700 W, the forced shapes)."""
    return _dense_bwd_plan(B, H, 3, shape or _shape(B, (4, 8)))


#: the GRU stash chain's block shapes (bi, units) that fused_gru.cu
#: instantiates (``PK_GRU_BWD_SHAPE``): the plan's 8 units and 8, 16 or 32
#: rows, and 4 units x 8 rows (two blocks an SM), which a forced plan
#: times at the TIMIT GRU's shape
GRU_BWD_SHAPES = ((1, 4), (1, 8), (2, 8), (4, 8))


def gru_bwd_stash_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_gru_bwd_stash` at batch B and width H
    on the card ``dev``."""
    plan = gru_bwd_stash_plan(B, H)
    return _route(plan, "fused_gru", "gru_bwd_dense_occupancy",
                  (3, plan.bi, plan.units), torch.device(dev)), plan


def gru_bwd_stash_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_gru_bwd_stash` call launches on ``route``:
    "persist" the one cooperative launch; "step" two a reverse step."""
    return 1 if route == "persist" else 2 * T


def mgru_bwd_launches(route: str, T: int, qbits: int) -> int:
    """Kernels one :func:`fused_mgru_bwd` call launches on ``route``:
    "persist" the two rebuild products around the z pass, and the chain (4),
    and with the quantizer the per-step scales, q(h_prev) and q(s) (7);
    "step" the two rebuild kernels and two a reverse step."""
    if route == "persist":
        return 4 + 3 * int(qbits > 0)
    return 2 * T + 2


def mgru_bwd_sparse_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_mgru_bwd_sparse` at batch B over
    ``layout`` on the card ``dev``."""
    plan = mgru_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    return _route(plan, "fused_gru_sparse", "mgru_bwd_sparse_occupancy",
                  (int(bf16), plan.bi), torch.device(dev)), plan


def mgru_bwd_sparse_launches(route: str, T: int, qbits: int) -> int:
    """Kernels one :func:`fused_mgru_bwd_sparse` call launches on
    ``route``: "persist" the rebuild's two step kernels over all T (after
    the per-step scales with the quantizer) and the chain; "step" the two
    rebuild kernels and two a reverse step."""
    if route == "persist":
        return 3 + int(qbits > 0)
    return 2 * T + 2


def gru_bwd_sparse_launches(route: str, T: int, qbits: int,
                            bf16: bool) -> int:
    """Kernels one :func:`fused_gru_bwd_sparse` call launches from its
    library on ``route``: "persist" the per-step scales (qbits > 0), q(h)
    and q(s) (qbits > 0 or bf16), the z/r pass, a_pre and the chain (and
    two :func:`block_sparse_v3_fwd` calls, counted there); "step" the two
    rebuild kernels and two per reverse step."""
    if route == "step":
        return 2 * T + 2
    rq = qbits > 0 or bf16
    return 3 + int(qbits > 0) + 2 * int(rq)


def _gru_bwd_sparse(wrapper, G, gates, w3g, drop, h_prev, dhs, layout, act,
                    qbits, bf16):
    """The body of :func:`fused_gru_bwd_sparse` (G=3) and
    :func:`fused_mgru_bwd_sparse` (G=2): the C entry point of
    ``wrapper``'s name."""
    seqs = (("h_prev", h_prev), ("dhs", dhs))
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act,
                                  seqs, gates=G)
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs])
    if gates.device.type == "cpu":
        return fused_gru_bwd_sparse_plain(gates, w3g, drop, h_prev, dhs,
                                          layout, act, qbits, bf16)
    route, plan = (gru_bwd_sparse_route if G == 3 else mgru_bwd_sparse_route)(
        B, layout, bf16, gates.device)
    if route == "persist":
        persist = _gru_bwd_sparse_persist if G == 3 else \
            _mgru_bwd_sparse_persist
        return persist(plan, gates, w3g, drop, h_prev, dhs, layout, act,
                       qbits, bf16)
    return _gru_bwd_sparse_step(wrapper, gates, w3g, drop, h_prev, dhs,
                                layout, act, qbits, bf16)


def _gru_bwd_sparse_step(wrapper, gates, w3g, drop, h_prev, dhs, layout,
                         act, qbits, bf16):
    """The sparse BPTT of ``wrapper`` (:func:`fused_gru_bwd_sparse` or
    :func:`fused_mgru_bwd_sparse`, checked operands, ``drop`` (B, H)) on
    the step route: the two rebuild kernels, two launches a reverse step.
    -> (dg, s)."""
    T, B, H = h_prev.shape
    G = gates.shape[2] // H
    smem = 4 * 8 * layout.C * (G - 1) * layout.bs
    if smem + _GRU_BWD_STATIC > _SMEM_MAX:
        raise ValueError("%s: %d blocks per column of %d need %d bytes of "
                         "shared memory, more than a block has"
                         % (wrapper.__name__, layout.C, layout.bs, smem))
    from . import _build
    lib = _build.load("fused_gru_sparse")
    fn = getattr(lib, wrapper.__name__)
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = gates.device
    wk = _sparse_w(w3g, bf16)
    wt = wk.transpose(1, 2).contiguous()      # (Nb, R*bs, G*bs): carry dots
    f32 = dict(dtype=torch.float32, device=dev)
    fw = torch.empty((T, B, G * H), **f32)
    s_seq = torch.empty((T, B, H), **f32)
    dh, ds = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    dg = torch.empty((T, B, G * H), **f32)
    qslots = torch.empty(2 * T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), wk.data_ptr(), wt.data_ptr(), *idx,
                drop.data_ptr(), h_prev.data_ptr(), dhs.data_ptr(),
                fw.data_ptr(), s_seq.data_ptr(), dh.data_ptr(), ds.data_ptr(),
                dg.data_ptr(), qslots.data_ptr(), T, B, H, layout.R,
                layout.bs, layout.C, layout.nnz, _ACT_CODE[act], qbits,
                int(bf16), _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 2 * T + 2
    return dg, s_seq


def _gru_bwd_sparse_persist(plan, gates, w3g, drop, h_prev, dhs, layout,
                            act, qbits, bf16):
    """The GRU BPTT on the persistent route (``plan``: its PersistPlan):
    the forward quantities of all M = T*B rows as passes of
    ``csrc/fused_gru_sparse.cu`` around two v3 GEMMs
    (:func:`block_sparse_v3_fwd`: q(h_prev) against [U_z; U_r], q(s)
    against U_h; under ``bf16`` the operands rounded to bf16 values, so
    every product is the step kernels'), then the chain in one cooperative
    launch. -> (dg, s)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    M, bs, dev = T * B, layout.bs, gates.device
    wk = _sparse_w(w3g, bf16)
    wf = wk.to(torch.float32) if bf16 else wk      # the GEMMs' float32 values
    w_zr, w_h = wf[:, bs:].contiguous(), wf[:, :bs].contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    fw = torch.empty((T, B, 3 * H), **f32)
    s_seq = torch.empty((T, B, H), **f32)
    dg = torch.empty((T, B, 3 * H), **f32)
    qslots = torch.empty(2 * T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    rq = qbits > 0 or bf16                   # q(v) differs from v
    qh = torch.empty((T, B, H), **f32) if rq else h_prev
    qs = torch.empty((T, B, H), **f32) if rq else s_seq
    lib = "fused_gru_sparse"
    if rq:
        BS._launch(lib, "gru_bwd_sparse_rebuild_h", dev,
                   (h_prev.data_ptr(), qh.data_ptr(), qslots.data_ptr()),
                   (T, B, H, qbits, int(bf16)))
    uzr = BS.block_sparse_v3_fwd(qh.reshape(M, H), w_zr, layout, 2)
    BS._launch(lib, "gru_bwd_sparse_rebuild_zr", dev,
               (gates.data_ptr(), uzr.data_ptr(), h_prev.data_ptr(),
                fw.data_ptr(), s_seq.data_ptr(), qs.data_ptr(),
                qslots.data_ptr()), (T, B, H, qbits, int(bf16)))
    uh = BS.block_sparse_v3_fwd(qs.reshape(M, H), w_h, layout, 1)
    BS._launch(lib, "gru_bwd_sparse_persist", dev,
               (gates.data_ptr(), uh.data_ptr(), wk.data_ptr(),
                layout.device_index("t_row_idx", dev).data_ptr(),
                layout.device_index("t_perm", dev).data_ptr(),
                drop.data_ptr(), h_prev.data_ptr(), dhs.data_ptr(),
                fw.data_ptr(), dg.data_ptr()),
               (T, B, H, layout.R, bs, layout.C, layout.nnz, _ACT_CODE[act],
                int(bf16), plan.grid, plan.bi, plan.smem))
    fused_gru_bwd_sparse.launches += gru_bwd_sparse_launches(
        "persist", T, qbits, bf16)
    return dg, s_seq


def _mgru_bwd_sparse_persist(plan, gates, w3g, drop, h_prev, dhs, layout,
                             act, qbits, bf16):
    """The minimalGRU BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`mgru_bwd_sparse_plan`): the forward quantities of
    all steps on the forward's step kernels (its bits, so act' takes its
    branch), then the chain in one cooperative launch, all from one entry
    point. -> (dg, s)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    dev = gates.device
    wk = _sparse_w(w3g, bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    fw = torch.empty((T, B, 2 * H), **f32)
    s_seq = torch.empty((T, B, H), **f32)
    dg = torch.empty((T, B, 2 * H), **f32)
    qslots = torch.empty(2 * T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    BS._launch("fused_gru_sparse", "mgru_bwd_sparse_persist", dev,
               (gates.data_ptr(), wk.data_ptr(), *idx, drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), fw.data_ptr(),
                s_seq.data_ptr(), dg.data_ptr(), qslots.data_ptr()),
               (T, B, H, layout.R, layout.bs, layout.C, layout.nnz,
                _ACT_CODE[act], qbits, int(bf16), plan.grid, plan.bi,
                plan.smem))
    fused_mgru_bwd_sparse.launches += mgru_bwd_sparse_launches("persist", T,
                                                               qbits)
    return dg, s_seq


def fused_gru_bwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                         drop: torch.Tensor, h_prev: torch.Tensor,
                         dhs: torch.Tensor, layout, act: str = "tanh",
                         qbits: int = 0, bf16: bool = False):
    """Sparse GRU BPTT (TPU kernel ``_build_gru_bwd_sparse``): ``gates``
    are the forward's inputs, ``h_prev`` (T, B, H) the carries entering
    each step, ``dhs`` (T, B, H) the upstream cotangents. -> (dg
    (T, B, 3H), s (T, B, H), the candidate's recurrent inputs r * h_prev).
    CUDA tensors run the kernels on the route :func:`gru_bwd_sparse_route`
    picks before the launch: "persist" (the forward quantities of all
    steps as elementwise passes around two v3 GEMMs, then the reverse
    chain in one cooperative launch: :func:`gru_bwd_sparse_launches`) where
    the chain's blocks fit and are co-resident, else "step" (two launches
    for the forward quantities, then two per reverse step); CPU tensors
    the twin."""
    return _gru_bwd_sparse(fused_gru_bwd_sparse, 3, gates, w3g, drop, h_prev,
                           dhs, layout, act, qbits, bf16)


fused_gru_bwd_sparse.launches = 0


def fused_mgru_bwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                          drop: torch.Tensor, h_prev: torch.Tensor,
                          dhs: torch.Tensor, layout, act: str = "tanh",
                          qbits: int = 0, bf16: bool = False):
    """Sparse minimalGRU BPTT (TPU kernel ``_build_mgru_bwd_sparse``):
    ``gates`` (T, B, 2H) are the forward's inputs, ``h_prev`` and ``dhs``
    (T, B, H). -> (dg (T, B, 2H), s (T, B, H), the candidate's recurrent
    inputs z * h_prev). CUDA tensors run the kernels on the route
    :func:`mgru_bwd_sparse_route` picks before the launch: both take the
    forward quantities of all steps from the forward's two step kernels
    (the forward's bits), then "persist" runs the reverse chain in one
    cooperative launch (:func:`mgru_bwd_sparse_launches`) where its blocks
    fit and are co-resident, else "step" two launches per reverse step;
    CPU tensors the twin."""
    return _gru_bwd_sparse(fused_mgru_bwd_sparse, 2, gates, w3g, drop, h_prev,
                           dhs, layout, act, qbits, bf16)


fused_mgru_bwd_sparse.launches = 0


def _sparse_kernels(cell):
    """A cell's sparse (forward, BPTT) wrappers, looked up when called."""
    if cell == "gru":
        return fused_gru_fwd_sparse, fused_gru_bwd_sparse
    return fused_mgru_fwd_sparse, fused_mgru_bwd_sparse


def _gated_sparse_forward(ctx, cell, gates, w3g, drop, layout, act, qbits,
                          wbf16):
    """The forward rule of :class:`_FusedGRUSparse` and
    :class:`_FusedMGRUSparse`."""
    hs = _sparse_kernels(cell)[0](gates, w3g, drop, layout, act, qbits,
                                  wbf16)
    ctx.meta = (cell, layout, act, qbits, wbf16)
    ctx.save_for_backward(gates, w3g, drop, hs)
    return hs


def _gated_sparse_backward(ctx, dhs):
    """The backward rule of :class:`_FusedGRUSparse` and
    :class:`_FusedMGRUSparse`: the BPTT kernel, then dw3g as two
    block-sparse dw products over the (T*B) batch (U_h's rows over q(s),
    the others' over q(h_prev)), joined in w3g's gate order."""
    cell, layout, act, qbits, wbf16 = ctx.meta
    gates, w3g, drop, hs = ctx.saved_tensors
    T, B, H = hs.shape
    h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
    dg, s_seq = _sparse_kernels(cell)[1](gates, w3g, drop, h_prev,
                                         dhs.contiguous(), layout, act, qbits,
                                         wbf16)
    dw3g = None
    if ctx.needs_input_grad[1]:
        M, GH = T * B, dg.shape[2]
        hq, sq = ((quantize_input_per_step(v, qbits) if qbits > 0 else v)
                  .reshape(M, H) for v in (h_prev, s_seq))
        dgm = dg.reshape(M, GH)
        dw3g = torch.cat([
            sparse_dU(dgm[:, :H].contiguous(), sq, layout, 1),
            sparse_dU(dgm[:, H:].contiguous(), hq, layout, GH // H - 1)],
            dim=1)
        if wbf16:
            dw3g = bf16_round(dw3g)
    return dg, dw3g, None, None, None, None, None


class _FusedGRUSparse(torch.autograd.Function):
    """The JAX package's ``gru_scan_fused_sparse`` custom VJP over
    (gates, w3g): forward kernel, BPTT kernel, then dw3g as two
    block-sparse dw products over the (T*B) batch, joined in w3g's
    [h | z | r] row order. Under ``wbf16`` the kernels read w3g in bf16
    and dw3g is rounded to bf16 (the JAX op's primal is the bf16 w3g)."""

    @staticmethod
    def forward(ctx, gates, w3g, drop, layout, act, qbits, wbf16):
        return _gated_sparse_forward(ctx, "gru", gates, w3g, drop, layout,
                                     act, qbits, wbf16)

    backward = staticmethod(_gated_sparse_backward)


class _FusedMGRUSparse(torch.autograd.Function):
    """The JAX package's ``mgru_scan_fused_sparse`` custom VJP over
    (gates, w3g): as :class:`_FusedGRUSparse` on the minimalGRU's sparse
    kernels, dw3g in the [h | z] row order (G=1 over q(s), G=1 over
    q(h_prev))."""

    @staticmethod
    def forward(ctx, gates, w3g, drop, layout, act, qbits, wbf16):
        return _gated_sparse_forward(ctx, "mgru", gates, w3g, drop, layout,
                                     act, qbits, wbf16)

    backward = staticmethod(_gated_sparse_backward)


def _gated_scan_sparse(cell, gates_t, w3g, layout, drop_mask, act,
                       quant_bits):
    """The body of :func:`gru_scan_fused_sparse` and
    :func:`mgru_scan_fused_sparse`."""
    gates_t, w3g = gates_t.to(torch.float32), w3g.to(torch.float32)
    T, B, GH = gates_t.shape
    G = GH // layout.N
    wbf16 = sparse_scan_fits(B, layout.N, layout, G) == "bf16"
    if _needs_grad(gates_t, w3g):
        fn = _FusedGRUSparse if cell == "gru" else _FusedMGRUSparse
        return fn.apply(gates_t, w3g, drop_mask, layout, act, quant_bits,
                        wbf16)
    return _sparse_kernels(cell)[0](gates_t, w3g, drop_mask, layout, act,
                                    quant_bits, wbf16)


def gru_scan_fused_sparse(gates_t: torch.Tensor, w3g: torch.Tensor, layout,
                          drop_mask: torch.Tensor, act: str = "tanh",
                          quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from the zero state with block-sparse recurrent
    matrices U_h, U_z, U_r sharing one HCGS mask, differentiable in
    ``gates_t`` (T, B, 3H) [h | z | r] and ``w3g`` (Nb, 3*bs, R*bs)
    (``drop_mask`` is a constant). As in the JAX package it takes no
    compute dtype: the recurrence runs in float32, with w3g read in bf16
    only where :func:`sparse_scan_fits` says "bf16"."""
    return _gated_scan_sparse("gru", gates_t, w3g, layout, drop_mask, act,
                              quant_bits)


def mgru_scan_fused_sparse(gates_t: torch.Tensor, w3g: torch.Tensor, layout,
                           drop_mask: torch.Tensor, act: str = "tanh",
                           quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) of the minimalGRU from the zero state with
    block-sparse U_h, U_z sharing one HCGS mask, differentiable in
    ``gates_t`` (T, B, 2H) [h | z] and ``w3g`` (Nb, 2*bs, R*bs)
    (``drop_mask`` is a constant); float32, with w3g read in bf16 only
    where :func:`sparse_scan_fits` says "bf16" (at G=2), as in the JAX
    package. On the card the forward and the BPTT each take the route
    their wrapper picks before the launch (one cooperative launch of all
    steps, or two launches a step)."""
    return _gated_scan_sparse("mgru", gates_t, w3g, layout, drop_mask, act,
                              quant_bits)


# -- the block-sparse liGRU: TPU kernels _build_ligru_fwd_sparse and
# _build_ligru_bwd_sparse become csrc/fused_ligru_sparse.cu. U_h and U_z
# share one HCGS mask; their kept blocks pack into w3g (Nb, 2*bs, R*bs),
# each block gate-major [h | z], and the step's one product runs over the
# kept blocks only. The backward rebuilds [a_pre | z] for all steps at
# once, then runs one launch per reverse step; dU is one block-sparse dw
# product (G=2) over q(h_{t-1}).

def _ligru_sparse_fns(w3g, layout, bf16):
    """(rec_u, carry dot) of the sparse liGRU twins; w3g bf16-rounded,
    and dg rounded before the carry dot, when ``bf16``."""
    wc = bf16_round(w3g) if bf16 else w3g

    def dot(d):
        return sparse_dh(bf16_round(d) if bf16 else d, wc, layout, 2)
    return (lambda x: sparse_recurrent_u(x, wc, layout, 2)), dot


def fused_ligru_fwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                                 drop: torch.Tensor, layout,
                                 act: str = "relu", qbits: int = 0,
                                 bf16: bool = False) -> torch.Tensor:
    """Twin of the sparse liGRU forward kernel (zero initial state): a
    Python loop over :func:`ligru_cell`, q(h) rounded to bf16 before the
    product when ``bf16``. -> hs (T, B, H)."""
    T, B, G2 = gates.shape
    rec_u, _ = _ligru_sparse_fns(w3g, layout, bf16)
    h = gates.new_zeros((B, G2 // 2))
    hs = []
    for t in range(T):
        h, _ = ligru_cell(gates[t], h, rec_u, drop, ACTS[act], qbits, bf16)
        hs.append(h)
    return torch.stack(hs)


def fused_ligru_bwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                                 drop: torch.Tensor, h_prev: torch.Tensor,
                                 dhs: torch.Tensor, layout,
                                 act: str = "relu", qbits: int = 0,
                                 bf16: bool = False) -> torch.Tensor:
    """Twin of the sparse liGRU BPTT kernel: per reverse step it rebuilds
    the gates from ``h_prev`` (q per step) and runs the cotangent chain of
    JAX ``_build_ligru_bwd_sparse`` (:1358-1370; act' from the
    pre-activation, dh through the quantizer unchanged, the cotangents
    bf16-rounded before their dot when ``bf16``). -> dg (T, B, 2H)."""
    H = h_prev.shape[2]
    rec_u, dot = _ligru_sparse_fns(w3g, layout, bf16)
    actf = ACTS[act]

    def step(t, dh):
        hq = quantize_input(h_prev[t], qbits) if qbits > 0 else h_prev[t]
        g = gates[t] + rec_u(bf16_round(hq) if bf16 else hq)
        ac = g[:, :H]
        z = torch.sigmoid(g[:, H:])
        return _dgates(dh, actf(ac), z, h_prev[t], drop, dact_pre(act, ac)), z
    return _bwd_loop(step, dot, dhs, gates)


def fused_ligru_fwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                           drop: torch.Tensor, layout, act: str = "relu",
                           qbits: int = 0, bf16: bool = False
                           ) -> torch.Tensor:
    """Whole-layer liGRU forward from the zero state over the kept blocks
    of U (TPU kernel ``_build_ligru_fwd_sparse``): ``gates`` (T, B, 2H)
    float32 ordered [h | z], ``w3g`` (Nb, 2*bs, R*bs) float32 (cast to
    bf16 for the kernel when ``bf16``), ``drop`` broadcastable to (B, H).
    -> hs (T, B, H). CUDA tensors run the kernel (one launch per step),
    CPU tensors the twin; no autograd of its own
    (:func:`ligru_scan_fused_sparse` carries the BPTT kernel)."""
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act, (),
                                  gates=2)
    if _needs_grad(gates, w3g):
        raise RuntimeError("fused_ligru_fwd_sparse has no autograd of its "
                           "own: call ligru_scan_fused_sparse")
    if gates.device.type == "cpu":
        return fused_ligru_fwd_sparse_plain(gates, w3g, drop, layout, act,
                                            qbits, bf16)
    from . import _build
    lib = _build.load("fused_ligru_sparse")
    fn = lib.fused_ligru_fwd_sparse
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    wk = _sparse_w(w3g, bf16)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), qslots.data_ptr(), T, B, H,
                layout.R, layout.bs, _ACT_CODE[act], qbits, int(bf16),
                _stream(dev))
    _build.check(lib, rc, "fused_ligru_fwd_sparse")
    fused_ligru_fwd_sparse.launches += T
    return hs


fused_ligru_fwd_sparse.launches = 0


def fused_ligru_bwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                           drop: torch.Tensor, h_prev: torch.Tensor,
                           dhs: torch.Tensor, layout, act: str = "relu",
                           qbits: int = 0, bf16: bool = False
                           ) -> torch.Tensor:
    """Sparse liGRU BPTT (TPU kernel ``_build_ligru_bwd_sparse``):
    ``gates`` are the forward's inputs, ``h_prev`` (T, B, H) the carries
    entering each step, ``dhs`` (T, B, H) the upstream cotangents. -> dg
    (T, B, 2H). CUDA tensors run the kernel (one launch for the forward
    quantities of all steps, then one per reverse step), CPU tensors the
    twin."""
    seqs = (("h_prev", h_prev), ("dhs", dhs))
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act,
                                  seqs, gates=2)
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs])
    if gates.device.type == "cpu":
        return fused_ligru_bwd_sparse_plain(gates, w3g, drop, h_prev, dhs,
                                            layout, act, qbits, bf16)
    smem = 4 * 8 * layout.C * 2 * layout.bs
    if smem + _GRU_BWD_STATIC > _SMEM_MAX:
        raise ValueError("fused_ligru_bwd_sparse: %d blocks per column of "
                         "%d need %d bytes of shared memory, more than a "
                         "block has" % (layout.C, layout.bs, smem))
    from . import _build
    lib = _build.load("fused_ligru_sparse")
    fn = lib.fused_ligru_bwd_sparse
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = gates.device
    wk = _sparse_w(w3g, bf16)
    wt = wk.transpose(1, 2).contiguous()      # (Nb, R*bs, 2bs): carry dots
    f32 = dict(dtype=torch.float32, device=dev)
    fw = torch.empty((T, B, 2 * H), **f32)
    dh = torch.empty((B, H), **f32)
    dg = torch.empty((T, B, 2 * H), **f32)
    qslots = torch.empty(T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), wk.data_ptr(), wt.data_ptr(), *idx,
                drop.data_ptr(), h_prev.data_ptr(), dhs.data_ptr(),
                fw.data_ptr(), dh.data_ptr(), dg.data_ptr(),
                qslots.data_ptr(), T, B, H, layout.R, layout.bs, layout.C,
                layout.nnz, _ACT_CODE[act], qbits, int(bf16), _stream(dev))
    _build.check(lib, rc, "fused_ligru_bwd_sparse")
    fused_ligru_bwd_sparse.launches += T + 1
    return dg


fused_ligru_bwd_sparse.launches = 0


class _FusedLiGRUSparse(torch.autograd.Function):
    """The JAX package's ``ligru_scan_fused_sparse`` custom VJP over
    (gates, w3g): forward kernel, BPTT kernel, then dw3g as one
    block-sparse dw product (G=2) over the (T*B) batch with h quantized
    per step. Under ``wbf16`` the kernels read w3g in bf16 and dw3g is
    rounded to bf16 (the JAX op's primal is the bf16 w3g)."""

    @staticmethod
    def forward(ctx, gates, w3g, drop, layout, act, qbits, wbf16):
        hs = fused_ligru_fwd_sparse(gates, w3g, drop, layout, act, qbits,
                                    wbf16)
        ctx.meta = (layout, act, qbits, wbf16)
        ctx.save_for_backward(gates, w3g, drop, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        layout, act, qbits, wbf16 = ctx.meta
        gates, w3g, drop, hs = ctx.saved_tensors
        T, B, H = hs.shape
        h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
        dg = fused_ligru_bwd_sparse(gates, w3g, drop, h_prev,
                                    dhs.contiguous(), layout, act, qbits,
                                    wbf16)
        dw3g = None
        if ctx.needs_input_grad[1]:
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dw3g = sparse_dU(dg.reshape(T * B, 2 * H), hq.reshape(T * B, H),
                             layout, 2)
            if wbf16:
                dw3g = bf16_round(dw3g)
        return dg, dw3g, None, None, None, None, None


def ligru_scan_fused_sparse(gates_t: torch.Tensor, w3g: torch.Tensor, layout,
                            drop_mask: torch.Tensor, act: str = "relu",
                            quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from the zero state with block-sparse recurrent
    matrices U_h, U_z sharing one HCGS mask, differentiable in ``gates_t``
    (T, B, 2H) [h | z] and ``w3g`` (Nb, 2*bs, R*bs) (``drop_mask`` is a
    constant). As in the JAX package it takes no compute dtype: the
    recurrence runs in float32, with w3g read in bf16 only where
    :func:`sparse_scan_fits` says "bf16"."""
    gates_t, w3g = gates_t.to(torch.float32), w3g.to(torch.float32)
    T, B, G2 = gates_t.shape
    wbf16 = sparse_scan_fits(B, G2 // 2, layout, 2) == "bf16"
    if _needs_grad(gates_t, w3g):
        return _FusedLiGRUSparse.apply(gates_t, w3g, drop_mask, layout, act,
                                       quant_bits, wbf16)
    return fused_ligru_fwd_sparse(gates_t, w3g, drop_mask, layout, act,
                                  quant_bits, wbf16)


# ---------------------------------------------------------------------------
# the vanilla RNN: TPU kernels _build_rnn_fwd, _build_rnn_bwd_stash and
# _build_rnn_bwd become csrc/fused_rnn.cu. Per step t, U (H, H):
#
#     a = act(g + q(h) @ U.T)
#     h = a * drop                  dropout scales the whole state
#
# In reverse, from carry = 0 at t = T-1:
#
#     dh    = carry + dhs[t]
#     dg    = dh * drop * act'      act' from a (stash) or a_pre (recompute)
#     carry = dg @ U
#
# dU is one product over the unrolled (T*B) batch with h quantized per
# step. The stash holds a before the dropout (h / drop would divide by the
# dropped zeros). Everything is float32, as in the JAX package. The
# backward is the recompute one unless PKC_BWD_STASH_CELLS lists rnn.
# ---------------------------------------------------------------------------

def rnn_cell(g_t: torch.Tensor, h: torch.Tensor, rec_u: Callable,
             drop: torch.Tensor, actf: Callable, qbits: int,
             bf16: bool = False):
    """One RNN step (the JAX package's RNN scan step): ``rec_u(q(h))``
    gives the recurrent pre-activations (B, H), ``q`` the per-step
    quantizer with a straight-through gradient, ``q(h)`` rounded to bf16
    first when ``bf16``. -> (h, the stash a = act(...) before the
    dropout)."""
    hin = ste_quantize_input(h, qbits) if qbits > 0 else h
    if bf16:
        hin = bf16_round(hin)
    a = actf(g_t + rec_u(hin))
    return a * drop, a


def fused_rnn_fwd_plain(gates: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, h0: Optional[torch.Tensor],
                        act: str, qbits: int, stash: bool = False):
    """The forward kernel's plain twin: a Python loop over
    :func:`rnn_cell`. -> hs (T, B, H), and ``(hs, acts)`` with the stash
    a (T, B, H) when ``stash``."""
    T, B, H = gates.shape
    rec_u, actf = dense_u(U, False), ACTS[act]
    h = gates.new_zeros((B, H)) if h0 is None else h0
    hs, acts = [], []
    for t in range(T):
        h, a = rnn_cell(gates[t], h, rec_u, drop, actf, qbits)
        hs.append(h)
        acts.append(a)
    return (torch.stack(hs), torch.stack(acts)) if stash else torch.stack(hs)


def _rnn_bwd_loop(dact, U, drop, dhs):
    """Reverse-time loop shared by the RNN's BPTT twins: ``dact(t)`` is
    step t's act' (JAX ``_build_rnn_bwd_stash`` :1133-1139). -> dg
    (T, B, H)."""
    T, B, H = dhs.shape
    Uf = U.to(torch.float32)
    dg = dhs.new_empty((T, B, H))
    carry = dhs.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        dg[t] = (carry + dhs[t]) * drop * dact(t)
        carry = dg[t] @ Uf
    return dg


def fused_rnn_bwd_stash_plain(acts: torch.Tensor, U: torch.Tensor,
                              drop: torch.Tensor, dhs: torch.Tensor,
                              act: str = "tanh") -> torch.Tensor:
    """Twin of the stash BPTT kernel: reverse loop over the forward's
    stash a; act' from the activation's output. -> dg (T, B, H)."""
    dactf = DACTS_OUT[act]
    return _rnn_bwd_loop(lambda t: dactf(acts[t]), U, drop, dhs)


def fused_rnn_bwd_plain(gates: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, h_prev: torch.Tensor,
                        dhs: torch.Tensor, act: str = "tanh",
                        qbits: int = 0) -> torch.Tensor:
    """Twin of the recompute BPTT kernel: per reverse step it rebuilds
    a_pre = g + q(h_{t-1}) @ U.T (q per step), act' from a_pre. -> dg
    (T, B, H)."""
    rec_u = dense_u(U, False)

    def dact(t):
        hq = quantize_input(h_prev[t], qbits) if qbits > 0 else h_prev[t]
        return dact_pre(act, gates[t] + rec_u(hq))
    return _rnn_bwd_loop(dact, U, drop, dhs)


def _rnn_check(name, lead, U, drop, act, others, backward=None):
    """(T, B, H) float32 ``lead``, U (H, H) float32, one device,
    contiguous float32 sequences; on the card a width the forward (and
    ``backward``) kernel takes. -> (T, B, H, drop as (B, H))."""
    out = _check_common(name, lead, U, drop, act, (("U", U),) + others,
                        gates=1)
    check_dense_width("rnn", out[2], backward, lead.device)
    return out


def fused_rnn_fwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, act: str = "tanh",
                  qbits: int = 0, stash: bool = False):
    """Whole-layer RNN forward (TPU kernel ``_build_rnn_fwd``): ``gates``
    (T, B, H) float32, ``U`` (H, H) float32, ``drop`` broadcastable to
    (B, H), optional seed carry ``h0`` (B, H). -> hs (T, B, H) float32,
    and ``(hs, acts)`` with the stash a (T, B, H), the activations before
    the dropout, when ``stash``.

    CUDA tensors run the kernels on the route :func:`rnn_fwd_route` picks
    before the launch: "persist" (all steps in one cooperative launch,
    seeded or not) where the blocks fit and are co-resident, else "step"
    (a launch per step); both give the same bits. CPU tensors run the
    plain twin. This is the raw kernel call, with no autograd:
    differentiable callers use :func:`rnn_scan_fused`."""
    T, B, H, drop = _rnn_check("gates", gates, U, drop, act, (("h0", h0),))
    _check_shapes((("h0", h0, (B, H)),))
    if _needs_grad(gates, U, h0):
        raise RuntimeError("fused_rnn_fwd has no autograd of its own: call "
                           "rnn_scan_fused")
    if gates.device.type == "cpu":
        return fused_rnn_fwd_plain(gates, U, drop, h0, act, qbits, stash)
    route, plan = rnn_fwd_route(B, H, gates.device)
    if route == "persist":
        return _rnn_fwd_persist(plan, gates, U, drop, h0, act, qbits, stash)
    return _rnn_fwd_step(gates, U, drop, h0, act, qbits, stash)


def _rnn_fwd_step(gates, U, drop, h0, act, qbits, stash):
    """The forward on the step route: a kernel a step, after the
    reduction of max|h0| with a seed and the quantizer; ``launches``
    counts the step kernels."""
    T, B, H = gates.shape
    from . import _build
    lib = _build.load("fused_rnn")
    fn = lib.fused_rnn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    acts = torch.empty_like(hs) if stash else None
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), qslots.data_ptr(), T, B, H,
                _ACT_CODE[act], qbits, _stream(dev))
    _build.check(lib, rc, "fused_rnn_fwd")
    fused_rnn_fwd.launches += rnn_fwd_launches("step", T)
    return (hs, acts) if stash else hs


def _rnn_fwd_persist(plan, gates, U, drop, h0, act, qbits, stash):
    """The forward on the persistent route (``plan``: its PersistPlan,
    :func:`rnn_fwd_plan`): all T steps in one cooperative launch, h_t
    exchanged through two (B, HP) buffers picked by the step's parity
    (rows padded to a multiple of 4 floats for the 16-byte copies)."""
    from . import block_sparse as BS
    T, B, H = gates.shape
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs = torch.empty((T, B, H), **f32)
    acts = torch.empty_like(hs) if stash else None
    xh = torch.empty((2, B, gru_fwd_exchange_stride(H)), **f32)
    # each block's max|h| of the last two steps, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    BS._launch("fused_rnn", "rnn_fwd_persist_run", dev,
               (gates.data_ptr(), U.data_ptr(), drop.data_ptr(), _ptr(h0),
                hs.data_ptr(), _ptr(acts), xh.data_ptr(), bmax.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, plan.grid, plan.bi,
                plan.units, plan.smem))
    fused_rnn_fwd.launches += rnn_fwd_launches("persist", T)
    return (hs, acts) if stash else hs


fused_rnn_fwd.launches = 0


def rnn_fwd_plan(B: int, H: int, shape: Optional[tuple] = None
                 ) -> PersistPlan:
    """The dense RNN forward's persistent chain at batch B and width H
    (``shape`` forces (bi, units), one of :data:`RNN_FWD_SHAPES`; else
    :func:`_shape`): a block owns units (the last group masked where they
    do not divide H) with their H-long rows of U resident, stages per
    step q(h_{t-1}): its rows of the exchange buffer, H rounded up to 4
    floats each (``staged``), at a row stride of :func:`_row_stride` (H),
    and keeps one sum a row and unit. At the TIMIT RNN's 8 rows of 550, 8
    units x 8 rows ran 0.97-0.98 ms a call against 1.00-1.01 for 16 x 8,
    1.21-1.22 for 8 x 16 and 1.26-1.27 for 4 x 8 (two blocks an SM;
    ``chip_smoke.py --rnn-times``, NVIDIA H100 80GB HBM3 at 700 W, the
    forced shapes)."""
    bi, un = shape or _shape(B)
    bt = 8 * bi
    resident = 4 * un * H
    smem = resident + 4 * bt * _row_stride(H) + 4 * bt * un
    grid = -(-H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, 0, resident,
                       4 * min(bt, B) * gru_fwd_exchange_stride(H))


#: the RNN forward's block shapes (bi, units) that fused_rnn.cu
#: instantiates (``PK_RNN_FWD_SHAPE``): :func:`_shape`'s three and 4 and
#: 16 units at 8 rows (the forced plans ``chip_smoke.py --rnn-times``
#: times at the TIMIT shapes)
RNN_FWD_SHAPES = ((1, 4), (1, 8), (2, 8), (1, 16), (2, 16))


def rnn_fwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_rnn_fwd` at batch B and width H on
    the card ``dev``."""
    plan = rnn_fwd_plan(B, H)
    return _route(plan, "fused_rnn", "fused_rnn_fwd_occupancy",
                  (plan.bi, plan.units), torch.device(dev)), plan


def rnn_fwd_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_rnn_fwd` call launches on ``route`` (as
    its counter counts them): "persist" the one cooperative launch,
    seeded or not (a seed's scale is taken inside it); "step" one a
    step."""
    return 1 if route == "persist" else T


def rnn_bwd_plan(B: int, H: int, shape: Optional[tuple] = None
                 ) -> PersistPlan:
    """The dense RNN recompute BPTT's persistent reverse chain at batch B
    and width H (``shape`` forces (bi, units), one of
    :data:`RNN_BWD_SHAPES`; else :func:`_shape`): the forward's chain
    (:func:`rnn_fwd_plan`) run against U's columns, with the same bytes: a
    block's units' H-long columns of U resident, its rows of dg_{t+1}
    staged per reverse step from the exchange buffer (H rounded up to 4
    floats each), one sum a row and unit. At the TIMIT RNN's 8 rows of
    550, 8 units x 8 rows ran 1.076-1.085 ms a call against 1.26-1.27 for
    16 x 8, 1.31 for 8 x 16, 1.33 for 4 x 8 (two blocks an SM) and
    1.42-1.43 for 16 x 16 (``chip_smoke.py --rnn-times``, NVIDIA H100 80GB
    HBM3 at 700 W, the forced shapes)."""
    return rnn_fwd_plan(B, H, shape)


#: the RNN chain's block shapes (bi, units) that fused_rnn.cu instantiates
#: (``PK_RNN_BWD_SHAPE``): the forward's, whose plan it shares
RNN_BWD_SHAPES = RNN_FWD_SHAPES


def rnn_bwd_route(B: int, H: int, dev) -> tuple:
    """(route, plan) of :func:`fused_rnn_bwd` at batch B and width H on
    the card ``dev``."""
    plan = rnn_bwd_plan(B, H)
    return _route(plan, "fused_rnn", "fused_rnn_bwd_occupancy",
                  (plan.bi, plan.units), torch.device(dev)), plan


def rnn_bwd_launches(route: str, T: int, qbits: int) -> int:
    """Kernels one :func:`fused_rnn_bwd` call launches on ``route`` (as its
    counter counts them): "persist" the rebuild and the chain, and the
    per-step scales of q(h_prev) with the quantizer; "step" the rebuild
    and one a reverse step."""
    return 2 + int(qbits > 0) if route == "persist" else T + 1


def _rnn_bwd(wrapper, lead, U, drop, h_prev, dhs, act, qbits, stash):
    T, B, H, drop = _rnn_check("acts" if stash else "gates", lead, U, drop,
                               act, (("h_prev", h_prev), ("dhs", dhs)),
                               "stash" if stash else "recompute")
    _check_shapes((("h_prev", h_prev, (T, B, H)), ("dhs", dhs, (T, B, H))))
    if lead.device.type == "cpu":
        if stash:
            return fused_rnn_bwd_stash_plain(lead, U, drop, dhs, act)
        return fused_rnn_bwd_plain(lead, U, drop, h_prev, dhs, act, qbits)
    if not stash:
        route, plan = rnn_bwd_route(B, H, lead.device)
        if route == "persist":
            return _rnn_bwd_persist(plan, lead, U, drop, h_prev, dhs, act,
                                    qbits)
    return _rnn_bwd_step(wrapper, lead, U, drop, h_prev, dhs, act, qbits,
                         stash)


def _rnn_bwd_step(wrapper, lead, U, drop, h_prev, dhs, act, qbits, stash):
    """The BPTT on the step route: the recompute one's rebuild (after the
    per-step scales with the quantizer), then a kernel a reverse step;
    ``wrapper.launches`` counts the rebuild and the step kernels."""
    T, B, H = lead.shape
    from . import _build
    lib = _build.load("fused_rnn")
    fn = lib.fused_rnn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = lead.device
    Ut = U.t().contiguous()                  # rows for dg @ U
    pre = None if stash else torch.empty_like(lead)
    dg = torch.empty_like(lead)
    qslots = torch.empty(T if (qbits > 0 and not stash) else 1,
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(lead.data_ptr(), U.data_ptr(), Ut.data_ptr(), drop.data_ptr(),
                _ptr(h_prev), dhs.data_ptr(), _ptr(pre), dg.data_ptr(),
                qslots.data_ptr(), T, B, H, _ACT_CODE[act], qbits, int(stash),
                _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += T if stash else rnn_bwd_launches("step", T, qbits)
    return dg


def _rnn_bwd_persist(plan, gates, U, drop, h_prev, dhs, act, qbits):
    """The recompute BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`rnn_bwd_plan`): the rebuild of every step's a_pre
    (after the per-step scales with the quantizer), then the whole reverse
    chain in one cooperative launch, dg exchanged through two (B, HP)
    buffers picked by the step's parity (rows padded to a multiple of 4
    floats for the 16-byte copies)."""
    from . import block_sparse as BS
    T, B, H = gates.shape
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    pre = torch.empty((T, B, H), **f32)
    dg = torch.empty((T, B, H), **f32)
    xg = torch.empty((2, B, gru_fwd_exchange_stride(H)), **f32)
    qslots = torch.empty(T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    BS._launch("fused_rnn", "rnn_bwd_persist_run", dev,
               (gates.data_ptr(), U.data_ptr(), drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), pre.data_ptr(),
                dg.data_ptr(), xg.data_ptr(), qslots.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, plan.grid, plan.bi,
                plan.units, plan.smem))
    fused_rnn_bwd.launches += rnn_bwd_launches("persist", T, qbits)
    return dg


def fused_rnn_bwd_stash(acts: torch.Tensor, U: torch.Tensor,
                        drop: torch.Tensor, dhs: torch.Tensor,
                        act: str = "tanh") -> torch.Tensor:
    """BPTT over the stash (TPU kernel ``_build_rnn_bwd_stash``, under
    ``PKC_BWD_STASH_CELLS=rnn``): ``acts`` (T, B, H) the stash forward's
    activations before the dropout, upstream ``dhs`` (T, B, H). -> dg
    (T, B, H). CUDA tensors run the kernel (one launch per reverse step),
    CPU tensors the twin."""
    return _rnn_bwd(fused_rnn_bwd_stash, acts, U, drop, None, dhs, act, 0,
                    True)


fused_rnn_bwd_stash.launches = 0


def fused_rnn_bwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                  h_prev: torch.Tensor, dhs: torch.Tensor, act: str = "tanh",
                  qbits: int = 0) -> torch.Tensor:
    """BPTT with recompute (TPU kernel ``_build_rnn_bwd``, the default
    backward): ``gates`` are the forward's inputs, ``h_prev`` (T, B, H)
    the carries entering each step, re-quantized per step. -> as
    :func:`fused_rnn_bwd_stash`. On the card one launch rebuilds the
    pre-activations of all steps (after the per-step scales with the
    quantizer), then the reverse chain runs on the route
    :func:`rnn_bwd_route` picks before the launch: "persist" (one
    cooperative launch) where the blocks fit and are co-resident, else
    "step" (a launch per reverse step); both give the same bits."""
    return _rnn_bwd(fused_rnn_bwd, gates, U, drop, h_prev, dhs, act, qbits,
                    False)


fused_rnn_bwd.launches = 0


class _FusedRNN(torch.autograd.Function):
    """The JAX package's ``rnn_scan_fused`` custom VJP over (gates, U):
    forward kernel (stash or not), BPTT kernel, then dU as one matmul
    over the (T*B) batch with h quantized per step."""

    @staticmethod
    def forward(ctx, gates, U, drop, act, qbits):
        stash = bwd_stash_enabled("rnn")
        out = fused_rnn_fwd(gates, U, drop, act=act, qbits=qbits, stash=stash)
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
            dg = fused_rnn_bwd_stash(acts, U, drop, dhs, act)
        else:
            dg = fused_rnn_bwd(gates, U, drop, h_prev, dhs, act, qbits)
        dU = None
        if ctx.needs_input_grad[1]:
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dU = dg.reshape(T * B, H).T @ hq.reshape(T * B, H)
        return dg, dU, None, None, None


def rnn_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                   drop_mask: torch.Tensor, act: str = "tanh",
                   quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from zero initial state, differentiable in
    ``gates_t`` (T, B, H) and ``U`` (H, H) (``drop_mask`` is a constant).
    As in the JAX package it takes no compute dtype: the recurrence runs
    in float32."""
    gates_t, U = gates_t.to(torch.float32), U.to(torch.float32)
    if _needs_grad(gates_t, U):
        return _FusedRNN.apply(gates_t, U, drop_mask, act, quant_bits)
    return fused_rnn_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits)


def rnn_scan_fused_stream(gates_t: torch.Tensor, U: torch.Tensor,
                          drop_mask: torch.Tensor, h0: torch.Tensor,
                          act: str = "tanh", quant_bits: int = 0):
    """Streaming (inference-only) RNN forward seeded with the carry
    ``h0`` (B, H): -> ``(hs, hs[-1])``. Not differentiable."""
    with torch.no_grad():
        hs = fused_rnn_fwd(gates_t.to(torch.float32), U.to(torch.float32),
                           drop_mask, h0.to(torch.float32), act=act,
                           qbits=quant_bits)
    return hs, hs[-1]


# -- the block-sparse RNN: TPU kernels _build_rnn_fwd_sparse and
# _build_rnn_bwd_sparse become csrc/fused_rnn_sparse.cu. U's kept blocks
# pack into w3g (Nb, bs, R*bs) and the step's product runs over them only.
# The backward rebuilds a_pre for all steps at once, then runs the
# reverse chain, the carry dg @ U gathered per block column; each picks a
# route before the launch: one cooperative launch for all steps where the
# blocks fit and are co-resident, else a launch a step. dU is one
# block-sparse dw product (G=1) over q(h_{t-1}). As in the JAX package
# there is no stash variant.

def _rnn_sparse_fns(w3g, layout, bf16):
    """(rec_u, carry dot) of the sparse RNN twins; w3g bf16-rounded, and
    dg rounded before the carry dot, when ``bf16``."""
    wc = bf16_round(w3g) if bf16 else w3g

    def dot(d):
        return sparse_dh(bf16_round(d) if bf16 else d, wc, layout, 1)
    return (lambda x: sparse_recurrent_u(x, wc, layout, 1)), dot


def fused_rnn_fwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                               drop: torch.Tensor, layout, act: str = "tanh",
                               qbits: int = 0, bf16: bool = False
                               ) -> torch.Tensor:
    """Twin of the sparse RNN forward kernel (zero initial state): a
    Python loop over :func:`rnn_cell`, q(h) rounded to bf16 before the
    product when ``bf16``. -> hs (T, B, H)."""
    T, B, H = gates.shape
    rec_u, _ = _rnn_sparse_fns(w3g, layout, bf16)
    h = gates.new_zeros((B, H))
    hs = []
    for t in range(T):
        h, _ = rnn_cell(gates[t], h, rec_u, drop, ACTS[act], qbits, bf16)
        hs.append(h)
    return torch.stack(hs)


def fused_rnn_bwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                               drop: torch.Tensor, h_prev: torch.Tensor,
                               dhs: torch.Tensor, layout, act: str = "tanh",
                               qbits: int = 0, bf16: bool = False
                               ) -> torch.Tensor:
    """Twin of the sparse RNN BPTT kernel: per reverse step it rebuilds
    a_pre = g + q(h_{t-1}) @ U_kept.T (q per step, bf16-rounded before
    the product when ``bf16``), then dg = (carry + dhs[t]) * drop *
    act'(a_pre) and carry = dg @ U_kept (JAX ``_build_rnn_bwd_sparse``
    :1833-1842; dg rounded before the carry dot when ``bf16``). -> dg
    (T, B, H)."""
    rec_u, dot = _rnn_sparse_fns(w3g, layout, bf16)
    dg = dhs.new_empty(dhs.shape)
    carry = torch.zeros_like(dhs[0])
    for t in range(dhs.shape[0] - 1, -1, -1):
        hq = quantize_input(h_prev[t], qbits) if qbits > 0 else h_prev[t]
        a_pre = gates[t] + rec_u(bf16_round(hq) if bf16 else hq)
        dg[t] = (carry + dhs[t]) * drop * dact_pre(act, a_pre)
        carry = dot(dg[t])
    return dg


def fused_rnn_fwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                         drop: torch.Tensor, layout, act: str = "tanh",
                         qbits: int = 0, bf16: bool = False) -> torch.Tensor:
    """Whole-layer RNN forward from the zero state over the kept blocks
    of U (TPU kernel ``_build_rnn_fwd_sparse``): ``gates`` (T, B, H)
    float32, ``w3g`` (Nb, bs, R*bs) float32 (cast to bf16 for the kernel
    when ``bf16``), ``drop`` broadcastable to (B, H). -> hs (T, B, H).
    CUDA tensors run the kernels on the route :func:`rnn_fwd_sparse_route`
    picks before the launch: "persist" (all steps in one cooperative
    launch) where the blocks fit and are co-resident, else "step" (a
    launch per step); both give the same bits. CPU tensors run the twin;
    no autograd of its own (:func:`rnn_scan_fused_sparse` carries the
    BPTT kernel)."""
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act, (),
                                  gates=1)
    if _needs_grad(gates, w3g):
        raise RuntimeError("fused_rnn_fwd_sparse has no autograd of its "
                           "own: call rnn_scan_fused_sparse")
    if gates.device.type == "cpu":
        return fused_rnn_fwd_sparse_plain(gates, w3g, drop, layout, act,
                                          qbits, bf16)
    route, plan = rnn_fwd_sparse_route(B, layout, bf16, gates.device)
    if route == "persist":
        return _rnn_fwd_sparse_persist(plan, gates, w3g, drop, layout, act,
                                       qbits, bf16)
    return _rnn_fwd_sparse_step(gates, w3g, drop, layout, act, qbits, bf16)


def _rnn_fwd_sparse_step(gates, w3g, drop, layout, act, qbits, bf16):
    """The sparse forward (checked operands, ``drop`` (B, H)) on the step
    route: a launch a step. -> hs (T, B, H)."""
    from . import block_sparse as BS
    T, B, H = gates.shape
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    wk = _sparse_w(w3g, bf16)
    BS._launch("fused_rnn_sparse", "fused_rnn_fwd_sparse", dev,
               (gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), qslots.data_ptr()),
               (T, B, H, layout.R, layout.bs, _ACT_CODE[act], qbits,
                int(bf16)))
    fused_rnn_fwd_sparse.launches += rnn_fwd_sparse_launches("step", T)
    return hs


def _rnn_fwd_sparse_persist(plan, gates, w3g, drop, layout, act, qbits,
                            bf16):
    """The sparse forward on the persistent route (``plan``: its
    PersistPlan, :func:`rnn_fwd_sparse_plan`): all T steps in one
    cooperative launch. -> hs (T, B, H)."""
    from . import block_sparse as BS
    T, B, H = gates.shape
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    # each block's max|h| of the last two steps, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    wk = _sparse_w(w3g, bf16)
    BS._launch("fused_rnn_sparse", "rnn_fwd_sparse_persist", dev,
               (gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), bmax.data_ptr()),
               (T, B, H, layout.R, layout.bs, _ACT_CODE[act], qbits,
                int(bf16), plan.grid, plan.bi, plan.units, plan.smem))
    fused_rnn_fwd_sparse.launches += rnn_fwd_sparse_launches("persist", T)
    return hs


fused_rnn_fwd_sparse.launches = 0


def _rnn_sparse_plan(B: int, H: int, bs: int, K: int, static: int,
                     shape: Optional[tuple]) -> PersistPlan:
    """A sparse RNN chain at batch B, width H and block size bs whose
    block keeps its units' K-long weight rows resident as rows (the step
    kernels' dot order, no padding), stages K values a row per step (at a
    stride of :func:`_row_stride` (K)) and keeps one sum a row and unit:
    ``shape`` (bi, units) forced, else :func:`_shape`, 16 units only where
    bs holds them."""
    bi, un = shape or _shape(B, WIDE_SHAPE if bs % 16 == 0 else (4, 8))
    bt = 8 * bi
    resident = 4 * un * K
    smem = resident + 4 * bt * _row_stride(K) + 4 * bt * un
    grid = (H // un) * -(-B // bt)
    return PersistPlan(bi, un, grid, smem, static, resident,
                       4 * min(bt, B) * K)


def rnn_fwd_sparse_plan(B: int, layout, shape: Optional[tuple] = None
                        ) -> PersistPlan:
    """The sparse RNN forward's persistent chain at batch B over
    ``layout`` (``shape`` forces (bi, units), one of
    :data:`RNN_FWD_SPARSE_SHAPES`; :func:`_rnn_sparse_plan`): a block owns
    units of one out-block with their R*bs-long rows of w3g resident and
    stages q(h_{t-1}) at the out-block's R kept column blocks per step."""
    return _rnn_sparse_plan(B, layout.N, layout.bs, layout.R * layout.bs, 0,
                            shape)


#: the sparse RNN forward's block shapes (bi, units) that
#: fused_rnn_sparse.cu instantiates (``PK_RNN_SPARSE_FWD_SHAPE``): the
#: plan's
RNN_FWD_SPARSE_SHAPES = ((1, 8), (2, 8), (4, 8), (2, 16))


def rnn_fwd_sparse_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_rnn_fwd_sparse` at batch B over
    ``layout`` on the card ``dev``: "step" where the block's units do not
    divide bs."""
    plan = rnn_fwd_sparse_plan(B, layout)
    if layout.bs % plan.units:
        return "step", plan
    return _route(plan, "fused_rnn_sparse", "rnn_fwd_sparse_occupancy",
                  (int(bf16), plan.bi, plan.units), torch.device(dev)), plan


def rnn_fwd_sparse_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_rnn_fwd_sparse` call launches on
    ``route`` (as its counter counts them): "persist" the one cooperative
    launch, "step" one a step."""
    return 1 if route == "persist" else T


def rnn_bwd_sparse_plan(B: int, H: int, bs: int, C: int,
                        shape: Optional[tuple] = None) -> PersistPlan:
    """The sparse RNN BPTT's persistent reverse chain at batch B, width H,
    block size bs and at most C kept blocks in a block column (``shape``
    forces (bi, units), one of :data:`RNN_BWD_SPARSE_SHAPES`;
    :func:`_rnn_sparse_plan`): a block owns units of one block column
    with their columns of U at each of the column's entries resident as
    rows (C*bs floats a unit at most) and stages dg_{t+1} at the entries'
    out-blocks per reverse step; its static shared memory holds the
    column's entry lists."""
    return _rnn_sparse_plan(B, H, bs, C * bs, _PERSIST_SPARSE_STATIC, shape)


#: the sparse RNN chain's block shapes (bi, units) that
#: fused_rnn_sparse.cu instantiates (``PK_RNN_SPARSE_BWD_SHAPE``): the
#: forward's, whose plan it shares
RNN_BWD_SPARSE_SHAPES = RNN_FWD_SPARSE_SHAPES


def rnn_sparse_rebuild_smem(layout) -> int:
    """Dynamic shared memory of a block of the sparse RNN BPTT's rebuild
    (``rnn_sparse_rebuild``): 16 resident rows of w3g (R*bs floats each),
    32 staged rows of the unrolled batch at a stride of
    :func:`_row_stride` (R*bs), and their sums."""
    K3 = layout.R * layout.bs
    return 4 * (16 * K3 + 32 * _row_stride(K3) + 32 * 16)


def rnn_bwd_sparse_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_rnn_bwd_sparse` at batch B over
    ``layout`` on the card ``dev``: "step" where bs is not a multiple of
    32 (the chain's sums are the step kernel's only then) or of the
    block's units, or the rebuild's block does not fit."""
    plan = rnn_bwd_sparse_plan(B, layout.N, layout.bs, layout.C)
    if layout.bs % 32 or layout.bs % plan.units or \
            rnn_sparse_rebuild_smem(layout) > _SMEM_MAX:
        return "step", plan
    return _route(plan, "fused_rnn_sparse", "rnn_bwd_sparse_occupancy",
                  (int(bf16), plan.bi, plan.units), torch.device(dev)), plan


def rnn_bwd_sparse_launches(route: str, T: int, qbits: int) -> int:
    """Kernels one :func:`fused_rnn_bwd_sparse` call launches on ``route``
    (as its counter counts them): "persist" the rebuild and the chain,
    and with the quantizer the per-step scales and q(h_prev); "step" the
    rebuild and one a reverse step."""
    return 2 + 2 * int(qbits > 0) if route == "persist" else T + 1


def fused_rnn_bwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                         drop: torch.Tensor, h_prev: torch.Tensor,
                         dhs: torch.Tensor, layout, act: str = "tanh",
                         qbits: int = 0, bf16: bool = False) -> torch.Tensor:
    """Sparse RNN BPTT (TPU kernel ``_build_rnn_bwd_sparse``): ``gates``
    are the forward's inputs, ``h_prev`` (T, B, H) the carries entering
    each step, ``dhs`` (T, B, H) the upstream cotangents. -> dg
    (T, B, H). CUDA tensors run the kernels on the route
    :func:`rnn_bwd_sparse_route` picks before the launch: "persist" (the
    pre-activations of all steps rebuilt in the forward's order, then the
    reverse chain in one cooperative launch), else "step" (the rebuild,
    then one launch per reverse step); both give the same bits. CPU
    tensors run the twin."""
    seqs = (("h_prev", h_prev), ("dhs", dhs))
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act,
                                  seqs, gates=1)
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs])
    if gates.device.type == "cpu":
        return fused_rnn_bwd_sparse_plain(gates, w3g, drop, h_prev, dhs,
                                          layout, act, qbits, bf16)
    route, plan = rnn_bwd_sparse_route(B, layout, bf16, gates.device)
    if route == "persist":
        return _rnn_bwd_sparse_persist(plan, gates, w3g, drop, h_prev, dhs,
                                       layout, act, qbits, bf16)
    return _rnn_bwd_sparse_step(gates, w3g, drop, h_prev, dhs, layout, act,
                                qbits, bf16)


def _rnn_bwd_sparse_step(gates, w3g, drop, h_prev, dhs, layout, act, qbits,
                         bf16, with_pre=False):
    """The sparse BPTT (checked operands, ``drop`` (B, H)) on the step
    route: the rebuild of every step's a_pre, then a launch a reverse
    step. -> dg (T, B, H), and with ``with_pre`` (dg, a_pre)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    smem = 4 * 8 * layout.C * layout.bs
    if smem + _GRU_BWD_STATIC > _SMEM_MAX:
        raise ValueError("fused_rnn_bwd_sparse: %d blocks per column of %d "
                         "need %d bytes of shared memory, more than a block "
                         "has" % (layout.C, layout.bs, smem))
    dev = gates.device
    wk = _sparse_w(w3g, bf16)
    wt = wk.transpose(1, 2).contiguous()      # (Nb, R*bs, bs): carry dots
    pre = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    dg = torch.empty_like(pre)
    qslots = torch.empty(T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    BS._launch("fused_rnn_sparse", "fused_rnn_bwd_sparse", dev,
               (gates.data_ptr(), wk.data_ptr(), wt.data_ptr(), *idx,
                drop.data_ptr(), h_prev.data_ptr(), dhs.data_ptr(),
                pre.data_ptr(), dg.data_ptr(), qslots.data_ptr()),
               (T, B, H, layout.R, layout.bs, layout.C, layout.nnz,
                _ACT_CODE[act], qbits, int(bf16)))
    fused_rnn_bwd_sparse.launches += rnn_bwd_sparse_launches("step", T,
                                                             qbits)
    return (dg, pre) if with_pre else dg


def _rnn_bwd_sparse_persist(plan, gates, w3g, drop, h_prev, dhs, layout,
                            act, qbits, bf16, with_pre=False):
    """The sparse BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`rnn_bwd_sparse_plan`): with the quantizer the
    per-step scales and q(h_prev), the rebuild of every step's a_pre in
    the forward's order, then the whole reverse chain in one cooperative
    launch, all from one entry point. -> dg (T, B, H), and with
    ``with_pre`` (dg, a_pre)."""
    from . import block_sparse as BS
    T, B, H = h_prev.shape
    dev = gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    pre = torch.empty((T, B, H), **f32)
    dg = torch.empty((T, B, H), **f32)
    qh = torch.empty((T, B, H), **f32) if qbits > 0 else pre
    qslots = torch.empty(T if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    wk = _sparse_w(w3g, bf16)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    BS._launch("fused_rnn_sparse", "rnn_bwd_sparse_persist", dev,
               (gates.data_ptr(), wk.data_ptr(), *idx, drop.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), qh.data_ptr(),
                pre.data_ptr(), dg.data_ptr(), qslots.data_ptr()),
               (T, B, H, layout.R, layout.bs, layout.C, layout.nnz,
                _ACT_CODE[act], qbits, int(bf16), plan.grid, plan.bi,
                plan.units, plan.smem))
    fused_rnn_bwd_sparse.launches += rnn_bwd_sparse_launches("persist", T,
                                                             qbits)
    return (dg, pre) if with_pre else dg


fused_rnn_bwd_sparse.launches = 0


class _FusedRNNSparse(torch.autograd.Function):
    """The JAX package's ``rnn_scan_fused_sparse`` custom VJP over
    (gates, w3g): forward kernel, BPTT kernel, then dw3g as one
    block-sparse dw product (G=1) over the (T*B) batch with h quantized
    per step. Under ``wbf16`` the kernels read w3g in bf16 and dw3g is
    rounded to bf16 (the JAX op's primal is the bf16 w3g)."""

    @staticmethod
    def forward(ctx, gates, w3g, drop, layout, act, qbits, wbf16):
        hs = fused_rnn_fwd_sparse(gates, w3g, drop, layout, act, qbits,
                                  wbf16)
        ctx.meta = (layout, act, qbits, wbf16)
        ctx.save_for_backward(gates, w3g, drop, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        layout, act, qbits, wbf16 = ctx.meta
        gates, w3g, drop, hs = ctx.saved_tensors
        T, B, H = hs.shape
        h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
        dg = fused_rnn_bwd_sparse(gates, w3g, drop, h_prev, dhs.contiguous(),
                                  layout, act, qbits, wbf16)
        dw3g = None
        if ctx.needs_input_grad[1]:
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dw3g = sparse_dU(dg.reshape(T * B, H), hq.reshape(T * B, H),
                             layout, 1)
            if wbf16:
                dw3g = bf16_round(dw3g)
        return dg, dw3g, None, None, None, None, None


def rnn_scan_fused_sparse(gates_t: torch.Tensor, w3g: torch.Tensor, layout,
                          drop_mask: torch.Tensor, act: str = "tanh",
                          quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from the zero state with a block-sparse recurrent
    matrix, differentiable in ``gates_t`` (T, B, H) and ``w3g``
    (Nb, bs, R*bs) (``drop_mask`` is a constant). As in the JAX package
    it takes no compute dtype: the recurrence runs in float32, with w3g
    read in bf16 only where :func:`sparse_scan_fits` says "bf16"."""
    gates_t, w3g = gates_t.to(torch.float32), w3g.to(torch.float32)
    T, B, H = gates_t.shape
    wbf16 = sparse_scan_fits(B, H, layout, 1) == "bf16"
    if _needs_grad(gates_t, w3g):
        return _FusedRNNSparse.apply(gates_t, w3g, drop_mask, layout, act,
                                     quant_bits, wbf16)
    return fused_rnn_fwd_sparse(gates_t, w3g, drop_mask, layout, act,
                                quant_bits, wbf16)


# ---------------------------------------------------------------------------
# the torch-semantics GRU of the GRU_cudnn wrapper (torch's nn.GRU): TPU
# kernels _build_gru_torch_fwd and _build_gru_torch_bwd become
# csrc/fused_gru_torch.cu. Gates (T, B, 3H) = x @ W_ih.T + b_ih in torch's
# order [r | z | n], W_hh (3H, H), b_hh (3H,). The reset gate multiplies
# the already projected candidate, so a step is one product:
#
#     u    = h @ W_hh.T + b_hh
#     r, z = sigmoid(g_rz + u_rz)
#     n    = tanh(g_n + r * u_n)
#     h    = (1 - z) * n + z * h
#
# In reverse, from dh_carry = 0 at t = T-1:
#
#     dh   = dh_carry + dhs[t]
#     da_n = dh * (1 - z) * (1 - n^2),   dm = da_n * r
#     da_r = da_n * u_n * r (1 - r),     da_z = dh * (h_{t-1} - n) * z (1 - z)
#     dh_carry = dh * z + [da_r | da_z | dm] @ W_hh
#
# The kernels emit dg = [da_r | da_z | da_n] and dm; dW_hh and db_hh are
# one product and one sum over the unrolled (T*B) batch outside, as in the
# JAX package. No dropout, no quantizer; everything is float32.
# ---------------------------------------------------------------------------

def gru_torch_cell(g_t: torch.Tensor, h: torch.Tensor, W_hh: torch.Tensor,
                   b_hh: torch.Tensor):
    """One torch-semantics GRU step. -> (h_t, u = h @ W_hh.T + b_hh)."""
    H = h.shape[-1]
    u = h @ W_hh.T + b_hh
    r = torch.sigmoid(g_t[:, :H] + u[:, :H])
    z = torch.sigmoid(g_t[:, H:2 * H] + u[:, H:2 * H])
    n = torch.tanh(g_t[:, 2 * H:] + r * u[:, 2 * H:])
    return (1.0 - z) * n + z * h, u


def fused_gru_torch_fwd_plain(gates: torch.Tensor, W_hh: torch.Tensor,
                              b_hh: torch.Tensor,
                              h0: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The forward kernel's plain twin: a Python loop over
    :func:`gru_torch_cell`. -> hs (T, B, H)."""
    T, B, G3 = gates.shape
    h = gates.new_zeros((B, G3 // 3)) if h0 is None else h0
    hs = []
    for t in range(T):
        h, _ = gru_torch_cell(gates[t], h, W_hh, b_hh)
        hs.append(h)
    return torch.stack(hs)


def fused_gru_torch_bwd_plain(gates: torch.Tensor, W_hh: torch.Tensor,
                              b_hh: torch.Tensor, h_prev: torch.Tensor,
                              dhs: torch.Tensor):
    """Twin of the BPTT kernel (JAX ``_build_gru_torch_bwd`` :675-689):
    per reverse step it rebuilds u from ``h_prev``. -> (dg (T, B, 3H)
    [da_r | da_z | da_n], dm (T, B, H))."""
    T, B, H = h_prev.shape
    dg = gates.new_empty((T, B, 3 * H))
    dm = gates.new_empty((T, B, H))
    dh_carry = gates.new_zeros((B, H))
    for t in range(T - 1, -1, -1):
        hp, g = h_prev[t], gates[t]
        u = hp @ W_hh.T + b_hh
        r = torch.sigmoid(g[:, :H] + u[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + u[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * u[:, 2 * H:])
        dh = dh_carry + dhs[t]
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        dm[t] = da_n * r
        dg[t] = torch.cat([da_n * u[:, 2 * H:] * r * (1.0 - r),
                           dh * (hp - n) * z * (1.0 - z), da_n], dim=1)
        du = torch.cat([dg[t, :, :2 * H], dm[t]], dim=1)
        dh_carry = dh * z + du @ W_hh
    return dg, dm


def _gru_torch_check(gates, W_hh, b_hh, seqs, backward=None):
    """(T, B, 3H) float32 ``gates``, W_hh (3H, H), b_hh (3H,) and the
    ``seqs`` (name, tensor or None), all float32 on one device,
    contiguous on the card, and a width whose staged rows fit a block's
    shared memory there. -> (T, B, H)."""
    if gates.ndim != 3 or gates.shape[2] % 3:
        raise ValueError("gates must be (T, B, 3H), got %s"
                         % (tuple(gates.shape),))
    T, B, G3 = gates.shape
    H = G3 // 3
    _check_shapes((("W_hh", W_hh, (G3, H)), ("b_hh", b_hh, (G3,))))
    dev = gates.device
    for n, t in (("gates", gates), ("W_hh", W_hh), ("b_hh", b_hh)) + seqs:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("%s on %s, gates on %s" % (n, t.device, dev))
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" % (n, t.dtype))
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError("%s must be contiguous" % n)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    check_dense_width("gru_torch", H, backward, dev)
    return T, B, H


def fused_gru_torch_fwd(gates: torch.Tensor, W_hh: torch.Tensor,
                        b_hh: torch.Tensor, h0: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Whole-layer torch-semantics GRU forward (TPU kernel
    ``_build_gru_torch_fwd``; the seeded carry ``h0`` (B, H) for
    streaming): ``gates`` (T, B, 3H) float32 [r | z | n], ``W_hh`` (3H,
    H), ``b_hh`` (3H,). -> hs (T, B, H). CUDA tensors run the kernel (one
    launch per step), CPU tensors the twin. No autograd of its own:
    differentiable callers use :func:`gru_cudnn_scan_fused`."""
    T, B, H = _gru_torch_check(gates, W_hh, b_hh, (("h0", h0),))
    _check_shapes((("h0", h0, (B, H)),))
    if _needs_grad(gates, W_hh, b_hh, h0):
        raise RuntimeError("fused_gru_torch_fwd has no autograd of its own: "
                           "call gru_cudnn_scan_fused")
    if gates.device.type == "cpu":
        return fused_gru_torch_fwd_plain(gates, W_hh, b_hh, h0)
    from . import _build
    lib = _build.load("fused_gru_torch")
    fn = lib.fused_gru_torch_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), W_hh.data_ptr(), b_hh.data_ptr(), _ptr(h0),
                hs.data_ptr(), T, B, H, _stream(dev))
    _build.check(lib, rc, "fused_gru_torch_fwd")
    fused_gru_torch_fwd.launches += T
    return hs


fused_gru_torch_fwd.launches = 0


def fused_gru_torch_bwd(gates: torch.Tensor, W_hh: torch.Tensor,
                        b_hh: torch.Tensor, h_prev: torch.Tensor,
                        dhs: torch.Tensor):
    """Torch-semantics GRU BPTT (TPU kernel ``_build_gru_torch_bwd``):
    ``gates`` are the forward's inputs, ``h_prev`` (T, B, H) the carries
    entering each step, ``dhs`` (T, B, H) the upstream cotangents. ->
    (dg (T, B, 3H) [da_r | da_z | da_n], dm (T, B, H) the cotangent of
    u_n). CUDA tensors run the kernels on the route
    :func:`gru_torch_bwd_route` picks before the launch: one launch
    rebuilds u for all steps, then "persist" runs the reverse chain in one
    cooperative launch where its blocks fit and are co-resident, "step"
    one launch per reverse step; CPU tensors the twin."""
    T, B, H = _gru_torch_check(gates, W_hh, b_hh, (("h_prev", h_prev),
                                                    ("dhs", dhs)), "recompute")
    _check_shapes((("h_prev", h_prev, (T, B, H)), ("dhs", dhs, (T, B, H))))
    if gates.device.type == "cpu":
        return fused_gru_torch_bwd_plain(gates, W_hh, b_hh, h_prev, dhs)
    from . import _build
    lib = _build.load("fused_gru_torch")
    fn = lib.fused_gru_torch_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = gates.device
    route, plan = gru_torch_bwd_route(B, H, dev)
    persist = route == "persist"
    f32 = dict(dtype=torch.float32, device=dev)
    Wt = W_hh.t().contiguous()      # (H, 3H): the rebuild's B, step rows
    u = torch.empty((T, B, 3 * H), **f32)
    dh = None if persist else torch.empty((B, H), **f32)
    xbuf = torch.empty((2, B, -(-3 * H // 8) * 8), **f32) if persist else None
    dg = torch.empty((T, B, 3 * H), **f32)
    dm = torch.empty((T, B, H), **f32)
    with torch.cuda.device(dev):
        rc = fn(gates.data_ptr(), W_hh.data_ptr(), _ptr(Wt), b_hh.data_ptr(),
                h_prev.data_ptr(), dhs.data_ptr(), u.data_ptr(), _ptr(dh),
                _ptr(xbuf), dg.data_ptr(), dm.data_ptr(), T, B, H,
                plan.grid if persist else 0, plan.bi, plan.smem, _stream(dev))
    _build.check(lib, rc, "fused_gru_torch_bwd")
    fused_gru_torch_bwd.launches += 2 if persist else T + 1
    return dg, dm


fused_gru_torch_bwd.launches = 0


class _FusedGRUTorch(torch.autograd.Function):
    """The JAX package's ``gru_cudnn_scan_fused`` custom VJP over (gates,
    W_hh, b_hh): forward kernel, BPTT kernel, then dW_hh as one matmul and
    db_hh as one sum over the (T*B) batch of du = [da_r | da_z | dm]."""

    @staticmethod
    def forward(ctx, gates, W_hh, b_hh):
        hs = fused_gru_torch_fwd(gates, W_hh, b_hh)
        ctx.save_for_backward(gates, W_hh, b_hh, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        gates, W_hh, b_hh, hs = ctx.saved_tensors
        T, B, H = hs.shape
        M = T * B
        h_prev = torch.cat([hs.new_zeros((1, B, H)), hs[:-1]])
        dg, dm = fused_gru_torch_bwd(gates, W_hh, b_hh, h_prev,
                                     dhs.contiguous())
        du = torch.cat([dg[..., :2 * H], dm], dim=-1).reshape(M, 3 * H)
        dW = du.T @ h_prev.reshape(M, H) if ctx.needs_input_grad[1] else None
        db = du.sum(0) if ctx.needs_input_grad[2] else None
        return dg, dW, db


def _b_hh(b_hh, like):
    """b_hh as a float32 (3H,) tensor; None gives zeros (no bias)."""
    if b_hh is None:
        return like.new_zeros((like.shape[-1],), dtype=torch.float32)
    return b_hh.to(torch.float32)


def gru_cudnn_scan_fused(gates_t: torch.Tensor, W_hh: torch.Tensor,
                         b_hh: Optional[torch.Tensor]) -> torch.Tensor:
    """hs (T, B, H) of the torch-semantics GRU from the zero state:
    ``gates_t`` (T, B, 3H) = x @ W_ih.T + b_ih in torch's order [r | z |
    n], ``W_hh`` (3H, H), ``b_hh`` (3H,) or None (no bias),
    differentiable in all three. The recurrence runs in float32."""
    gates_t, W_hh = gates_t.to(torch.float32), W_hh.to(torch.float32)
    b_hh = _b_hh(b_hh, gates_t)
    if _needs_grad(gates_t, W_hh, b_hh):
        return _FusedGRUTorch.apply(gates_t, W_hh, b_hh)
    return fused_gru_torch_fwd(gates_t, W_hh, b_hh)


def gru_cudnn_scan_fused_stream(gates_t: torch.Tensor, W_hh: torch.Tensor,
                                b_hh: Optional[torch.Tensor],
                                h0: torch.Tensor):
    """Streaming (inference-only) torch-semantics GRU forward seeded with
    the carry ``h0`` (B, H): -> ``(hs, hs[-1])``. Not differentiable."""
    with torch.no_grad():
        hs = fused_gru_torch_fwd(gates_t.to(torch.float32),
                                 W_hh.to(torch.float32),
                                 _b_hh(b_hh, gates_t), h0.to(torch.float32))
    return hs, hs[-1]
