"""Fused LSTM recurrence: the whole layer's time loop, forward and BPTT.

Port of ``pytorch_kaldi_cgs_tpu/ops/fused_lstm.py``. Six TPU kernels
become CUDA kernels for ``sm_90a``, each with a plain PyTorch twin that
repeats its arithmetic and is what the CPU runs:

- ``_build_fwd`` (``stash`` included): ``csrc/fused_lstm_fwd.cu``,
  :func:`fused_lstm_fwd` / :func:`fused_lstm_fwd_plain`;
- ``_build_bwd_stash``: ``csrc/fused_lstm_bwd.cu``,
  :func:`fused_lstm_bwd_stash` / :func:`fused_lstm_bwd_stash_plain`;
- ``_build_bwd``: ``csrc/fused_lstm_bwd.cu``,
  :func:`fused_lstm_bwd` / :func:`fused_lstm_bwd_plain`;
- the block-sparse recurrence over the kept HCGS blocks of U (w3g
  layout, ``ops.block_sparse``): ``_build_fwd_sparse``,
  ``_build_bwd_sparse_stash`` and ``_build_bwd_sparse`` in
  ``csrc/fused_lstm_sparse.cu``, :func:`fused_lstm_fwd_sparse`,
  :func:`fused_lstm_bwd_sparse_stash`, :func:`fused_lstm_bwd_sparse` and
  their ``*_plain`` twins, behind :func:`lstm_scan_fused_sparse` with
  :func:`sparse_dU` on the block-sparse dw kernel.

A wrapper launches its kernel on a CUDA tensor (or raises) and runs its
twin on a CPU tensor; its attribute ``launches`` counts kernel launches
(one per time step, plus one for the ``dh0`` dot of a seeded backward).
The dense forward and the stash BPTT pick their route before the launch
(:func:`lstm_fwd_route`, :func:`lstm_bwd_stash_route`): "persist", the
whole call as ONE cooperative launch (``csrc/persist.cuh``; counted
once), where a plan's block fits shared memory and its grid is
co-resident; else "step", a launch per step.

:func:`lstm_scan_fused` (zero initial state) and
:func:`lstm_scan_fused_seeded` (seeded carry, returns the final state)
are the differentiable entry points: a ``torch.autograd.Function`` whose
forward runs the forward kernel and whose backward runs one of the two
BPTT kernels, then ``dU`` as ONE matmul over the unrolled (T*B) batch,
as the JAX package's custom VJPs do. The backward is the stashed-
activation one unless ``PKC_LSTM_BWD_RECOMPUTE=1`` (or
``PKC_BWD_STASH_CELLS`` without ``lstm``), the JAX package's knobs.

Per step t, gate order (f, i, o, c):

    u = q(h) @ U.T
    f, i, o = sigmoid(g_t + u)
    c = i * act(g_c + u_c) * drop + f * c
    h = o * act(c)

``q`` is the per-step recurrent-input quantizer (scale max|h| over the
step's (B, H) block) with a straight-through gradient; bf16 rounds U
and q(h) (forward) or dg (backward) to bf16 before each dot, with
float32 products, sums, carries and gate math.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Optional, Tuple

import torch

from ..sparsity.quantize import (bf16_round, quantize_input,
                                 quantize_input_per_step, ste_quantize_input)
from .block_sparse import block_sparse_dw, gather_cols

ACTS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "htanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "linear": lambda x: x,
}
_ACT_CODE = {"tanh": 0, "relu": 1, "htanh": 2, "linear": 3}

# act'(x) from the activation's OUTPUT y = act(x) (stash backward) ...
DACTS_OUT = {
    "tanh": lambda y: 1.0 - y * y,
    "relu": lambda y: (y > 0).to(y.dtype),
    "htanh": lambda y: ((y > -1.0) & (y < 1.0)).to(y.dtype),
    "linear": torch.ones_like,
}


def dact_pre(act: str, x: torch.Tensor) -> torch.Tensor:
    """... and from the PRE-activation x (recompute backward)."""
    if act == "tanh":
        t = torch.tanh(x)
        return 1.0 - t * t
    if act in ("relu", "htanh", "linear"):
        return DACTS_OUT[act](x)
    raise ValueError(act)


#: Which cells default to the stashed-activation backward (the JAX
#: package's ``_STASH_DEFAULT``, for the cells ported so far).
_STASH_DEFAULT = {"lstm": True, "gru": True, "ligru": False,
                  "rnn": False, "mgru": False}


def bwd_stash_enabled(cell: str = "lstm") -> bool:
    """The JAX package's ``_bwd_stash_enabled``: the per-cell default,
    ``PKC_LSTM_BWD_RECOMPUTE=1`` forces the recompute backward,
    ``PKC_BWD_STASH_CELLS=lstm,...`` forces stash for exactly the
    listed cells."""
    if os.environ.get("PKC_LSTM_BWD_RECOMPUTE", "") == "1":
        return False
    forced = os.environ.get("PKC_BWD_STASH_CELLS", "")
    if forced:
        return cell in [c.strip() for c in forced.split(",")]
    return _STASH_DEFAULT.get(cell, False)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def dense_u(U: torch.Tensor, bf16: bool) -> Callable:
    """The dense recurrent product ``hin -> hin @ U.T`` (U bf16-rounded
    when ``bf16``), as :func:`lstm_cell` takes it."""
    Uc = bf16_round(U) if bf16 else U.to(torch.float32)
    return lambda x: x @ Uc.T


def lstm_cell(g_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              rec_u: Callable, drop: torch.Tensor, actf: Callable, qbits: int,
              bf16: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step: ``rec_u(q(h))`` gives the recurrent pre-activations
    (B, 4H), ``q`` the per-step quantizer (scale max|h| over (B, H))
    with a straight-through gradient, ``q(h)`` rounded to bf16 first
    when ``bf16``. -> (h, c, the post-activation gates (f, i, o,
    act(c~)) as (B, 4H))."""
    H = h.shape[-1]
    hin = ste_quantize_input(h, qbits) if qbits > 0 else h
    if bf16:
        hin = bf16_round(hin)
    g = g_t + rec_u(hin)
    a = torch.cat([torch.sigmoid(g[:, :3 * H]), actf(g[:, 3 * H:])], dim=1)
    c = a[:, H:2 * H] * a[:, 3 * H:] * drop + a[:, :H] * c
    return a[:, 2 * H:3 * H] * actf(c), c, a


def _fwd_loop(gates, rec_u, drop, h0, c0, act, qbits, bf16, stash):
    """The forward twins' Python loop over t."""
    T, B, G4 = gates.shape
    H = G4 // 4
    z = gates.new_zeros((B, H))
    h = z if h0 is None else h0
    c = z if c0 is None else c0
    hs, cs, acts = [], [], []
    for t in range(T):
        h, c, a = lstm_cell(gates[t], h, c, rec_u, drop, ACTS[act], qbits,
                            bf16)
        hs.append(h)
        cs.append(c)
        acts.append(a)
    out = (torch.stack(hs), torch.stack(cs))
    return out + (torch.stack(acts),) if stash else out


def fused_lstm_fwd_plain(gates: torch.Tensor, U: torch.Tensor,
                         drop: torch.Tensor, h0: Optional[torch.Tensor],
                         c0: Optional[torch.Tensor], act: str, qbits: int,
                         bf16: bool, stash: bool = False):
    """The forward kernel's plain twin: a Python loop over t.
    -> ``(hs, cs)``, plus ``acts`` (T, B, 4H), the post-activation gates
    (f, i, o, act(c~)), when ``stash``."""
    return _fwd_loop(gates, dense_u(U, bf16), drop, h0, c0, act, qbits, bf16,
                     stash)


def _dgates(dh, dc, gf, gi, go, gc, ac, c_prev, drop, dact_c, dact_gc):
    """The elementwise cotangent chain of one step (JAX ``_build_bwd``
    :273-279 / ``_build_bwd_stash`` :390-396). -> (dg (B, 4H), dc)."""
    dc = dc + dh * go * dact_c
    dgo = dh * ac * go * (1.0 - go)
    dgf = dc * c_prev * gf * (1.0 - gf)
    dgi = dc * gc * drop * gi * (1.0 - gi)
    dgc = dc * gi * drop * dact_gc
    return torch.cat([dgf, dgi, dgo, dgc], dim=1), dc


def _bwd_loop(step, carry, dhs, dhT, dcT, like):
    """Reverse-time loop shared by the BPTT twins: ``step(t, dh, dc)``
    gives (dg_t, dc, gf); ``carry(dg_t)`` is dh entering step t-1."""
    T, B, H = dhs.shape
    with_init = dhT is not None
    dh = dhT if with_init else like.new_zeros((B, H))
    dc = dcT if with_init else like.new_zeros((B, H))
    dg = like.new_empty((T, B, 4 * H))
    for t in range(T - 1, -1, -1):
        d, dc_t, gf = step(t, dh + dhs[t], dc)
        dg[t] = d
        dc = dc_t * gf
        if t or with_init:
            dh = carry(d)
    return (dg, dh, dc) if with_init else dg


def _stash_step(acts, drop, cs, c_prev, act):
    """One reverse step over the stashed activations (``dact`` from the
    activation output)."""
    H = acts.shape[2] // 4
    actf, dactf = ACTS[act], DACTS_OUT[act]

    def step(t, dh, dc):
        gf, gi, go, gc = acts[t].split(H, dim=1)
        ac = actf(cs[t])
        d, dc = _dgates(dh, dc, gf, gi, go, gc, ac, c_prev[t], drop,
                        dactf(ac), dactf(gc))
        return d, dc, gf
    return step


def _recompute_step(gates, rec_u, drop, h_prev, c_prev, act, qbits, bf16):
    """One reverse step rebuilding u = rec_u(q(h_{t-1})) and the gates
    (``dact`` from the pre-activation)."""
    H = gates.shape[2] // 4
    actf = ACTS[act]

    def step(t, dh, dc):
        hq = quantize_input(h_prev[t], qbits) if qbits > 0 else h_prev[t]
        if bf16:
            hq = bf16_round(hq)
        g = gates[t] + rec_u(hq)
        gf = torch.sigmoid(g[:, :H])
        gi = torch.sigmoid(g[:, H:2 * H])
        go = torch.sigmoid(g[:, 2 * H:3 * H])
        gc_pre = g[:, 3 * H:]
        gc = actf(gc_pre)
        c = gi * gc * drop + gf * c_prev[t]
        d, dc = _dgates(dh, dc, gf, gi, go, gc, actf(c), c_prev[t], drop,
                        dact_pre(act, c), dact_pre(act, gc_pre))
        return d, dc, gf
    return step


def _dense_carry(U, bf16):
    Uc = bf16_round(U) if bf16 else U.to(torch.float32)
    return lambda d: (bf16_round(d) if bf16 else d) @ Uc


def fused_lstm_bwd_stash_plain(acts: torch.Tensor, U: torch.Tensor,
                               drop: torch.Tensor, cs: torch.Tensor,
                               c_prev: torch.Tensor, dhs: torch.Tensor,
                               dhT: Optional[torch.Tensor] = None,
                               dcT: Optional[torch.Tensor] = None,
                               act: str = "tanh", bf16: bool = False):
    """Twin of the stash BPTT kernel: reverse loop over the forward's
    post-activation gates ``acts``; ``dact`` from the activation output.
    -> dg (T, B, 4H), and ``(dg, dh0, dc0)`` when seeded with
    ``dhT``/``dcT``."""
    return _bwd_loop(_stash_step(acts, drop, cs, c_prev, act),
                     _dense_carry(U, bf16), dhs, dhT, dcT, acts)


def fused_lstm_bwd_plain(gates: torch.Tensor, U: torch.Tensor,
                         drop: torch.Tensor, h_prev: torch.Tensor,
                         c_prev: torch.Tensor, dhs: torch.Tensor,
                         dhT: Optional[torch.Tensor] = None,
                         dcT: Optional[torch.Tensor] = None,
                         act: str = "tanh", qbits: int = 0,
                         bf16: bool = False):
    """Twin of the recompute BPTT kernel: per step it rebuilds
    u = q(h_{t-1}) @ U.T and the gates, ``dact`` from the
    pre-activation. -> as :func:`fused_lstm_bwd_stash_plain`."""
    step = _recompute_step(gates, dense_u(U, bf16), drop, h_prev, c_prev,
                           act, qbits, bf16)
    return _bwd_loop(step, _dense_carry(U, bf16), dhs, dhT, dcT, gates)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_kernel(gates, U, drop, h0, c0, act, qbits, bf16, stash):
    from . import _build
    lib = _build.load("fused_lstm_fwd")
    fn = lib.fused_lstm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, G4 = gates.shape
    H = G4 // 4
    Uk = U.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    hs = torch.empty((T, B, H), dtype=torch.float32, device=gates.device)
    cs = torch.empty_like(hs)
    acts = torch.empty_like(gates) if stash else None
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=gates.device)
    with torch.cuda.device(gates.device):
        rc = fn(gates.data_ptr(), Uk.data_ptr(), drop.data_ptr(), _ptr(h0),
                _ptr(c0), hs.data_ptr(), cs.data_ptr(), _ptr(acts),
                qslots.data_ptr(), T, B, H, _ACT_CODE[act], qbits, int(bf16),
                _stream(gates.device))
    _build.check(lib, rc, "fused_lstm_fwd")
    fused_lstm_fwd.launches += T
    return (hs, cs, acts) if stash else (hs, cs)


def _check_common(name, lead, U, drop, act, others, u_name="U",
                  u_shape=None, gates=4):
    """Shared validation: (T, B, gates*H) float32 ``lead``, the
    recurrent weight ``U`` of shape ``u_shape`` (default (gates*H, H)),
    one device, contiguous float32 sequences. -> (T, B, H, drop as
    (B, H))."""
    if act not in ACTS:
        raise ValueError("fused recurrence activation %r not in %s"
                         % (act, sorted(ACTS)))
    if lead.ndim != 3 or lead.shape[2] % gates:
        raise ValueError("%s must be (T, B, %dH), got %s"
                         % (name, gates, tuple(lead.shape)))
    T, B, G = lead.shape
    H = G // gates
    u_shape = (G, H) if u_shape is None else u_shape
    if tuple(U.shape) != u_shape:
        raise ValueError("%s must be %s, got %s" % (u_name, u_shape,
                                                    tuple(U.shape)))
    dev = lead.device
    for n, t in ((u_name, U), ("drop", drop)) + tuple(others):
        if t is not None and t.device != dev:
            raise ValueError("%s on %s, %s on %s" % (n, t.device, name, dev))
    for n, t in ((name, lead),) + tuple(others):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, got %s" % (n, t.dtype))
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError("%s must be contiguous" % n)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    drop = torch.broadcast_to(drop.to(torch.float32), (B, H)).contiguous()
    return T, B, H, drop


def _check_shapes(shapes):
    for n, t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError("%s must be %s, got %s"
                             % (n, shape, tuple(t.shape)))


def fused_lstm_fwd(gates: torch.Tensor, U: torch.Tensor,
                   drop: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None, act: str = "tanh",
                   qbits: int = 0, bf16: bool = False, stash: bool = False):
    """Whole-layer LSTM forward. ``gates`` (T, B, 4H) float32, ``U``
    (4H, H), ``drop`` broadcastable to (B, H), optional seed carry
    ``h0``/``c0`` (B, H) float32 (both or neither). -> ``(hs, cs)``,
    each (T, B, H) float32, and the stashed post-activation gates
    ``acts`` (T, B, 4H) when ``stash``.

    CUDA tensors run the kernels on the route :func:`lstm_fwd_route`
    picks before the launch: "persist" (all steps in one cooperative
    launch, seeded or not) where the blocks fit and are co-resident, else
    "step" (a launch per step); both give the same bits. CPU tensors run
    the plain twin. This is the raw kernel call, with no autograd:
    differentiable callers use :func:`lstm_scan_fused` /
    :func:`lstm_scan_fused_seeded`."""
    if (h0 is None) != (c0 is None):
        raise ValueError("h0 and c0 go together")
    T, B, H, drop = _check_common("gates", gates, U, drop, act,
                                  (("h0", h0), ("c0", c0)))
    _check_shapes((("h0", h0, (B, H)), ("c0", c0, (B, H))))
    check_dense_width("lstm", H, None, gates.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (gates, U, h0, c0)):
        raise RuntimeError("fused_lstm_fwd has no autograd of its own: call "
                           "lstm_scan_fused / lstm_scan_fused_seeded, which "
                           "carry the BPTT kernels")
    if gates.device.type == "cpu":
        return fused_lstm_fwd_plain(gates, U, drop, h0, c0, act, qbits, bf16,
                                    stash)
    route, plan = lstm_fwd_route(B, H, bf16, gates.device)
    if route == "persist":
        return _fwd_persist(plan, gates, U, drop, h0, c0, act, qbits, bf16,
                            stash)
    return _fwd_kernel(gates, U, drop, h0, c0, act, qbits, bf16, stash)


fused_lstm_fwd.launches = 0


def _fwd_persist(plan, gates, U, drop, h0, c0, act, qbits, bf16, stash):
    """The forward on the persistent route (``plan``: its PersistPlan,
    :func:`lstm_fwd_plan`): all T steps in one cooperative launch, h_t
    exchanged through two zeroed (B, :func:`lstm_fwd_exchange_row`)
    buffers picked by the step's parity, a seed's quantizer scale taken
    inside the launch."""
    from . import block_sparse as BS
    T, B, G4 = gates.shape
    H, dev = G4 // 4, gates.device
    f32 = dict(dtype=torch.float32, device=dev)
    Uk = U.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    hs = torch.empty((T, B, H), **f32)
    cs = torch.empty_like(hs)
    acts = torch.empty_like(gates) if stash else None
    xh = torch.zeros((2, B, lstm_fwd_exchange_row(H, plan.units)), **f32)
    # each block's max|h| of the last two steps, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    BS._launch("fused_lstm_fwd", "lstm_fwd_persist_run", dev,
               (gates.data_ptr(), Uk.data_ptr(), drop.data_ptr(), _ptr(h0),
                _ptr(c0), hs.data_ptr(), cs.data_ptr(), _ptr(acts),
                xh.data_ptr(), bmax.data_ptr()),
               (T, B, H, _ACT_CODE[act], qbits, int(bf16), plan.grid,
                plan.bi, plan.units, plan.smem))
    fused_lstm_fwd.launches += lstm_fwd_launches("persist", T)
    return (hs, cs, acts) if stash else (hs, cs)


def _bwd_kernel(wrapper, lead, U, drop, h_prev, cs, c_prev, dhs, dhT, dcT,
                act, qbits, bf16, stash):
    from . import _build
    lib = _build.load("fused_lstm_bwd")
    fn = lib.fused_lstm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, G4 = lead.shape
    H = G4 // 4
    dev = lead.device
    Uk = U.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    Ut = Uk.t().contiguous()                 # (H, 4H): rows for dg @ U
    with_init = dhT is not None
    dg = torch.empty_like(lead)
    dc = (dcT.clone() if with_init
          else torch.zeros((B, H), dtype=torch.float32, device=dev))
    dh0 = torch.empty_like(dc) if with_init else None
    qslots = torch.empty(T if (qbits > 0 and not stash) else 1,
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(lead.data_ptr(), Uk.data_ptr(), Ut.data_ptr(),
                drop.data_ptr(), _ptr(h_prev), _ptr(cs), c_prev.data_ptr(),
                dhs.data_ptr(), _ptr(dhT), dc.data_ptr(), dg.data_ptr(),
                _ptr(dh0), qslots.data_ptr(), T, B, H, _ACT_CODE[act], qbits,
                int(stash), int(bf16), _stream(dev))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += T + (1 if with_init else 0)
    return (dg, dh0, dc) if with_init else dg


def _bwd_stash_persist(plan, acts, U, drop, cs, c_prev, dhs, dhT, dcT, act,
                       bf16):
    """The stash BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`lstm_bwd_stash_plan`): the whole reverse chain in
    one cooperative launch, dh0 behind one more barrier when seeded.
    -> as :func:`fused_lstm_bwd_stash`."""
    from . import block_sparse as BS
    T, B, G4 = acts.shape
    H, dev = G4 // 4, acts.device
    Uk = U.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
    with_init = dhT is not None
    dg = torch.empty_like(acts)
    dc = (dcT.clone() if with_init
          else torch.zeros((B, H), dtype=torch.float32, device=dev))
    dh0 = torch.empty_like(dc) if with_init else None
    BS._launch("fused_lstm_bwd", "lstm_bwd_stash_persist_run", dev,
               (acts.data_ptr(), Uk.data_ptr(), drop.data_ptr(),
                cs.data_ptr(), c_prev.data_ptr(), dhs.data_ptr(), _ptr(dhT),
                dc.data_ptr(), dg.data_ptr(), _ptr(dh0)),
               (T, B, H, _ACT_CODE[act], int(bf16), plan.grid, plan.bi,
                plan.units, plan.slab, plan.smem))
    fused_lstm_bwd_stash.launches += lstm_bwd_stash_launches("persist", T,
                                                             with_init)
    return (dg, dh0, dc) if with_init else dg


def _check_bwd(name, lead, U, drop, act, seqs, dhT, dcT, backward):
    if (dhT is None) != (dcT is None):
        raise ValueError("dhT and dcT go together")
    T, B, H, drop = _check_common(name, lead, U, drop, act,
                                  tuple(seqs) + (("dhT", dhT), ("dcT", dcT)))
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs]
                  + [("dhT", dhT, (B, H)), ("dcT", dcT, (B, H))])
    check_dense_width("lstm", H, backward, lead.device)
    return drop


def fused_lstm_bwd_stash(acts: torch.Tensor, U: torch.Tensor,
                         drop: torch.Tensor, cs: torch.Tensor,
                         c_prev: torch.Tensor, dhs: torch.Tensor,
                         dhT: Optional[torch.Tensor] = None,
                         dcT: Optional[torch.Tensor] = None,
                         act: str = "tanh", bf16: bool = False):
    """BPTT over the stashed activations (TPU kernel ``_build_bwd_stash``):
    ``acts`` (T, B, 4H) from the stash forward, ``cs`` and ``c_prev``
    (T, B, H), upstream ``dhs`` (T, B, H), optional final-state
    cotangents ``dhT``/``dcT`` (B, H). -> dg (T, B, 4H), and
    ``(dg, dh0, dc0)`` when seeded. CUDA tensors run the kernels on the
    route :func:`lstm_bwd_stash_route` picks before the launch, CPU
    tensors the twin."""
    drop = _check_bwd("acts", acts, U, drop, act,
                      (("cs", cs), ("c_prev", c_prev), ("dhs", dhs)), dhT, dcT,
                      "stash")
    if acts.device.type == "cpu":
        return fused_lstm_bwd_stash_plain(acts, U, drop, cs, c_prev, dhs,
                                          dhT, dcT, act, bf16)
    T, B, G4 = acts.shape
    route, plan = lstm_bwd_stash_route(B, G4 // 4, bf16, acts.device)
    if route == "persist":
        return _bwd_stash_persist(plan, acts, U, drop, cs, c_prev, dhs, dhT,
                                  dcT, act, bf16)
    return _bwd_kernel(fused_lstm_bwd_stash, acts, U, drop, None, cs, c_prev,
                       dhs, dhT, dcT, act, 0, bf16, True)


fused_lstm_bwd_stash.launches = 0


def fused_lstm_bwd(gates: torch.Tensor, U: torch.Tensor, drop: torch.Tensor,
                   h_prev: torch.Tensor, c_prev: torch.Tensor,
                   dhs: torch.Tensor, dhT: Optional[torch.Tensor] = None,
                   dcT: Optional[torch.Tensor] = None, act: str = "tanh",
                   qbits: int = 0, bf16: bool = False):
    """BPTT with recompute (TPU kernel ``_build_bwd``): ``gates`` are the
    forward's inputs, ``h_prev``/``c_prev`` (T, B, H) the carries
    entering each step. -> as :func:`fused_lstm_bwd_stash`."""
    drop = _check_bwd("gates", gates, U, drop, act,
                      (("h_prev", h_prev), ("c_prev", c_prev), ("dhs", dhs)),
                      dhT, dcT, "recompute")
    if gates.device.type == "cpu":
        return fused_lstm_bwd_plain(gates, U, drop, h_prev, c_prev, dhs, dhT,
                                    dcT, act, qbits, bf16)
    return _bwd_kernel(fused_lstm_bwd, gates, U, drop, h_prev, None, c_prev,
                       dhs, dhT, dcT, act, qbits, bf16, False)


fused_lstm_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedLSTM(torch.autograd.Function):
    """The JAX package's ``lstm_scan_fused`` / ``lstm_scan_fused_seeded``
    custom VJPs. Zero carry -> hs; seeded -> (hs, h_T, c_T)."""

    @staticmethod
    def forward(ctx, gates, U, drop, h0, c0, act, qbits, bf16):
        stash = bwd_stash_enabled("lstm")
        seeded = h0 is not None
        out = fused_lstm_fwd(gates, U, drop, h0, c0, act, qbits, bf16, stash)
        hs, cs = out[0], out[1]
        ctx.meta = (act, qbits, bf16, stash, seeded)
        ctx.save_for_backward(gates if not stash else None, U, drop, h0, c0,
                              hs, cs, out[2] if stash else None)
        ctx.set_materialize_grads(False)
        if not seeded:
            return hs
        return hs, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dhs, dhT=None, dcT=None):
        act, qbits, bf16, stash, seeded = ctx.meta
        gates, U, drop, h0, c0, hs, cs, acts = ctx.saved_tensors
        T, B, H = hs.shape
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        zero = hs.new_zeros((1, B, H))
        h_prev = torch.cat([h0[None] if seeded else zero, hs[:-1]])
        c_prev = torch.cat([c0[None] if seeded else zero, cs[:-1]])
        if seeded:
            dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
            dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        if stash:
            out = fused_lstm_bwd_stash(acts, U, drop, cs, c_prev, dhs, dhT,
                                       dcT, act, bf16)
        else:
            out = fused_lstm_bwd(gates, U, drop, h_prev, c_prev, dhs, dhT,
                                 dcT, act, qbits, bf16)
        dg, dh0, dc0 = out if seeded else (out, None, None)
        dU = None
        if ctx.needs_input_grad[1]:
            # one K=T*B product over the unrolled batch, h quantized per step
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dgf, hqf = dg.reshape(T * B, 4 * H), hq.reshape(T * B, H)
            if bf16:
                dgf, hqf = bf16_round(dgf), bf16_round(hqf)
            dU = dgf.T @ hqf
        return dg, dU, None, dh0, dc0, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _is_bf16(compute_dtype: str) -> bool:
    return compute_dtype in ("bf16", "bfloat16")


def lstm_scan_fused(gates_t: torch.Tensor, U: torch.Tensor,
                    drop_mask: torch.Tensor, act: str = "tanh",
                    quant_bits: int = 0, compute_dtype: str = ""
                    ) -> torch.Tensor:
    """hs (T, B, H) from zero initial state, differentiable in
    ``gates_t`` and ``U`` (``drop_mask`` is a constant)."""
    bf16 = _is_bf16(compute_dtype)
    if _needs_grad(gates_t, U):
        return _FusedLSTM.apply(gates_t, U, drop_mask, None, None, act,
                                quant_bits, bf16)
    return fused_lstm_fwd(gates_t, U, drop_mask, act=act, qbits=quant_bits,
                          bf16=bf16)[0]


def lstm_scan_fused_seeded(gates_t: torch.Tensor, U: torch.Tensor,
                           drop_mask: torch.Tensor, h0: torch.Tensor,
                           c0: torch.Tensor, act: str = "tanh",
                           quant_bits: int = 0, compute_dtype: str = ""):
    """Seeded carry: -> ``(hs, (h_T, c_T))``, differentiable in
    ``gates_t``, ``U``, ``h0`` and ``c0``. Without gradients it is the
    streaming forward."""
    bf16 = _is_bf16(compute_dtype)
    if _needs_grad(gates_t, U, h0, c0):
        hs, hT, cT = _FusedLSTM.apply(gates_t, U, drop_mask, h0, c0, act,
                                      quant_bits, bf16)
        return hs, (hT, cT)
    hs, cs = fused_lstm_fwd(gates_t, U, drop_mask, h0, c0, act=act,
                            qbits=quant_bits, bf16=bf16)
    return hs, (hs[-1], cs[-1])


#: The streaming name the serving path uses.
lstm_scan_fused_stream = lstm_scan_fused_seeded


# ---------------------------------------------------------------------------
# block-sparse recurrence: the four per-gate (H, H) recurrent matrices
# share one HCGS mask, so their kept bs x bs blocks pack into the w3
# layout w3g (Nb, 4*bs, R*bs) (``ops.block_sparse``); each step touches
# only those blocks. dU comes from the block-sparse dw kernel over the
# unrolled (T*B) batch.
# ---------------------------------------------------------------------------

def sparse_recurrent_u(h: torch.Tensor, w3g: torch.Tensor, layout,
                       G: int = 4) -> torch.Tensor:
    """u = h @ U_stacked.T over kept blocks only: gather the R kept
    bs-column slices of h per out-block, one batched matmul against
    w3g, back to the dense gate-major (B, G*H) layout (block j of gate g
    at g*H + j*bs)."""
    B, bs, Nb = h.shape[0], layout.bs, layout.Nb
    part = torch.bmm(gather_cols(h, layout), w3g.transpose(1, 2))
    return part.reshape(Nb, B, G, bs).permute(1, 2, 0, 3).reshape(B, -1)


def sparse_dh_parts(dg: torch.Tensor, w3g: torch.Tensor, layout,
                    G: int = 4) -> torch.Tensor:
    """The d(h_prev) contribution of each kept block: dg gathered per
    out-block (Nb, B, G*bs), batched matmul with w3g -> (Nb, B, R*bs)."""
    B, bs, Nb = dg.shape[0], layout.bs, layout.Nb
    dgb = dg.reshape(B, G, Nb, bs).permute(2, 0, 1, 3).reshape(Nb, B, G * bs)
    return torch.bmm(dgb, w3g)


def sparse_dh(dg: torch.Tensor, w3g: torch.Tensor, layout,
              G: int = 4) -> torch.Tensor:
    """dh_prev (B, H): :func:`sparse_dh_parts` added into the columns of
    their kept blocks (the JAX package's ``scatter_add_cols``)."""
    B, bs, R = dg.shape[0], layout.bs, layout.R
    parts = sparse_dh_parts(dg, w3g, layout, G)            # (Nb, B, R*bs)
    parts = parts.reshape(layout.Nb, B, R, bs).transpose(0, 1) \
        .reshape(B, layout.nnz, bs)
    idx = torch.as_tensor(layout.col_idx, dtype=torch.long, device=dg.device)
    dh = dg.new_zeros((B, layout.Kb, bs)).index_add_(1, idx, parts)
    return dh.reshape(B, layout.K)


def _sparse_fns(w3g, layout, bf16):
    """(rec_u, carry) of the sparse twins; w3g bf16-rounded and dg
    rounded before the carry dot when ``bf16``."""
    wc = bf16_round(w3g) if bf16 else w3g

    def carry(d):
        return sparse_dh(bf16_round(d) if bf16 else d, wc, layout)
    return (lambda x: sparse_recurrent_u(x, wc, layout)), carry


def fused_lstm_fwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                                drop: torch.Tensor, layout, act: str = "tanh",
                                qbits: int = 0, bf16: bool = False,
                                stash: bool = False):
    """Twin of the sparse forward kernel (zero initial state).
    -> ``(hs, cs)`` (+ ``acts`` when ``stash``)."""
    rec_u, _ = _sparse_fns(w3g, layout, bf16)
    return _fwd_loop(gates, rec_u, drop, None, None, act, qbits, bf16, stash)


def fused_lstm_bwd_sparse_stash_plain(acts: torch.Tensor, w3g: torch.Tensor,
                                      drop: torch.Tensor, cs: torch.Tensor,
                                      c_prev: torch.Tensor, dhs: torch.Tensor,
                                      layout, act: str = "tanh",
                                      bf16: bool = False) -> torch.Tensor:
    """Twin of the sparse stash BPTT kernel. -> dg (T, B, 4H)."""
    _, carry = _sparse_fns(w3g, layout, bf16)
    return _bwd_loop(_stash_step(acts, drop, cs, c_prev, act), carry, dhs,
                     None, None, acts)


def fused_lstm_bwd_sparse_plain(gates: torch.Tensor, w3g: torch.Tensor,
                                drop: torch.Tensor, h_prev: torch.Tensor,
                                c_prev: torch.Tensor, dhs: torch.Tensor,
                                layout, act: str = "tanh", qbits: int = 0,
                                bf16: bool = False) -> torch.Tensor:
    """Twin of the sparse recompute BPTT kernel. -> dg (T, B, 4H)."""
    rec_u, carry = _sparse_fns(w3g, layout, bf16)
    step = _recompute_step(gates, rec_u, drop, h_prev, c_prev, act, qbits,
                           bf16)
    return _bwd_loop(step, carry, dhs, None, None, gates)


#: Shared memory a block may use on sm_90 (bytes, dynamic and static
#: together), and the sparse backward's static part (dhsm, usm, the entry
#: lists).
_SMEM_MAX, _SPARSE_BWD_STATIC = 232448, 8 * 8 * 4 + 8 * 32 * 4 + 2 * 64 * 4

#: An sm_90 SM's shared memory, and what the runtime keeps of it for each
#: resident block (bytes)
_SMEM_SM, _SMEM_RESERVED = 233472, 1024

#: The dense fused kernels' shared memory per block as (bytes per unit of
#: the width H, static bytes), by cell: the forward's and each backward's
#: largest kernel ("stash", "recompute"; the recompute one also runs the
#: forward's). Each block stages 8 batch rows of q(h) (the forwards), of
#: dg_{t+1} (the backwards) and, in the LSTM's and the liGRU's recompute
#: backward, of q(h) too (csrc/*.cu). The torch-semantics GRU's BPTT runs
#: its persistent chain up to a width whose block fits and whose grid is
#: co-resident (fused_rnn.gru_torch_bwd_route: 1,056 at B <= 8 on 132
#: SMs) and its per-step kernel past it, so the limit here is the
#: per-step kernel's: the kernel that runs at that width.
_DENSE_SMEM = {
    "lstm": {"fwd": (32, 512), "stash": (128, 1280), "recompute": (160, 1280)},
    "ligru": {"fwd": (32, 512), "stash": (64, 768), "recompute": (96, 768)},
    "gru": {"fwd": (32, 256), "stash": (64, 256), "recompute": (64, 256)},
    "mgru": {"fwd": (32, 256), "stash": (32, 256), "recompute": (32, 256)},
    "rnn": {"fwd": (32, 256), "stash": (32, 256), "recompute": (32, 256)},
    "gru_torch": {"fwd": (32, 384), "recompute": (96, 256)},
}


def dense_max_width(cell: str, backward: Optional[str] = None) -> int:
    """The widest layer (H) whose staged rows fit a block's shared memory
    in the cell's dense forward kernel and, with ``backward`` ("stash" or
    "recompute"), in that BPTT kernel too."""
    kinds = ("fwd",) + ((backward,) if backward else ())
    return min((_SMEM_MAX - static) // per
               for per, static in (_DENSE_SMEM[cell][k] for k in kinds))


def check_dense_width(cell: str, H: int, backward: Optional[str],
                      dev: torch.device) -> None:
    """On the card, raise a ValueError that names the limit when a dense
    kernel (:func:`dense_max_width`) cannot take the width H."""
    limit = dense_max_width(cell, backward)
    if dev.type == "cuda" and H > limit:
        raise ValueError("the dense %s kernels%s take H <= %d, got %d"
                         % (cell, " (%s backward)" % backward
                            if backward else "", limit, H))


def grad_backward(cell: str, grad: bool) -> Optional[str]:
    """The backward a differentiable call of the cell's dense kernels
    runs ("stash" or "recompute"; the torch-semantics GRU has only the
    latter), None without gradients."""
    if not grad:
        return None
    stash = "stash" in _DENSE_SMEM[cell] and bwd_stash_enabled(cell)
    return "stash" if stash else "recompute"


# ---------------------------------------------------------------------------
# the dense forward's and the stash BPTT's persistent routes
# (csrc/persist.cuh): the plan and the route, picked before the launch,
# on fused_rnn's PersistPlan and route helpers
# ---------------------------------------------------------------------------

#: the block shapes (bi, units) that csrc/fused_lstm_fwd.cu's persistent
#: forward and csrc/fused_lstm_bwd.cu's persistent chain instantiate: 4 or
#: 8 units and 8 or 16 rows
LSTM_FWD_SHAPES = ((1, 4), (1, 8), (2, 4), (2, 8))
LSTM_BWD_SHAPES = ((1, 4), (1, 8), (2, 4), (2, 8))

#: the H100's SMs, which the plans fill (the route's occupancy query
#: decides whether a grid is co-resident on the card at hand)
_SMS = 132


def _lstm_shape(B: int, H: int) -> tuple:
    """(bi, units) of the stash BPTT's persistent chain at batch B and
    width H: 8 units and 8 (B <= 8) or 16 rows; where that grid would fill
    at most half the SMs, half the outputs a block (8 rows at 16, else 4
    units at 8), so that the grid spreads over them all (the flagship's
    H=512: 128 blocks, not 64)."""
    bi, un = (1, 8) if B <= 8 else (2, 8)
    if -(-H // un) * -(-B // (8 * bi)) <= _SMS // 2:
        bi, un = (1, 8) if bi == 2 else (1, 4)
    return bi, un


def _lstm_fwd_shape(B: int, H: int) -> tuple:
    """(bi, units) of the persistent forward at batch B and width H: 4
    units x 8 rows where that grid fits two blocks an SM (a 4-unit block
    keeps to 128 registers a thread), else :func:`_lstm_shape`'s. Two
    blocks, 16 warps, an SM run the dots faster than one block of twice
    the outputs: the flagship train shape 1.56 ms a call against 1.96 at
    8 units x 8 rows, 2x1024 at 8 rows 2.23 against 2.87 (``chip_smoke.py
    --rnn-times``, NVIDIA H100 80GB HBM3 at 700 W)."""
    if -(-H // 4) * -(-B // 8) <= 2 * _SMS:
        return 1, 4
    return _lstm_shape(B, H)


def lane_row(H: int) -> int:
    """Floats in a row of H values in persist.cuh's lane-major layout
    (``lane_dots``): 32 lanes' segments of ``lane_stride(H)`` floats, the
    ceil(H / 32) values a lane sums rounded up to an odd number of 4."""
    return 32 * 4 * ((-(-H // 32) + 3) // 4 | 1)


def lstm_fwd_exchange_row(H: int, units: int) -> int:
    """Floats in a row of the persistent forward's exchange buffers (and
    of its resident and staged rows at 8 units): H rounded up to 4 (16
    bytes, for ``cp.async``) at 4 units, whose dots ``resident_dots``
    forms; :func:`lane_row` (H) at 8, whose dots ``lane_dots`` forms."""
    return lane_row(H) if units == 8 else -(-H // 4) * 4


def lstm_fwd_plan(B: int, H: int, shape: Optional[tuple] = None):
    """The dense LSTM forward's persistent chain at batch B and width H
    (``shape`` forces (bi, units), one of :data:`LSTM_FWD_SHAPES`; else
    :func:`_lstm_fwd_shape`): a block owns units (the last group masked
    where they do not divide H) with their rows of the 4 gates resident
    (float32, a bf16 U converted exactly), stages per step q(h_{t-1}): its
    rows of the exchange buffer (``staged``; :func:`lstm_fwd_exchange_row`
    floats each), and keeps one sum a row and gate-unit (4 x units of
    them). At 4 units a row of U is H floats and a staged row
    ``fused_rnn._row_stride(H)`` apart; at 8 both are :func:`lane_row`
    (H) floats (the lane-major layout). -> fused_rnn.PersistPlan."""
    from . import fused_rnn as R
    bi, un = shape or _lstm_fwd_shape(B, H)
    bt, nr, row = 8 * bi, 4 * un, lstm_fwd_exchange_row(H, un)
    resident = 4 * nr * (row if un == 8 else H)
    smem = resident + 4 * bt * (row if un == 8 else R._row_stride(H)) \
        + 4 * bt * nr
    grid = -(-H // un) * -(-B // bt)
    return R.PersistPlan(bi, un, grid, smem, 0, resident,
                         4 * min(bt, B) * row)


def lstm_fwd_route(B: int, H: int, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_lstm_fwd` at batch B and width H on
    the card ``dev``: "persist" where the plan's block fits and its grid
    is co-resident (the occupancy query, ``fused_rnn._route``), else
    "step"."""
    from . import fused_rnn as R
    plan = lstm_fwd_plan(B, H)
    return R._route(plan, "fused_lstm_fwd", "lstm_fwd_occupancy",
                    (int(bf16), plan.bi, plan.units),
                    torch.device(dev)), plan


def lstm_fwd_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_lstm_fwd` call launches on ``route`` (as
    its counter counts them): "persist" the one cooperative launch,
    seeded or not (a seed's scale is taken inside it); "step" one a
    step."""
    return 1 if route == "persist" else T


def lstm_bwd_stash_plan(B: int, H: int, shape: Optional[tuple] = None):
    """The dense LSTM stash BPTT's persistent chain at batch B and width H
    (``shape`` forces (bi, units), one of :data:`LSTM_BWD_SHAPES`; else
    :func:`_lstm_shape`): a block owns its units' 4H-long columns of U
    (float32; a bf16 U converted exactly), stages dg_{t+1} (4H floats a
    row) per step: at once where the rows fit beside the weights and the
    dots' partials, else in the fewest slabs of a multiple of 32 values
    whose two buffers fit (``fused_rnn._slabs``).
    -> fused_rnn.PersistPlan."""
    from . import fused_rnn as R
    bi, un = shape or _lstm_shape(B, H)
    bt, K = 8 * bi, 4 * H
    ws = 4 * K * R._w_stride(un)
    red = 4 * R.PERSIST_WARPS * bt * un
    slab, bufs = R._slabs(-(-K // 8) * 8, bt, ws + red)
    smem = ws + 4 * bufs * bt * R._row_stride(slab) + red
    grid = -(-H // un) * -(-B // bt)
    return R.PersistPlan(bi, un, grid, smem, 0, 4 * K * un,
                         4 * min(bt, B) * K, slab, -(-K // slab))


def lstm_bwd_stash_route(B: int, H: int, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_lstm_bwd_stash` at batch B and width
    H on the card ``dev``, as :func:`lstm_fwd_route`."""
    from . import fused_rnn as R
    plan = lstm_bwd_stash_plan(B, H)
    return R._route(plan, "fused_lstm_bwd", "lstm_bwd_stash_occupancy",
                    (int(bf16), plan.bi, plan.units),
                    torch.device(dev)), plan


def lstm_bwd_stash_launches(route: str, T: int, seeded: bool) -> int:
    """Kernels one :func:`fused_lstm_bwd_stash` call launches on
    ``route``: "persist" the one cooperative launch (dh0 inside it);
    "step" one a reverse step, and the dh0 dot when seeded."""
    return 1 if route == "persist" else T + int(seeded)


#: the block shapes (bi, units) that csrc/fused_lstm_sparse.cu's
#: persistent forward (``PK_LSTM_SPARSE_FWD_SHAPE``) and stash chain
#: (``PK_LSTM_SPARSE_BWD_SHAPE``) instantiate: 4 or 8 units and 8 or 16
#: rows (the chain's plan takes no 4 x 16)
LSTM_FWD_SPARSE_SHAPES = ((1, 4), (1, 8), (2, 4), (2, 8))
LSTM_BWD_SPARSE_SHAPES = ((1, 4), (1, 8), (2, 8))


def _lstm_fwd_sparse_shape(B: int, H: int) -> tuple:
    """(bi, units) of the sparse forward's persistent chain at batch B and
    width H: 4 units and 8 rows, or 16, where two such blocks an SM hold
    the grid (two blocks, 16 warps, an SM, as the dense forward's
    :func:`_lstm_fwd_shape`), else :func:`_lstm_shape`'s. At the CGS-16x
    train shape (16 rows of 1024, tanh, qbits 16) 4 x 16 took 2.20-2.22
    ms a call against 2.28-2.30 at 8 x 16 (``chip_smoke.py --rnn-times``,
    NVIDIA H100 80GB HBM3 at 700 W)."""
    for bi in (1, 2):
        if -(-H // 4) * -(-B // (8 * bi)) <= 2 * _SMS:
            return bi, 4
    return _lstm_shape(B, H)


def lstm_fwd_sparse_plan(B: int, layout, shape: Optional[tuple] = None):
    """The sparse LSTM forward's persistent chain at batch B over
    ``layout`` (``shape`` forces (bi, units), one of
    :data:`LSTM_FWD_SPARSE_SHAPES`; else :func:`_lstm_fwd_sparse_shape`):
    a block owns units of one out-block with their rows of the 4 gates
    resident as rows (R*bs floats each, float32; a bf16 w3g converted
    exactly), stages per step q(h_{t-1}) at the out-block's R kept column
    blocks (rows ``fused_rnn._row_stride`` (R*bs) apart) and keeps one sum
    a row and gate-unit. -> fused_rnn.PersistPlan."""
    from . import fused_rnn as R
    bi, un = shape or _lstm_fwd_sparse_shape(B, layout.N)
    bt, nr, K3 = 8 * bi, 4 * un, layout.R * layout.bs
    resident = 4 * nr * K3
    smem = resident + 4 * bt * R._row_stride(K3) + 4 * bt * nr
    grid = (layout.N // un) * -(-B // bt)
    return R.PersistPlan(bi, un, grid, smem, 0, resident,
                         4 * min(bt, B) * K3)


def lstm_fwd_sparse_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_lstm_fwd_sparse` at batch B over
    ``layout`` on the card ``dev``: "persist" where the plan's block fits
    and its grid is co-resident (the occupancy query,
    ``fused_rnn._route``), else "step"; "step" also where the block's
    units do not divide bs."""
    from . import fused_rnn as R
    plan = lstm_fwd_sparse_plan(B, layout)
    if layout.bs % plan.units:
        return "step", plan
    return R._route(plan, "fused_lstm_sparse", "lstm_fwd_sparse_occupancy",
                    (int(bf16), plan.bi, plan.units),
                    torch.device(dev)), plan


def lstm_fwd_sparse_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_lstm_fwd_sparse` call launches on
    ``route`` (as its counter counts them): "persist" the one cooperative
    launch, "step" one a step."""
    return 1 if route == "persist" else T


def lstm_bwd_sparse_stash_plan(B: int, H: int, bs: int, C: int,
                               shape: Optional[tuple] = None,
                               entry_slabs: bool = False):
    """The sparse LSTM stash BPTT's persistent reverse chain at batch B,
    width H, block size bs and at most C kept blocks in a block column
    (``shape`` forces (bi, units), one of :data:`LSTM_BWD_SPARSE_SHAPES`;
    else 8 units x 8 rows where two such blocks an SM hold the grid and
    fit its shared memory, else :func:`_lstm_shape`'s; at 16 rows of
    1024 two 8 x 8 blocks an SM took 2.50-2.52 ms a call against 3.00 at
    8 x 16 with C = 3, in slabs 3.34 against 3.80 whole at C = 4,
    ``chip_smoke.py --rnn-times``, NVIDIA H100 80GB HBM3 at 700 W): a
    block owns units of one block column with their columns of the 4
    gates' U at each of the column's entries resident as rows (4bs floats
    a unit and an entry, C entries at most), stages dg_{t+1} at the
    entries' out-blocks per reverse step (4bs floats an entry and a row)
    and keeps one sum a row and unit; its static shared memory holds the
    column's entry lists. The staged rows are whole (``slab`` C*4bs values, one buffer)
    where they fit beside the weights, in half an SM's shared memory
    where the grid needs two blocks of 8 rows an SM, else (or where
    ``entry_slabs`` asks) one entry a slab (``slab`` 4bs, C ``slabs`` at
    most) through two buffers. -> fused_rnn.PersistPlan."""
    from . import fused_rnn as R
    static = R._PERSIST_SPARSE_STATIC

    def plan(bi, un):
        bt, GB = 8 * bi, 4 * bs
        KC = C * GB
        resident, sums = 4 * un * KC, 4 * bt * un
        grid = (H // un) * -(-B // bt)
        room = _SMEM_MAX - static
        if bi == 1 and grid > _SMS:     # built for two blocks an SM
            room = _SMEM_SM // 2 - _SMEM_RESERVED - static
        slab, slabs = KC, 1
        smem = resident + 4 * bt * R._row_stride(KC) + sums
        if entry_slabs or smem > room:
            slab, slabs = GB, C
            smem = resident + 2 * 4 * bt * R._row_stride(GB) + sums
        return R.PersistPlan(bi, un, grid, smem, static, resident,
                             4 * min(bt, B) * KC, slab, slabs)
    if shape:
        return plan(*shape)
    if entry_slabs:
        raise ValueError("entry_slabs needs a shape")
    two = plan(1, 8)
    if two.grid <= 2 * _SMS and \
            2 * (two.smem + static + _SMEM_RESERVED) <= _SMEM_SM:
        return two
    return plan(*_lstm_shape(B, H))


def lstm_bwd_sparse_stash_route(B: int, layout, bf16: bool, dev) -> tuple:
    """(route, plan) of :func:`fused_lstm_bwd_sparse_stash` at batch B
    over ``layout`` on the card ``dev``, as :func:`lstm_fwd_sparse_route`;
    "step" also where bs is not a multiple of 8 (the chain's sums are the
    step kernel's where an entry's 4bs values are a multiple of the 32
    lanes) or of the block's units."""
    from . import fused_rnn as R
    plan = lstm_bwd_sparse_stash_plan(B, layout.N, layout.bs, layout.C)
    if layout.bs % 8 or layout.bs % plan.units:
        return "step", plan
    return R._route(plan, "fused_lstm_sparse",
                    "lstm_bwd_sparse_stash_occupancy",
                    (int(bf16), plan.bi, plan.units),
                    torch.device(dev)), plan


def lstm_bwd_sparse_stash_launches(route: str, T: int) -> int:
    """Kernels one :func:`fused_lstm_bwd_sparse_stash` call launches on
    ``route``: "persist" the one cooperative launch, "step" one a reverse
    step."""
    return 1 if route == "persist" else T


def _check_sparse(name, lead, w3g, layout, drop, act, others, gates=4):
    """A sparse recurrence's operands: (T, B, gates*H) ``lead`` with H the
    square layout's width, w3g (Nb, gates*bs, R*bs), and on the card the
    block sizes the kernels take. -> as :func:`_check_common`."""
    if layout.N != layout.K or lead.ndim != 3 or \
            lead.shape[2] != gates * layout.N:
        raise ValueError("%s must be (T, B, %dH) with H = the layout's %d"
                         % (name, gates, layout.N))
    if lead.device.type == "cuda" and (layout.bs % 8 or layout.C > 64):
        raise ValueError("the sparse kernels take bs % 8 == 0 and at most "
                         "64 blocks per column, got bs=%d C=%d"
                         % (layout.bs, layout.C))
    return _check_common(name, lead, w3g, drop, act, others, "w3g",
                         (layout.Nb, gates * layout.bs,
                          layout.R * layout.bs), gates=gates)


def _sparse_w(w3g, bf16):
    return w3g.to(torch.bfloat16 if bf16 else torch.float32).contiguous()


def fused_lstm_fwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                          drop: torch.Tensor, layout, act: str = "tanh",
                          qbits: int = 0, bf16: bool = False,
                          stash: bool = False):
    """Whole-layer LSTM forward from the zero state over the kept blocks
    of U (TPU kernel ``_build_fwd_sparse``): ``gates`` (T, B, 4H)
    float32, ``w3g`` (Nb, 4*bs, R*bs) float32 (cast to bf16 for the
    kernel when ``bf16``), ``drop`` broadcastable to (B, H). -> ``(hs,
    cs)``, and ``acts`` (T, B, 4H) when ``stash``. CUDA tensors run the
    kernels on the route :func:`lstm_fwd_sparse_route` picks before the
    launch: "persist" (all steps in one cooperative launch) where the
    blocks fit and are co-resident, else "step" (a launch per step); both
    give the same bits. CPU tensors run the plain twin; no autograd of
    its own (:func:`lstm_scan_fused_sparse` carries the BPTT kernels)."""
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act, ())
    if _needs_grad(gates, w3g):
        raise RuntimeError("fused_lstm_fwd_sparse has no autograd of its "
                           "own: call lstm_scan_fused_sparse")
    if gates.device.type == "cpu":
        return fused_lstm_fwd_sparse_plain(gates, w3g, drop, layout, act,
                                           qbits, bf16, stash)
    route, plan = lstm_fwd_sparse_route(B, layout, bf16, gates.device)
    if route == "persist":
        return _fwd_sparse_persist(plan, gates, w3g, drop, layout, act,
                                   qbits, bf16, stash)
    return _fwd_sparse_step(gates, w3g, drop, layout, act, qbits, bf16,
                            stash)


def _fwd_sparse_step(gates, w3g, drop, layout, act, qbits, bf16, stash):
    """The sparse forward (checked operands, ``drop`` (B, H)) on the step
    route: a launch a step. -> as :func:`fused_lstm_fwd_sparse`."""
    from . import block_sparse as BS
    T, B, G4 = gates.shape
    H = G4 // 4
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    acts = torch.empty_like(gates) if stash else None
    qslots = torch.empty(T + 1 if qbits > 0 else 1, dtype=torch.int32,
                         device=dev)
    wk = _sparse_w(w3g, bf16)
    BS._launch("fused_lstm_sparse", "fused_lstm_fwd_sparse", dev,
               (gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), cs.data_ptr(), _ptr(acts),
                qslots.data_ptr()),
               (T, B, H, layout.R, layout.bs, _ACT_CODE[act], qbits,
                int(bf16)))
    fused_lstm_fwd_sparse.launches += lstm_fwd_sparse_launches("step", T)
    return (hs, cs, acts) if stash else (hs, cs)


def _fwd_sparse_persist(plan, gates, w3g, drop, layout, act, qbits, bf16,
                        stash):
    """The sparse forward on the persistent route (``plan``: its
    PersistPlan, :func:`lstm_fwd_sparse_plan`): all T steps in one
    cooperative launch. -> as :func:`fused_lstm_fwd_sparse`."""
    from . import block_sparse as BS
    T, B, G4 = gates.shape
    H = G4 // 4
    dev = gates.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(hs)
    acts = torch.empty_like(gates) if stash else None
    # each block's max|h| of the last two steps, for the quantizer
    bmax = torch.empty(2 * plan.grid if qbits > 0 else 1, dtype=torch.int32,
                       device=dev)
    wk = _sparse_w(w3g, bf16)
    BS._launch("fused_lstm_sparse", "lstm_fwd_sparse_persist", dev,
               (gates.data_ptr(), wk.data_ptr(),
                layout.device_index("col_idx", dev).data_ptr(),
                drop.data_ptr(), hs.data_ptr(), cs.data_ptr(), _ptr(acts),
                bmax.data_ptr()),
               (T, B, H, layout.R, layout.bs, _ACT_CODE[act], qbits,
                int(bf16), plan.grid, plan.bi, plan.units, plan.smem))
    fused_lstm_fwd_sparse.launches += lstm_fwd_sparse_launches("persist", T)
    return (hs, cs, acts) if stash else (hs, cs)


fused_lstm_fwd_sparse.launches = 0


def _bwd_sparse_step(wrapper, lead, w3g, drop, h_prev, cs, c_prev, dhs,
                     layout, act, qbits, bf16, stash):
    """A sparse BPTT (checked operands, ``drop`` (B, H)) on the step
    route, counted on ``wrapper``: the stash one (``stash``, ``lead`` the
    stash) or the recompute one (``lead`` the gates): a launch a reverse
    step. -> dg (T, B, 4H)."""
    from . import block_sparse as BS
    T, B, G4 = lead.shape
    H = G4 // 4
    R, bs, C = layout.R, layout.bs, layout.C
    smem = 4 * 8 * (C * 4 * bs + (0 if stash else R * bs))
    if smem + _SPARSE_BWD_STATIC > _SMEM_MAX:
        raise ValueError("%s: %d blocks per column of %d need %d bytes of "
                         "shared memory, more than a block has"
                         % (wrapper.__name__, C, bs, smem))
    dev = lead.device
    wk = _sparse_w(w3g, bf16)
    wt = wk.transpose(1, 2).contiguous()      # (Nb, R*bs, 4bs): carry dots
    dg = torch.empty_like(lead)
    dc = torch.zeros((B, H), dtype=torch.float32, device=dev)
    qslots = torch.empty(T if (qbits > 0 and not stash) else 1,
                         dtype=torch.int32, device=dev)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("col_idx", "t_row_idx", "t_perm")]
    BS._launch("fused_lstm_sparse", "fused_lstm_bwd_sparse", dev,
               (lead.data_ptr(), wk.data_ptr(), wt.data_ptr(), *idx,
                drop.data_ptr(), _ptr(h_prev), _ptr(cs), c_prev.data_ptr(),
                dhs.data_ptr(), dc.data_ptr(), dg.data_ptr(),
                qslots.data_ptr()),
               (T, B, H, R, bs, C, layout.nnz, _ACT_CODE[act], qbits,
                int(stash), int(bf16)))
    wrapper.launches += T
    return dg


def _bwd_sparse_stash_persist(plan, acts, w3g, drop, cs, c_prev, dhs, layout,
                              act, bf16):
    """The sparse stash BPTT on the persistent route (``plan``: its
    PersistPlan, :func:`lstm_bwd_sparse_stash_plan`): the whole reverse
    chain in one cooperative launch, each block's columns of U read from
    w3g itself. -> dg (T, B, 4H)."""
    from . import block_sparse as BS
    T, B, G4 = acts.shape
    dev = acts.device
    dg = torch.empty_like(acts)
    wk = _sparse_w(w3g, bf16)
    idx = [layout.device_index(n, dev).data_ptr()
           for n in ("t_row_idx", "t_perm")]
    BS._launch("fused_lstm_sparse", "lstm_bwd_sparse_stash_persist", dev,
               (acts.data_ptr(), wk.data_ptr(), *idx, drop.data_ptr(),
                cs.data_ptr(), c_prev.data_ptr(), dhs.data_ptr(),
                dg.data_ptr()),
               (T, B, G4 // 4, layout.R, layout.bs, layout.C, layout.nnz,
                _ACT_CODE[act], int(bf16), plan.grid, plan.bi, plan.units,
                plan.slab // (4 * layout.bs), plan.smem))
    fused_lstm_bwd_sparse_stash.launches += lstm_bwd_sparse_stash_launches(
        "persist", T)
    return dg


def fused_lstm_bwd_sparse_stash(acts: torch.Tensor, w3g: torch.Tensor,
                                drop: torch.Tensor, cs: torch.Tensor,
                                c_prev: torch.Tensor, dhs: torch.Tensor,
                                layout, act: str = "tanh",
                                bf16: bool = False) -> torch.Tensor:
    """Sparse BPTT over the stashed activations (TPU kernel
    ``_build_bwd_sparse_stash``): ``acts`` (T, B, 4H) from the stash
    forward, ``cs``, ``c_prev``, ``dhs`` (T, B, H). -> dg (T, B, 4H).
    CUDA tensors run the kernels on the route
    :func:`lstm_bwd_sparse_stash_route` picks before the launch:
    "persist" (the reverse chain in one cooperative launch) where the
    blocks fit and are co-resident, else "step" (a launch per reverse
    step); both give the same bits. CPU tensors run the twin."""
    seqs = (("cs", cs), ("c_prev", c_prev), ("dhs", dhs))
    T, B, H, drop = _check_sparse("acts", acts, w3g, layout, drop, act, seqs)
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs])
    if acts.device.type == "cpu":
        return fused_lstm_bwd_sparse_stash_plain(acts, w3g, drop, cs, c_prev,
                                                 dhs, layout, act, bf16)
    route, plan = lstm_bwd_sparse_stash_route(B, layout, bf16, acts.device)
    if route == "persist":
        return _bwd_sparse_stash_persist(plan, acts, w3g, drop, cs, c_prev,
                                         dhs, layout, act, bf16)
    return _bwd_sparse_step(fused_lstm_bwd_sparse_stash, acts, w3g, drop,
                            None, cs, c_prev, dhs, layout, act, 0, bf16, True)


fused_lstm_bwd_sparse_stash.launches = 0


def fused_lstm_bwd_sparse(gates: torch.Tensor, w3g: torch.Tensor,
                          drop: torch.Tensor, h_prev: torch.Tensor,
                          c_prev: torch.Tensor, dhs: torch.Tensor, layout,
                          act: str = "tanh", qbits: int = 0,
                          bf16: bool = False) -> torch.Tensor:
    """Sparse BPTT with recompute (TPU kernel ``_build_bwd_sparse``):
    ``gates`` are the forward's inputs, ``h_prev``/``c_prev`` (T, B, H)
    the carries entering each step. -> dg (T, B, 4H)."""
    seqs = (("h_prev", h_prev), ("c_prev", c_prev), ("dhs", dhs))
    T, B, H, drop = _check_sparse("gates", gates, w3g, layout, drop, act,
                                  seqs)
    _check_shapes([(n, t, (T, B, H)) for n, t in seqs])
    if gates.device.type == "cpu":
        return fused_lstm_bwd_sparse_plain(gates, w3g, drop, h_prev, c_prev,
                                           dhs, layout, act, qbits, bf16)
    return _bwd_sparse_step(fused_lstm_bwd_sparse, gates, w3g, drop, h_prev,
                            None, c_prev, dhs, layout, act, qbits, bf16,
                            False)


fused_lstm_bwd_sparse.launches = 0


def sparse_dU(dg_m: torch.Tensor, hq_m: torch.Tensor, layout,
              G: int = 4) -> torch.Tensor:
    """dw3g (Nb, G*bs, R*bs) from the gate cotangents over the unrolled
    batch, through the block-sparse dw kernel. dg_m: (M, G*H)
    gate-major; hq_m: (M, H) the (quantized) recurrent inputs."""
    M = dg_m.shape[0]
    dg_flat = dg_m.reshape(M, G, layout.Nb, layout.bs).transpose(1, 2) \
        .reshape(M, -1)
    return block_sparse_dw(dg_flat, hq_m.contiguous(), layout, G)


def sparse_scan_fits(B: int, H: int, layout, G: int = 4) -> str:
    """The JAX package's ``sparse_scan_fits_vmem``: "f32", "bf16" or ""
    from a VMEM budget of ``PKC_SPARSE_SCAN_VMEM_MB`` (default 15) MB
    against the resident w3g and the step's working set.

    Not a fact about this card: it is kept as the JAX package's
    eligibility and weight-dtype rule, so that the same layers take the
    sparse recurrence in both packages ("" keeps a layer dense) and w3g
    is rounded to bf16 in the same cases."""
    work = 10 * B * H * 4 + 3 * B * 4 * H * 4
    budget = int(os.environ.get("PKC_SPARSE_SCAN_VMEM_MB", "15")) * 1024 * 1024
    u_f32 = layout.nnz * G * layout.bs * layout.bs * 4
    if u_f32 + work < budget:
        return "f32"
    if u_f32 // 2 + work < budget:
        return "bf16"
    return ""


class _FusedLSTMSparse(torch.autograd.Function):
    """The JAX package's ``lstm_scan_fused_sparse`` custom VJP: forward
    kernel (stash or not), BPTT kernel, then dw3g through the
    block-sparse dw kernel over the (T*B) batch with h quantized per
    step. Under ``wbf16`` the kernels read w3g in bf16 and dw3g is
    rounded to bf16 (the JAX op's primal is the bf16 w3g)."""

    @staticmethod
    def forward(ctx, gates, w3g, drop, layout, act, qbits, wbf16):
        stash = bwd_stash_enabled("lstm")
        out = fused_lstm_fwd_sparse(gates, w3g, drop, layout, act, qbits,
                                    wbf16, stash)
        hs, cs = out[0], out[1]
        ctx.meta = (layout, act, qbits, wbf16, stash)
        ctx.save_for_backward(gates if not stash else None, w3g, drop, hs,
                              cs, out[2] if stash else None)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        layout, act, qbits, wbf16, stash = ctx.meta
        gates, w3g, drop, hs, cs, acts = ctx.saved_tensors
        T, B, H = hs.shape
        dhs = dhs.contiguous()
        zero = hs.new_zeros((1, B, H))
        h_prev = torch.cat([zero, hs[:-1]])
        c_prev = torch.cat([zero, cs[:-1]])
        if stash:
            dg = fused_lstm_bwd_sparse_stash(acts, w3g, drop, cs, c_prev, dhs,
                                             layout, act, wbf16)
        else:
            dg = fused_lstm_bwd_sparse(gates, w3g, drop, h_prev, c_prev, dhs,
                                       layout, act, qbits, wbf16)
        dw3g = None
        if ctx.needs_input_grad[1]:
            hq = (quantize_input_per_step(h_prev, qbits) if qbits > 0
                  else h_prev)
            dw3g = sparse_dU(dg.reshape(T * B, 4 * H), hq.reshape(T * B, H),
                             layout)
            if wbf16:
                dw3g = bf16_round(dw3g)
        return dg, dw3g, None, None, None, None, None


def lstm_scan_fused_sparse(gates_t: torch.Tensor, w3g: torch.Tensor, layout,
                           drop_mask: torch.Tensor, act: str = "tanh",
                           quant_bits: int = 0) -> torch.Tensor:
    """hs (T, B, H) from the zero state with block-sparse per-gate
    recurrent matrices sharing one HCGS mask, differentiable in
    ``gates_t`` and ``w3g`` (Nb, 4*bs, R*bs) (``drop_mask`` is a
    constant). As in the JAX package it takes no ``compute_dtype``: the
    recurrence runs in float32, with w3g read in bf16 only where
    :func:`sparse_scan_fits` says "bf16"."""
    T, B, G4 = gates_t.shape
    wbf16 = sparse_scan_fits(B, G4 // 4, layout) == "bf16"
    if _needs_grad(gates_t, w3g):
        return _FusedLSTMSparse.apply(gates_t, w3g, drop_mask, layout, act,
                                      quant_bits, wbf16)
    return fused_lstm_fwd_sparse(gates_t, w3g, drop_mask, layout, act,
                                 quant_bits, wbf16)[0]
